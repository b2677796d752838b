// The tensor-core four-step for Hopper (sm_90a), one body for two kernels:
// block_mma_kernel (fft_block.cu, the port of the TPU kernel fft_block) and
// matmul_mma_kernel (fft_matmul.cu, the port of fft_matmul). On the TPU
// those are two MXU formulations of one function; here they are one. The
// planar product F1 a = (F1r ar - F1i ai, F1r ai + F1i ar) of fft_matmul's
// four-step is the block product [[F1r, -F1i], [F1i, F1r]] [ar; ai] that
// this body runs, so both kernels take the same tables
// (core/fft1d.py:block_mma_tables) and separate re/im plane pointers. Each
// pencil n = n1 * n2 (n1 >= n2, powers of two) is viewed as a[d, k1, k2] =
// x_d[k1 * n2 + k2]. The output is in natural order; the inverse takes the
// inverse tables and multiplies by 1/n (`scale`).
//
// Bound: by what an FFT needs, memory (16 bytes per element moved, 0.64 ms
// at 512^3). The dense four-step does 8 n (n1 + n2) flop a pencil, 0.77 ms
// at 512^3 at the 67 TFLOP/s fp32 CUDA-core peak: more than the byte bound,
// so only the tensor cores can bring the kernel to it.
//
// four_step_mma, for 64 <= n <= 1024 (n2 >= 8: the products' K and N are
// multiples of mma's 8). Both dense products run on the tensor cores with
// mma.sync m16n8k8 TF32 in 3xTF32: every operand x is split into
// big = rna(x) and small = rna(x - big), and a product is small*big +
// big*small + big*big (small*small dropped), in that order, each k-step's
// three products in a fresh accumulator that is added to the running sum
// with an fp32 add (the tensor cores truncate when they add C; chained into
// one accumulator the error grows fourfold and is biased toward zero). One
// TF32 pass would be ~3e-4 off. The constant tables come split from the host
// (core/fft1d.py:block_mma_tables) and in the mma fragment order
// (kernels/fft_block.py:frag_a, frag_b), so a lane reads each fragment as one
// float4 or float2; the data is split in registers with cvt.rna's rounding.
// For a tile of P pencils (P n = 4096 floats a plane, 2048 at n = 1024):
//   step 2: B = F1b (2 n1 x 2 n1, rows (c, j1), cols (d, k1)) times the tile
//           (2 n1 x P n2, rows (d, k1), cols (p, k2)). The rows of F1b are
//           ordered so each 16-row m-tile holds 8 j1 of c = 0, then the same
//           8 j1 of c = 1: the real and imaginary part of b[j1, (p, k2)] land
//           in the same thread (accumulators 0/2 and 1/3), and the twiddle
//           W[j1, k2] is applied there, in registers, in fp32.
//   step 3: Y = C (P n1 x 2 n2, rows (p, j1), cols (d, k2)) times the block
//           F2 (2 n2 x 2 n2, [[F2r, F2i], [-F2i, F2r]]), rows (p, j1), cols
//           (e, m): y_e[p n + m n1 + j1].
// Instead of the TPU fft_block's G (the twiddle folded into F2, a different
// 2 n2 x 2 n2 matrix for every j1, 128 KiB at n = 512) step 3 is one
// product whose N is 2 n2, not the P pencils of a tile. Device memory is
// read once and written once. A tile lands in shared memory by cp.async,
// 16 bytes a thread (rows k1 of stride P n2 + 8 = 8 mod 32, so B fragments
// hit 32 banks); C stays in shared memory (row stride 2 n2 + 4 = 4 mod 8, for
// the A fragments); step 3 stores its output straight from the accumulators,
// 8 lanes on 8 consecutive j1 of a row m: whole 32-byte sectors. So the tile
// buffer is free once step 2 has read it, and the next tile's load is in
// flight during step 3 (and the other block's products). Blocks are
// persistent (one per resident slot) and stage the split tables once; at
// n = 512 a block takes 112,640 bytes, two an SM.
//
// four_step_mma3, for n = 2048 and 4096: the two-factor split would take
// 64 x 64 tables (256 KiB split, over a block's 227 KB) and 8 n (64 + 64)
// dense flop an element. This body splits n = 16 * 16 * n3 (n3 = 8, 16),
// viewing a pencil as x[k1, k2, k3], and runs three 3xTF32 products, 384
// flop an element at 4096 (the n = 512 body's): stage 1 F1b (the 16-point
// table of the two-factor body, 8 KiB split) times the (d, k1) rows, then
// W1[j1, k2 n3 + k3] in registers; stage 2 the same table over (d, k2),
// then W2[j2, k3]; stage 3 the rows (j2, j1) times the block F of n3
// points, stored as y[j1 + 16 j2 + 256 j3] in 32-byte sectors as step 3
// does. A tile is one pencil, kept in shared memory between the stages and
// overwritten in place (a warp owns whole columns of stages 1 and 2), in an
// unpadded layout whose XOR swizzle (Mma3Shape::at) keeps every fragment
// access on 32 banks. Two tile buffers: the next pencil's cp.async load runs
// during all three stages. At 4096 a block takes 81,920 bytes, at 2048
// 43,008; two an SM, by the 128 registers (two pencils a tile at 2048
// spilled).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest, ties
// away from zero), in two integer operations: ptxas expands cvt.rna into a
// longer sequence that also handles NaN and infinity.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b on one m16n8k8 tile. With g = lane / 4, t = lane % 4:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k = t,
// n = g), b1 (k = t + 4, n = g); d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
// d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc += a b in 3xTF32: small(a) big(b) + big(a) small(b) + big(a) big(b),
// the small terms first, into a fresh accumulator that is then added to acc
// on the CUDA cores. The tensor cores align and truncate the sum of C and the
// products, so chaining every k-step's products into acc would add one biased
// truncation of acc's size per mma; this way each k-step rounds once, to
// nearest.
__device__ __forceinline__ void add_3xtf32(float (&acc)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, as[0], as[1], as[2], as[3], bb[0], bb[1]);
  mma_tf32(d, ab[0], ab[1], ab[2], ab[3], bs[0], bs[1]);
  mma_tf32(d, ab[0], ab[1], ab[2], ab[3], bb[0], bb[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// A length of the mma body, with the k-steps of step 2 and step 3 unrolled at
// a time (U2_, U3_; 0 for all of them).
template <int N1_, int N2_, int U2_, int U3_>
struct MmaShape {
  static constexpr int N1 = N1_, N2 = N2_, N = N1 * N2;
  static constexpr int TILE = N >= 1024 ? 2048 : 4096;  // floats a plane of a tile
  static constexpr int P = TILE / N;                    // pencils a tile
  static constexpr int PER_WARP = TILE / 64 / kWarps;   // m16n8 output tiles a warp, each step
  // step 2: (2 N1 x 2 N1) times (2 N1 x P N2); a warp owns WM2 x WN2 tiles
  static constexpr int MT2 = N1 / 8, NT2 = P * N2 / 8, KS2 = N1 / 4;
  static constexpr int WM2 = MT2 < 2 ? MT2 : 2, WN2 = PER_WARP / WM2, GN2 = NT2 / WN2;
  // step 3: (P N1 x 2 N2) times (2 N2 x 2 N2); a warp owns WM3 x WN3 tiles
  static constexpr int MT3 = P * N1 / 16, NT3 = N2 / 4, KS3 = N2 / 4;
  static constexpr int WN3 = NT3 < PER_WARP ? NT3 : PER_WARP, WM3 = PER_WARP / WN3;
  static constexpr int GN3 = NT3 / WN3;
  static constexpr int U2 = U2_ ? U2_ : KS2, U3 = U3_ ? U3_ : KS3;
  // shared memory, in floats
  static constexpr int LDX = P * N2 + 8;  // tile row k1, (p, k2) inner: 8 (mod 32)
  static constexpr int LDC = 2 * N2 + 4;  // C row (p, j1), (d, k2) inner: 4 (mod 8)
  static constexpr int XPLANE = N1 * LDX;
  static constexpr int FA = 2 * 4 * N1 * N1;  // F1b big, small: fragment order
  static constexpr int FB = 2 * 4 * N2 * N2;  // F2b big, small: fragment order
  static constexpr int XS = 2 * XPLANE;       // the tile, both planes
  static constexpr int CS = P * N1 * LDC;
  static constexpr int FLOATS = FA + FB + XS + CS;
  // where element q of pencil p, plane d, of a tile lands in X
  static __device__ __forceinline__ int tile_at(int d, int p, int q) {
    return d * XPLANE + (q / N2) * LDX + p * N2 + q % N2;
  }
  static_assert(N2 >= 8 && N1 >= N2, "mma body needs 8 <= n2 <= n1");
  static_assert(MT2 % WM2 == 0 && NT2 % WN2 == 0 && (MT2 / WM2) * GN2 == kWarps, "step 2");
  static_assert(MT3 % WM3 == 0 && NT3 % WN3 == 0 && (MT3 / WM3) * GN3 == kWarps, "step 3");
  static_assert(LDX % 32 == 8 && LDC % 8 == 4, "bank padding");
  static_assert(KS2 % U2 == 0 && KS3 % U3 == 0, "whole unrolled rounds");
};

// 16 bytes from device memory into shared memory without a register, or 16
// zero bytes where !valid (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of a tile's two planes into X (at S::tile_at); pencils past
// `rows` are zeros. With 16-byte aligned planes (vec) the copy is cp.async and
// lands while the caller computes; else it is done here, 4 bytes at a time.
template <class S>
__device__ __forceinline__ void load_tile(float* X, const float* __restrict__ xr,
                                          const float* __restrict__ xi, int rows, bool vec) {
  constexpr int Q = S::TILE / 4;  // float4s a plane
  static_assert(2 * Q % kThreads == 0, "whole rounds");
#pragma unroll
  for (int r = 0; r < 2 * Q / kThreads; ++r) {
    const int i = r * kThreads + threadIdx.x;
    const int d = i / Q, e = 4 * (i % Q);
    const float* src = (d ? xi : xr) + e;
    float* dst = X + S::tile_at(d, e / S::N, e % S::N);
    const bool valid = e / S::N < rows;
    if (vec) {
      cp_async16(dst, valid ? src : xr, valid);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[c] = valid ? src[c] : 0.f;
    }
  }
  cp_async_commit();
}

// step 2 and the twiddle: C[(p, j1)][(d, k2)] = (F1b a)[d, j1, k2] W[j1, k2].
template <class S>
__device__ __forceinline__ void step2(const float* FA, const float* X, float* C,
                                      const float* __restrict__ wr,
                                      const float* __restrict__ wi, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / S::GN2, wn = warp % S::GN2;
  const float4* fab = reinterpret_cast<const float4*>(FA);
  const float4* fas = reinterpret_cast<const float4*>(FA + S::FA / 2);
  float acc[S::WM2][S::WN2][4] = {};
#pragma unroll 1
  for (int s0 = 0; s0 < S::KS2; s0 += S::U2)
#pragma unroll
  for (int s = s0; s < s0 + S::U2; ++s) {
    const int d = (8 * s) / S::N1, k1 = (8 * s) % S::N1 + t;
    const float* xk = X + d * S::XPLANE + k1 * S::LDX + wn * S::WN2 * 8 + g;
    uint32_t bb[S::WN2][2], bs[S::WN2][2];
#pragma unroll
    for (int j = 0; j < S::WN2; ++j) {
      split_tf32(xk[8 * j], bb[j][0], bs[j][0]);
      split_tf32(xk[8 * j + 4 * S::LDX], bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int i = 0; i < S::WM2; ++i) {
      const int f = ((wm * S::WM2 + i) * S::KS2 + s) * 32 + lane;
      const float4 b4 = fab[f], s4 = fas[f];
      const uint32_t ab[4] = {__float_as_uint(b4.x), __float_as_uint(b4.y),
                              __float_as_uint(b4.z), __float_as_uint(b4.w)};
      const uint32_t as[4] = {__float_as_uint(s4.x), __float_as_uint(s4.y),
                              __float_as_uint(s4.z), __float_as_uint(s4.w)};
#pragma unroll
      for (int j = 0; j < S::WN2; ++j) add_3xtf32(acc[i][j], ab, as, bb[j], bs[j]);
    }
  }
  // rows g and g + 8 of m-tile mi are (c = 0, j1) and (c = 1, j1), j1 = 8 mi + g
#pragma unroll
  for (int i = 0; i < S::WM2; ++i) {
    const int j1 = 8 * (wm * S::WM2 + i) + g;
#pragma unroll
    for (int j = 0; j < S::WN2; ++j) {
      const int col = (wn * S::WN2 + j) * 8 + 2 * t;
      const int p = col / S::N2, k2 = col % S::N2;
      const float2 w_r = __ldg(reinterpret_cast<const float2*>(wr + j1 * S::N2 + k2));
      const float2 w_i = __ldg(reinterpret_cast<const float2*>(wi + j1 * S::N2 + k2));
      const float* a = acc[i][j];
      float* c = C + (p * S::N1 + j1) * S::LDC + k2;
      *reinterpret_cast<float2*>(c) =
          make_float2(a[0] * w_r.x - a[2] * w_i.x, a[1] * w_r.y - a[3] * w_i.y);
      *reinterpret_cast<float2*>(c + S::N2) =
          make_float2(a[0] * w_i.x + a[2] * w_r.x, a[1] * w_i.y + a[3] * w_r.y);
    }
  }
}

// step 3: y_e[p n + m n1 + j1] = scale (C F2b)[(p, j1), (e, m)], for p < rows,
// straight from the accumulators: the 8 lanes of one t write 8 consecutive j1,
// one whole 32-byte sector a row m.
template <class S>
__device__ __forceinline__ void step3(const float* FB, const float* C,
                                      float* __restrict__ yr, float* __restrict__ yi,
                                      int rows, float scale, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / S::GN3, wn = warp % S::GN3;
  const float2* fbb = reinterpret_cast<const float2*>(FB);
  const float2* fbs = reinterpret_cast<const float2*>(FB + S::FB / 2);
  float acc[S::WM3][S::WN3][4] = {};
#pragma unroll 1
  for (int s0 = 0; s0 < S::KS3; s0 += S::U3)
#pragma unroll
  for (int s = s0; s < s0 + S::U3; ++s) {
    uint32_t ab[S::WM3][4], as[S::WM3][4];
#pragma unroll
    for (int i = 0; i < S::WM3; ++i) {
      const float* c = C + ((wm * S::WM3 + i) * 16 + g) * S::LDC + 8 * s + t;
      split_tf32(c[0], ab[i][0], as[i][0]);
      split_tf32(c[8 * S::LDC], ab[i][1], as[i][1]);
      split_tf32(c[4], ab[i][2], as[i][2]);
      split_tf32(c[8 * S::LDC + 4], ab[i][3], as[i][3]);
    }
#pragma unroll
    for (int j = 0; j < S::WN3; ++j) {
      const int f = (s * S::NT3 + wn * S::WN3 + j) * 32 + lane;
      const float2 b2 = fbb[f], s2 = fbs[f];
      const uint32_t bb[2] = {__float_as_uint(b2.x), __float_as_uint(b2.y)};
      const uint32_t bs[2] = {__float_as_uint(s2.x), __float_as_uint(s2.y)};
#pragma unroll
      for (int i = 0; i < S::WM3; ++i) add_3xtf32(acc[i][j], ab[i], as[i], bb, bs);
    }
  }
#pragma unroll
  for (int i = 0; i < S::WM3; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (wm * S::WM3 + i) * 16 + g + 8 * h;
      if (row / S::N1 >= rows) continue;
      const long long at = (long long)(row / S::N1) * S::N + row % S::N1;
#pragma unroll
      for (int j = 0; j < S::WN3; ++j) {
        const int col = (wn * S::WN3 + j) * 8 + 2 * t;
        float* y = (col / S::N2 ? yi : yr) + at + (col % S::N2) * S::N1;
        y[0] = acc[i][j][2 * h] * scale;
        y[S::N1] = acc[i][j][2 * h + 1] * scale;
      }
    }
  }
}

// The persistent tile loop: a kernel of 256 threads calls it with its
// dynamic shared memory (S::FLOATS floats, 16-byte aligned) and is launched
// by launch_mma with one block a resident slot.
template <class S>
__device__ __forceinline__ void four_step_mma(float* smem, const float* __restrict__ xr,
                                              const float* __restrict__ xi,
                                              float* __restrict__ yr, float* __restrict__ yi,
                                              const float* __restrict__ fa,
                                              const float* __restrict__ fb,
                                              const float* __restrict__ w, long long batch,
                                              float scale, int vec) {
  float* FA = smem;
  float* FB = FA + S::FA;
  float* X = FB + S::FB;
  float* C = X + S::XS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < S::FA / 4; i += kThreads)
    reinterpret_cast<float4*>(FA)[i] = __ldg(reinterpret_cast<const float4*>(fa) + i);
  for (int i = threadIdx.x; i < S::FB / 4; i += kThreads)
    reinterpret_cast<float4*>(FB)[i] = __ldg(reinterpret_cast<const float4*>(fb) + i);

  // The next tile's load starts as soon as step 2 has read the current one
  // and lands during step 3; the barrier at the top of each round orders it
  // (and step 3's reads of C) before step 2 of that round.
  const long long tiles = (batch + S::P - 1) / S::P;
  auto rows_of = [&](long long tile) {
    return batch - tile * S::P < S::P ? (int)(batch - tile * S::P) : S::P;
  };
  const long long first = blockIdx.x;
  if (first < tiles)
    load_tile<S>(X, xr + first * S::P * S::N, xi + first * S::P * S::N, rows_of(first), vec);
  for (long long tile = first; tile < tiles; tile += gridDim.x) {
    const long long base = tile * S::P * S::N, next = tile + gridDim.x;
    cp_async_wait_all();
    __syncthreads();
    step2<S>(FA, X, C, w, w + S::N, warp, lane);
    __syncthreads();
    if (next < tiles)
      load_tile<S>(X, xr + next * S::P * S::N, xi + next * S::P * S::N, rows_of(next), vec);
    step3<S>(FB, C, yr + base, yi + base, rows_of(tile), scale, warp, lane);
  }
}

// ---------------------------------------------------------------------------
// four_step_mma3: n = 2048 and 4096 in three factors of at most 16
// ---------------------------------------------------------------------------

// A length of the three-factor body, n = N1 N2 N3 = 16 * 16 * N3, with the
// k-steps of the two left products and of the right product unrolled at a
// time (U12_, U3_; 0 for all of them). A tile is one pencil.
template <int N1_, int N2_, int N3_, int U12_, int U3_>
struct Mma3Shape {
  static constexpr int N1 = N1_, N2 = N2_, N3 = N3_, N = N1 * N2 * N3;
  static constexpr int NQ = N2 * N3;          // a row k1 of a pencil plane: (k2, k3)
  static constexpr int NC = N / N1;           // columns of the left products
  static constexpr int TILE = N, P = 1;       // floats a plane of a tile, pencils a tile
  static constexpr int BUF = 2 * TILE;        // a tile, both planes; two buffers
  // stages 1 and 2: (2 N1 x 2 N1) times (2 N1 x NC); a warp owns 2 x WN tiles
  static constexpr int KS = N1 / 4, WN = NC / 8 / kWarps;
  // stage 3: (N1 N2 x 2 N3) times (2 N3 x 2 N3); a warp owns 2 x NT3 tiles
  static constexpr int NT3 = N3 / 4, KS3 = N3 / 4;
  static constexpr int U12 = U12_ ? U12_ : KS, U3 = U3_ ? U3_ : KS3;
  // shared memory, in floats
  static constexpr int FA = 2 * 4 * N1 * N1;  // the N1-point left table, big and small
  static constexpr int FB = 2 * 4 * N3 * N3;  // the N3-point right table, big and small
  static constexpr int FLOATS = FA + FB + 2 * BUF;
  static_assert(N1 == 16 && N2 == 16 && (N3 == 8 || N3 == 16), "16 x 16 x (8 or 16)");
  static_assert(WN * 8 * kWarps == NC && 2 * 16 * kWarps == N1 * N2, "whole tiles a warp");
  static_assert(KS % U12 == 0 && KS3 % U3 == 0, "whole unrolled rounds");

  // Where (k1, q), q = k2 N3 + k3, of a pencil plane lies: rows k1 of NQ
  // floats, unpadded, q XOR-swizzled within its 32-float block by k1 (and at
  // N3 = 16 by bit 5 of q), so that every fragment load, every float2 store
  // of a half warp and every 16-byte copy of a tile hits 32 banks.
  static __device__ __forceinline__ int at(int k1, int q) {
    const int f = ((k1 & 3) << 1) | ((k1 >> 2) & 1);
    return k1 * NQ + (q ^ (4 * f ^ (N3 == 16 ? (q >> 2) & 8 : 0)));
  }
  static __device__ __forceinline__ int tile_at(int d, int p, int q) {
    return d * TILE + at(q / NQ, q % NQ);
  }
  // Element r (the contracted index) of column m of the left product of
  // stage 1 (columns (k2, k3), r = k1) or stage 2 (columns (j1, k3), r = k2).
  template <int STAGE>
  static __device__ __forceinline__ int left_at(int r, int m) {
    return STAGE == 1 ? at(r, m) : at(m / N3, r * N3 + m % N3);
  }
};

// Stages 1 and 2, in place on the tile X: F1b (2 N1 x 2 N1, rows (c, j) in
// mma_rows order, cols (d, k)) times the tile viewed as 2 N1 rows (d, k) of
// NC columns, then the twiddle in fp32 as the result is stored back where it
// was read. Stage 1 contracts k1 (the twiddle W1[j1, k2 N3 + k3]), stage 2
// k2 (W2[j2, k3]); N1 = N2, so both take the same table. A warp owns whole
// columns, so it writes only what it alone has read.
template <class S, int STAGE>
__device__ __forceinline__ void left_stage(const float* FA, float* X,
                                           const float* __restrict__ wr,
                                           const float* __restrict__ wi, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float4* fab = reinterpret_cast<const float4*>(FA);
  const float4* fas = reinterpret_cast<const float4*>(FA + S::FA / 2);
  float acc[2][S::WN][4] = {};
#pragma unroll 1
  for (int s0 = 0; s0 < S::KS; s0 += S::U12)
#pragma unroll
  for (int s = s0; s < s0 + S::U12; ++s) {
    const int d = (8 * s) / S::N1, k = (8 * s) % S::N1 + t;
    const float* xd = X + d * S::TILE;
    uint32_t bb[S::WN][2], bs[S::WN][2];
#pragma unroll
    for (int j = 0; j < S::WN; ++j) {
      const int m = (warp * S::WN + j) * 8 + g;
      split_tf32(xd[S::template left_at<STAGE>(k, m)], bb[j][0], bs[j][0]);
      split_tf32(xd[S::template left_at<STAGE>(k + 4, m)], bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = (i * S::KS + s) * 32 + lane;
      const float4 b4 = fab[f], s4 = fas[f];
      const uint32_t ab[4] = {__float_as_uint(b4.x), __float_as_uint(b4.y),
                              __float_as_uint(b4.z), __float_as_uint(b4.w)};
      const uint32_t as[4] = {__float_as_uint(s4.x), __float_as_uint(s4.y),
                              __float_as_uint(s4.z), __float_as_uint(s4.w)};
#pragma unroll
      for (int j = 0; j < S::WN; ++j) add_3xtf32(acc[i][j], ab, as, bb[j], bs[j]);
    }
  }
  __syncwarp();
  // rows g and g + 8 of m-tile i are (c = 0, j) and (c = 1, j), j = 8 i + g
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j_ = 8 * i + g;
#pragma unroll
    for (int j = 0; j < S::WN; ++j) {
      const int m = (warp * S::WN + j) * 8 + 2 * t;
      const int tw = STAGE == 1 ? j_ * S::NQ + m : j_ * S::N3 + m % S::N3;
      const float2 w_r = __ldg(reinterpret_cast<const float2*>(wr + tw));
      const float2 w_i = __ldg(reinterpret_cast<const float2*>(wi + tw));
      const float* a = acc[i][j];
      float* o = X + S::template left_at<STAGE>(j_, m);
      *reinterpret_cast<float2*>(o) =
          make_float2(a[0] * w_r.x - a[2] * w_i.x, a[1] * w_r.y - a[3] * w_i.y);
      *reinterpret_cast<float2*>(o + S::TILE) =
          make_float2(a[0] * w_i.x + a[2] * w_r.x, a[1] * w_i.y + a[3] * w_r.y);
    }
  }
}

// Stage 3: y_e[j1 + N1 j2 + N1 N2 j3] = scale (X F3b)[(j2, j1), (e, j3)], X
// read as rows (j2, j1) of columns (d, k3), F3b = [[F3r, F3i], [-F3i,
// F3r]]; straight from the accumulators: the 8 lanes of one t write 8
// consecutive j1, one whole 32-byte sector. Warp w owns j2 = 2 w, 2 w + 1.
template <class S>
__device__ __forceinline__ void right_stage(const float* FB, const float* X,
                                            float* __restrict__ yr, float* __restrict__ yi,
                                            float scale, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2* fbb = reinterpret_cast<const float2*>(FB);
  const float2* fbs = reinterpret_cast<const float2*>(FB + S::FB / 2);
  float acc[2][S::NT3][4] = {};
#pragma unroll 1
  for (int s0 = 0; s0 < S::KS3; s0 += S::U3)
#pragma unroll
  for (int s = s0; s < s0 + S::U3; ++s) {
    const int d = (8 * s) / S::N3, k3 = (8 * s) % S::N3 + t;
    const float* x = X + d * S::TILE;
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = (2 * warp + i) * S::N3 + k3;
      split_tf32(x[S::at(g, q)], ab[i][0], as[i][0]);
      split_tf32(x[S::at(g + 8, q)], ab[i][1], as[i][1]);
      split_tf32(x[S::at(g, q + 4)], ab[i][2], as[i][2]);
      split_tf32(x[S::at(g + 8, q + 4)], ab[i][3], as[i][3]);
    }
#pragma unroll
    for (int j = 0; j < S::NT3; ++j) {
      const int f = (s * S::NT3 + j) * 32 + lane;
      const float2 b2 = fbb[f], s2 = fbs[f];
      const uint32_t bb[2] = {__float_as_uint(b2.x), __float_as_uint(b2.y)};
      const uint32_t bs[2] = {__float_as_uint(s2.x), __float_as_uint(s2.y)};
#pragma unroll
      for (int i = 0; i < 2; ++i) add_3xtf32(acc[i][j], ab[i], as[i], bb, bs);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = S::N1 * (2 * warp + i) + g + 8 * h;
#pragma unroll
      for (int j = 0; j < S::NT3; ++j) {
        const int col = j * 8 + 2 * t;
        float* y = (col / S::N3 ? yi : yr) + o + (col % S::N3) * S::N1 * S::N2;
        y[0] = acc[i][j][2 * h] * scale;
        y[S::N1 * S::N2] = acc[i][j][2 * h + 1] * scale;
      }
    }
  }
}

// The persistent tile loop of the three-factor body, as four_step_mma's: a
// kernel of 256 threads calls it with its dynamic shared memory (S::FLOATS
// floats, 16-byte aligned). w holds W2 (2, N2, N3), then W1 (2, N1, NQ). Two
// tile buffers: the next pencil's load starts as soon as the current one has
// landed and runs during all three stages.
template <class S>
__device__ __forceinline__ void four_step_mma3(float* smem, const float* __restrict__ xr,
                                               const float* __restrict__ xi,
                                               float* __restrict__ yr, float* __restrict__ yi,
                                               const float* __restrict__ fa,
                                               const float* __restrict__ fb,
                                               const float* __restrict__ w, long long batch,
                                               float scale, int vec) {
  float* FA = smem;
  float* FB = FA + S::FA;
  float* X0 = FB + S::FB;
  const float* w2 = w;
  const float* w1 = w + 2 * S::N2 * S::N3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < S::FA / 4; i += kThreads)
    reinterpret_cast<float4*>(FA)[i] = __ldg(reinterpret_cast<const float4*>(fa) + i);
  for (int i = threadIdx.x; i < S::FB / 4; i += kThreads)
    reinterpret_cast<float4*>(FB)[i] = __ldg(reinterpret_cast<const float4*>(fb) + i);

  // 32-bit pencil indices keep the loop within the registers: a card's
  // memory holds fewer than 2^31 pencils of 2048
  const int pencils = (int)batch;
  int cur = 0;
  if ((int)blockIdx.x < pencils)
    load_tile<S>(X0, xr + (long long)blockIdx.x * S::N, xi + (long long)blockIdx.x * S::N, 1,
                 vec);
  for (int pencil = blockIdx.x; pencil < pencils; pencil += gridDim.x, cur ^= 1) {
    const long long base = (long long)pencil * S::N;
    const int next = pencil + gridDim.x;
    float* X = X0 + cur * S::BUF;
    // the barrier orders this pencil's load before its stages, and the last
    // pencil's stage 3 (which read the other buffer) before the next load
    cp_async_wait_all();
    __syncthreads();
    if (next < pencils)
      load_tile<S>(X0 + (cur ^ 1) * S::BUF, xr + (long long)next * S::N,
                   xi + (long long)next * S::N, 1, vec);
    left_stage<S, 1>(FA, X, w1, w1 + S::N1 * S::NQ, warp, lane);
    __syncthreads();
    left_stage<S, 2>(FA, X, w2, w2 + S::N2 * S::N3, warp, lane);
    __syncthreads();
    right_stage<S>(FB, X, yr + base, yi + base, scale, warp, lane);
  }
}

// Call f with the MmaShape of (n1, n2); -1 for a shape the mma body does not
// take. The unrolling of each is the fastest measured on an H100 that keeps
// within the 128 registers of two blocks an SM without spilling
// (benchmarks/torch_fft_block_variants.py).
template <class F>
long long with_mma_shape(int n1, int n2, F&& f) {
  if (n1 == 8 && n2 == 8) return f(MmaShape<8, 8, 0, 0>{});
  if (n1 == 16 && n2 == 8) return f(MmaShape<16, 8, 1, 1>{});
  if (n1 == 16 && n2 == 16) return f(MmaShape<16, 16, 0, 1>{});
  if (n1 == 32 && n2 == 16) return f(MmaShape<32, 16, 1, 1>{});
  if (n1 == 32 && n2 == 32) return f(MmaShape<32, 32, 0, 0>{});
  return -1;
}

// Call f with the shape of the tensor-core body for pencils of n: the
// three-factor Mma3Shape for n = 2048 and 4096, else the two-factor MmaShape
// of n's four-step factors (n1 >= n2, as square as possible); -1 for a
// length neither takes.
template <class F>
long long with_any_mma_shape(int n, F&& f) {
  if (n == 2048) return f(Mma3Shape<16, 16, 8, 0, 0>{});
  if (n == 4096) return f(Mma3Shape<16, 16, 16, 1, 1>{});
  int k = 0;
  while ((1 << k) < n) ++k;
  if (n < 1 || (1 << k) != n) return -1;
  return with_mma_shape(1 << ((k + 1) / 2), 1 << (k / 2), f);
}

// Blocks a slot for `kern` with `smem` dynamic bytes, after raising its limit.
template <class K>
cudaError_t resident_blocks(K kern, long long smem, int* per_sm, int* sms) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads, (size_t)smem);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Launch `kernel`, an instance of the body for S, with one block a resident
// slot (at most one a tile); the CUDA error.
template <class S, class K>
long long launch_mma(K kernel, const float* xr, const float* xi, float* yr, float* yi,
                     const float* fa, const float* fb, const float* w, long long batch,
                     float scale, void* stream) {
  const long long smem = (long long)S::FLOATS * sizeof(float);
  int per_sm = 0, sms = 0;
  cudaError_t err = resident_blocks(kernel, smem, &per_sm, &sms);
  if (err != cudaSuccess) return (long long)err;
  if (per_sm < 1) return (long long)cudaErrorInvalidConfiguration;
  const long long tiles = (batch + S::P - 1) / S::P;
  const long long slots = (long long)sms * per_sm;
  const long long blocks = tiles < slots ? tiles : slots;
  const int vec = aligned16(xr) && aligned16(xi);  // the tile loads' 16-byte copies
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, fa, fb, w, batch, scale, vec);
  return (long long)cudaGetLastError();
}

}  // namespace
