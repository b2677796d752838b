// The long body for Hopper (sm_90a): pencils of 4096 < n <= 65536, fp32 on
// the CUDA cores, one pass over device memory through shared memory.
//
// One body behind all four kernels of the port, at the lengths whose
// pencil no longer fits the register and shared-memory bodies:
//
//  * fft_pencil, fft_matmul and fft_block (src/repro/kernels/fft_pencil.py:76,
//    fft_matmul.py:71, fft_block.py:49) take a batch of length-n pencils,
//    planar re/im, and return the DFT of each in natural order
//    (fft_long_launch: long_kernel<LOG2N, 0>, one launch);
//  * fft_twiddle_transpose (src/repro/kernels/fft_fused.py:58) takes rows
//    (nl, b, n) and returns out[l, k, j] = (W * FFT(x))[l, j, k], W an
//    optional pair of twiddle planes whose leading slices lie `wstride`
//    floats apart (fft_fused_long_launch: long_kernel<LOG2N, 1> into a
//    scratch, then long_transpose_kernel, a chunk of pencils at a time).
//
// It runs the reference's own split n = NA * NB, four_step_factors(n):
// 128 x 64 at 8192, 128 x 128, 256 x 128, 256 x 256 at 65536. With
// x[i NB + j], i < NA, j < NB,
//   X[k1 + NA k2] = sum_j w_NB^(j k2) w_n^(j k1) sum_i x[i NB + j] w_NA^(i k1).
//
// A pencil lives in shared memory, in one block at 8192 (64 KiB) and 16384
// (128 KiB), in a thread-block cluster of C = 2 or 4 blocks of 128 KiB each
// at 32768 and 65536 (launched by cudaLaunchKernelEx with the cluster
// dimension). Block r of a cluster holds the slab of columns j in
// [r J, r J + J), J = NB / C, as a tile of NA rows e and J columns jl. The
// tile is column-major, element (e, jl) of a plane at jl NA + (e ^ (jl & 31)),
// except at 8192, where it is row-major, at e J + (jl ^ (e & 31)).
//
// Columns: a group of NA/8 warps takes 32 columns, one a lane, warp t of the
// group being thread t of each column's NA-point FFT on the radix-8 register
// passes of radix8.cuh (thread t holds elements t + T q). Its loads are runs
// of 32 consecutive j (128 bytes), straight into registers a round at a
// time; at 8192, cp.async copies into the tile, every round's issued before
// the first round computes (faster there only with the row-major tile, and
// slower at 16384: benchmarks/torch_fft_long_variants.py, PERF.md). Each
// exchange is made in place in the column of the tile, the group
// synchronised on its own named barrier; the
// result is multiplied by w_n^(j k1) and written back in place. The twiddle
// comes from the four-step's host table W[k1 NB + j] (float64 roots rounded
// to fp32, core/fft1d.py:four_step_tables): a thread reads w_n^(j t) and
// w_n^(j NA/8), two entries for its eight values, and makes the rest by
// products (at most four roundings).
//
// Rows: after the cluster's barrier, block r takes k1 in [r KA, r KA + KA),
// KA = NA / C, a group of NB/8 warps 32 rows, one a lane, and runs each
// row's NB-point FFT over j < NB, reading the other blocks' tiles through
// distributed shared memory (the cluster's shared window) and exchanging in
// place in its own tile (C = 1) or in a staging area of 32 rows a group
// (C > 1: its tile is still read by the others). Each thread ends holding
// X[k1 + NA k2], k2 = t + T q, so a warp's store is a run of 32 consecutive
// k1: natural order, 128 bytes. The 1/n of the inverse is applied here, and
// in the fused kernel the scale and the twiddle plane (read along k, in runs,
// at l wstride + j n + k) before the store into the scratch (l, j, k).
//
// Every shared access of a warp touches 32 banks: its lanes differ in the
// column or the row index, and the layout XORs the five low bits of the one
// into the other. In a cluster the tile is column-major, so a row phase's
// read of another block's tile is one 128-byte run a warp (its lanes are 32
// consecutive rows of one column): distributed shared memory moves whole
// runs: with a row-major tile, whose such reads are 32 words a row apart,
// the kernel took 1.9x its time at 32768 and 2.4x at 65536. The
// fused kernel's transposed store is long_transpose_kernel:
// 32 k x 32 j tiles of both planes through shared rows of 33 floats, each
// store to out[l, k, j] a run of 32 consecutive j.
//
// Bound: memory, 16 bytes an element for the function, which is what
// long_kernel<LOG2N, 0> moves (each element read once and written once; the
// tables stay in L1 and L2). The fused route moves 32 (40 with twiddle
// planes): the scratch's write and read, at most kScratchElems elements a
// plane. What holds the kernel above its bound is that a block of 128 KiB
// (16384 and above) is alone on its SM, so its loads, sub-FFTs and stores
// follow one another (the variants script's probes time it without a
// phase's passes). 512 threads at NA = 128 keep it to 128 registers a
// thread, where 1024 spilled. The inverse reads the conjugate tables, flips
// the radix-8 DFT's constants with `s` = -1 and scales by 1/n.

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "radix8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr long long kScratchElems = 1LL << 24;  // the fused kernel's scratch, a plane
constexpr int kMinLog2 = 13, kMaxLog2 = 16;     // 8192 .. 65536
constexpr int kLanes = 32;                      // sub-FFTs a group: one a lane
constexpr int kTile = 32;                       // the transpose's tile side
constexpr int kTransposeRows = 8;               // warps of a transpose block

// The plan of a length-2^LOG2N pencil: the split NA = 2^LA >= NB = 2^LB,
// the cluster, the block, and the shared floats.
template <int LOG2N>
struct Long {
  static constexpr int LA = (LOG2N + 1) / 2, LB = LOG2N / 2;
  static constexpr int NA = 1 << LA, NB = 1 << LB, N = 1 << LOG2N;
  static constexpr int C = LOG2N <= 14 ? 1 : 1 << (LOG2N - 14);  // blocks a pencil
  static constexpr int J = NB / C;       // columns a block holds
  static constexpr int KA = NA / C;      // rows k1 a block transforms
  static constexpr int TA = NA / 8, TB = NB / 8;  // warps a column / row group
  // 512 where NA = 128 (up to 128 registers a thread; 1024 spilled), 1024
  // where NA = 256 (a column group is 32 warps)
  static constexpr int THREADS = LOG2N <= 14 ? 512 : 1024;
  static constexpr int MIN_BLOCKS = LOG2N == 13 ? 2 : 1;
  // the tile row-major (else column-major), the column loads by cp.async
  static constexpr bool ROW_MAJOR = LOG2N == 13, ASYNC = LOG2N == 13;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int GA = WARPS / TA, GB = WARPS / TB;  // groups a block
  static constexpr int TILE = NA * J;                     // floats a plane of the tile
  static constexpr int ROUNDS = J / kLanes / GA;          // column rounds a group
  static constexpr int STAGE = C > 1 ? 2 * GB * kLanes * NB : 0;  // the rows' exchange
  static constexpr int SMEM_FLOATS = 2 * TILE + STAGE;
  static_assert(J % kLanes == 0 && (J / kLanes) % GA == 0 && (KA / kLanes) % GB == 0,
                "every group takes whole rounds");
};

// The offset of element (e, jl) in a plane of a tile. Column-major: column
// jl is a run of NA floats, permuted within each 32 by the column's five low
// bits, so lanes that differ in e read one 128-byte run. Row-major: row e is
// a run of J floats, permuted by the row's five low bits. Either way a
// warp's 32 lanes touch 32 banks whether they differ in jl or in e.
template <class S>
__device__ __forceinline__ int tile_at(int e, int jl) {
  if constexpr (S::ROW_MAJOR) return e * S::J + (jl ^ (e & 31));
  return jl * S::NA + (e ^ (jl & 31));
}

// A cp.async copy of one float from device memory into shared memory.
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// Wait until at most `pending` (< MAX + 1) of this thread's cp.async groups
// are in flight.
template <int MAX>
__device__ __forceinline__ void cp_async_wait(int pending) {
  if constexpr (MAX > 0) {
    if (pending >= MAX) {
      asm volatile("cp.async.wait_group %0;" ::"n"(MAX) : "memory");
      return;
    }
    cp_async_wait<MAX - 1>(pending);
  } else {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
}

// Synchronise the `threads` threads of named barrier `id` (a group).
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi, float& cr,
                                     float& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

// Pass PASS and every pass after it of the 2^LOG2M-point FFT of a sub-FFT
// whose T = 2^LOG2M / 8 threads are T warps of a group (thread t holds
// elements t + T j). Each exchange is made in place at `buf + at(e)` (the
// im plane `plane` floats on), the group synchronised before the writes
// (every read of the buffer is done) and after them.
template <int LOG2M, int PASS, class At>
__device__ __forceinline__ void sub_fft(float (&vr)[8], float (&vi)[8], int t, float* buf,
                                        int plane, At at, int bar, int threads,
                                        const float* __restrict__ twr,
                                        const float* __restrict__ twi, float s) {
  using L = Radix8<LOG2M>;
  static_assert(L::R0 == 8, "eight values a thread");
  constexpr int R = L::radix(PASS), NS = L::span(PASS), G = 8 / R, T = L::T;
  if constexpr (PASS > 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int a = at(t + T * j);
      vr[j] = buf[a];
      vi[j] = buf[plane + a];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float ar[R], ai[R];
#pragma unroll
    for (int m = 0; m < R; ++m) { ar[m] = vr[g + G * m]; ai[m] = vi[g + G * m]; }
    if constexpr (NS > 1) {
      const int k = (t + T * g) & (NS - 1);
#pragma unroll
      for (int m = 1; m < R; ++m) {
        const int w = NS - 1 + (m - 1) * NS + k;
        const float wr = __ldg(twr + w), wi = __ldg(twi + w);
        const float xr = ar[m];
        ar[m] = xr * wr - ai[m] * wi;
        ai[m] = xr * wi + ai[m] * wr;
      }
    }
    dft<R>(ar, ai, s);
#pragma unroll
    for (int m = 0; m < R; ++m) { vr[g + G * m] = ar[m]; vi[g + G * m] = ai[m]; }
  }
  if constexpr (PASS + 1 < L::PASSES) {
    group_sync(bar, threads);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int tp = t + T * g;
      const int base = (tp / NS) * NS * R + (tp & (NS - 1));
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int a = at(base + q * NS);
        buf[a] = vr[g + G * q];
        buf[plane + a] = vi[g + G * q];
      }
    }
    group_sync(bar, threads);
    sub_fft<LOG2M, PASS + 1>(vr, vi, t, buf, plane, at, bar, threads, twr, twi, s);
  }
}

// One pencil a cluster (FUSED = 0: y = FFT(x), natural order; FUSED = 1:
// pencil p of the chunk g0 .. of rows (nl, b, n) into the scratch y, scaled
// and multiplied by the twiddle planes (tr, ti) when given).
template <int LOG2N, int FUSED>
__global__ void __launch_bounds__(Long<LOG2N>::THREADS, Long<LOG2N>::MIN_BLOCKS)
long_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            float* __restrict__ yr, float* __restrict__ yi,
            const float* __restrict__ ar, const float* __restrict__ ai,
            const float* __restrict__ br, const float* __restrict__ bi,
            const float* __restrict__ wr, const float* __restrict__ wi,
            const float* __restrict__ tr, const float* __restrict__ ti,
            long long g0, long long b, long long wstride, float s, float scale) {
  using S = Long<LOG2N>;
  constexpr int NA = S::NA, NB = S::NB, N = S::N, J = S::J, KA = S::KA, TA = S::TA,
                TB = S::TB, TILE = S::TILE;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = S::C > 1 ? (int)cluster.block_rank() : 0;
  const long long p = blockIdx.x / S::C;
  const long long base = p * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // columns j = rank J + jl: load, NA-point FFT in place, twiddle
  {
    const int grp = warp / TA, t = warp % TA;
    if constexpr (S::ASYNC) {  // every round's loads in flight, a group a round
#pragma unroll 1
      for (int round = 0; round < S::ROUNDS; ++round) {
        const int jl = (round * S::GA + grp) * kLanes + lane;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const long long g = base + (long long)(t + TA * q) * NB + rank * J + jl;
          const int a = tile_at<S>(t + TA * q, jl);
          cp_async(smem + a, xr + g);
          cp_async(smem + TILE + a, xi + g);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
      }
    }
#pragma unroll 1
    for (int round = 0; round < S::ROUNDS; ++round) {
      const int jl = (round * S::GA + grp) * kLanes + lane;
      const int j = rank * J + jl;
      float vr[8], vi[8];
      if constexpr (S::ASYNC) {  // this round's copies are the thread's own: no barrier
        cp_async_wait<S::ROUNDS - 1>(S::ROUNDS - 1 - round);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int a = tile_at<S>(t + TA * q, jl);
          vr[q] = smem[a];
          vi[q] = smem[TILE + a];
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          vr[q] = __ldg(xr + base + (long long)(t + TA * q) * NB + j);
          vi[q] = __ldg(xi + base + (long long)(t + TA * q) * NB + j);
        }
      }
      const auto at = [jl](int e) { return tile_at<S>(e, jl); };
      sub_fft<S::LA, 0>(vr, vi, t, smem, TILE, at, 1 + grp, TA * 32, ar, ai, s);
      // w_n^(j k1), k1 = t + TA q: w_n^(j t) times the q-th power of w_n^(j TA)
      float pr[8], pi[8];
      pr[0] = __ldg(wr + t * NB + j);
      pi[0] = __ldg(wi + t * NB + j);
      pr[1] = __ldg(wr + TA * NB + j);
      pi[1] = __ldg(wi + TA * NB + j);
      cmul(pr[1], pi[1], pr[1], pi[1], pr[2], pi[2]);
      cmul(pr[2], pi[2], pr[1], pi[1], pr[3], pi[3]);
      cmul(pr[2], pi[2], pr[2], pi[2], pr[4], pi[4]);
      cmul(pr[4], pi[4], pr[1], pi[1], pr[5], pi[5]);
      cmul(pr[4], pi[4], pr[2], pi[2], pr[6], pi[6]);
      cmul(pr[4], pi[4], pr[3], pi[3], pr[7], pi[7]);
#pragma unroll
      for (int q = 1; q < 8; ++q) cmul(pr[0], pi[0], pr[q], pi[q], pr[q], pi[q]);
      group_sync(1 + grp, TA * 32);  // the last pass's reads are done: write in place
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int a = at(t + TA * q);
        float ur, ui;
        cmul(vr[q], vi[q], pr[q], pi[q], ur, ui);
        smem[a] = ur;
        smem[TILE + a] = ui;
      }
    }
  }
  if constexpr (S::C > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }

  // rows k1 = rank KA + ...: NB-point FFT over j, store X[k1 + NA k2]
  {
    const int grp = warp / TB, t = warp % TB;
    long long l = 0, jj = 0;
    if constexpr (FUSED) {
      l = (g0 + p) / b;
      jj = g0 + p - l * b;
    }
#pragma unroll 1
    for (int round = 0; round < KA / kLanes / S::GB; ++round) {
      const int k1 = rank * KA + (round * S::GB + grp) * kLanes + lane;
      float vr[8], vi[8];
      if constexpr (S::C == 1) {
        const auto at = [k1](int e) { return tile_at<S>(k1, e); };
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int a = at(t + TB * q);
          vr[q] = smem[a];
          vi[q] = smem[TILE + a];
        }
        sub_fft<S::LB, 0>(vr, vi, t, smem, TILE, at, 1 + grp, TB * 32, br, bi, s);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {  // j = t + TB q lies in block (TB q) / J
          const float* src = cluster.map_shared_rank(smem, (TB * q) / J);
          const int a = tile_at<S>(k1, t + (TB * q) % J);
          vr[q] = src[a];
          vi[q] = src[TILE + a];
        }
        float* stage = smem + 2 * TILE + grp * 2 * kLanes * NB;
        const auto at = [lane](int e) { return e * kLanes + lane; };
        sub_fft<S::LB, 0>(vr, vi, t, stage, kLanes * NB, at, 1 + grp, TB * 32, br, bi, s);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const long long k = k1 + (long long)NA * (t + TB * q);
        float ur = vr[q] * scale, ui = vi[q] * scale;
        if constexpr (FUSED) {
          if (tr != nullptr) {
            const long long w = l * wstride + jj * N + k;
            cmul(ur, ui, tr[w], ti[w], ur, ui);
          }
        }
        yr[base + k] = ur;
        yi[base + k] = ui;
      }
    }
  }
  if constexpr (S::C > 1) cluster.sync();  // the others' reads of this tile are done
}

// The fused kernel's transposed store on a chunk of m pencils g0 .. of rows
// (nl, b, n): out[l, k, j] = y[g - g0, k], g = l b + j. A block moves a tile
// of 32 pencils x 32 k through shared rows of 33 floats.
__global__ void __launch_bounds__(kTile * kTransposeRows)
long_transpose_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                      float* __restrict__ outr, float* __restrict__ outi, long long m,
                      long long n, long long g0, long long b) {
  __shared__ float sr[kTile][kTile + 1], si[kTile][kTile + 1];
  const long long p0 = (long long)blockIdx.y * kTile;
  const long long k0 = (long long)blockIdx.x * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
#pragma unroll
  for (int r = ty; r < kTile; r += kTransposeRows) {
    if (p0 + r < m) {
      const long long at = (p0 + r) * n + k0 + tx;
      sr[r][tx] = yr[at];
      si[r][tx] = yi[at];
    }
  }
  __syncthreads();
  if (p0 + tx < m) {
    const long long g = g0 + p0 + tx, l = g / b, j = g - l * b;
#pragma unroll
    for (int r = ty; r < kTile; r += kTransposeRows) {
      const long long at = (l * n + k0 + r) * b + j;
      outr[at] = sr[tx][r];
      outi[at] = si[tx][r];
    }
  }
}

int log2_of(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

bool takes(int n) {
  const int k = log2_of(n);
  return n > 0 && (1 << k) == n && k >= kMinLog2 && k <= kMaxLog2;
}

// Pencils a chunk of the fused kernel holds: the scratch's kScratchElems
// elements, never more than the batch.
long long chunk_pencils(int n, long long pencils) {
  const long long per = kScratchElems / n > 0 ? kScratchElems / n : 1;
  return pencils < per ? pencils : per;
}

template <int LOG2N>
cudaLaunchConfig_t cluster_config(long long clusters, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  using S = Long<LOG2N>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * S::C), 1, 1);
  cfg.blockDim = dim3(S::THREADS, 1, 1);
  cfg.dynamicSmemBytes = S::SMEM_FLOATS * sizeof(float);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S::C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int LOG2N, int FUSED>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(long_kernel<LOG2N, FUSED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Long<LOG2N>::SMEM_FLOATS * (int)sizeof(float));
}

// One cluster a pencil on `pencils` pencils; the CUDA error of the launch.
template <int LOG2N, int FUSED>
int run_kernel(const float* xr, const float* xi, float* yr, float* yi, const float* ar,
               const float* ai, const float* br, const float* bi, const float* wr,
               const float* wi, const float* tr, const float* ti, long long pencils,
               long long g0, long long b, long long wstride, float s, float scale,
               cudaStream_t stream) {
  if (pencils * Long<LOG2N>::C > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = set_smem<LOG2N, FUSED>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<LOG2N>(pencils, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, long_kernel<LOG2N, FUSED>, xr, xi, yr, yi, ar, ai, br, bi,
                           wr, wi, tr, ti, g0, b, wstride, s, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int LOG2N>
int launch_fused_long(const float* xr, const float* xi, const float* tr, const float* ti,
                      float* outr, float* outi, float* yr, float* yi, const float* ar,
                      const float* ai, const float* br, const float* bi, const float* wr,
                      const float* wi, long long nl, long long b, long long wstride, float s,
                      float scale, cudaStream_t stream) {
  constexpr int N = Long<LOG2N>::N;
  const long long pencils = nl * b;
  const long long chunk = chunk_pencils(N, pencils);
  for (long long g0 = 0; g0 < pencils; g0 += chunk) {
    const long long m = pencils - g0 < chunk ? pencils - g0 : chunk;
    int e = run_kernel<LOG2N, 1>(xr + g0 * N, xi + g0 * N, yr, yi, ar, ai, br, bi, wr, wi,
                                 tr, ti, m, g0, b, wstride, s, scale, stream);
    if (e) return e;
    const long long tiles = (m + kTile - 1) / kTile;
    if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
    long_transpose_kernel<<<dim3(N / kTile, (unsigned)tiles), kTile * kTransposeRows, 0,
                            stream>>>(yr, yi, outr, outi, m, N, g0, b);
    if ((e = (int)cudaGetLastError())) return e;
  }
  return 0;
}

template <int LOG2N, int FUSED>
int occupancy(int* per_sm, int* regs, int* clusters) {
  using S = Long<LOG2N>;
  cudaError_t err = set_smem<LOG2N, FUSED>();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, long_kernel<LOG2N, FUSED>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, long_kernel<LOG2N, FUSED>, S::THREADS, S::SMEM_FLOATS * sizeof(float));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cattr;
  const cudaLaunchConfig_t cfg = cluster_config<LOG2N>(1, 0, &cattr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, long_kernel<LOG2N, FUSED>, &cfg);
}

#define LONG_LENGTHS(X) X(13) X(14) X(15) X(16)

}  // namespace

extern "C" {

// Shared bytes a block of long_kernel takes for pencils of n (the tile's
// two planes, and the rows' staging in a cluster); -1 where the long body
// does not take n.
long long long_smem_bytes(int n) {
  if (!takes(n)) return -1;
  switch (log2_of(n)) {
#define X(L) \
  case L:    \
    return (long long)Long<L>::SMEM_FLOATS * (long long)sizeof(float);
    LONG_LENGTHS(X)
#undef X
  }
  return -1;
}

// Threads a block of long_kernel runs; -1 where the long body does not take n.
int long_threads(int n) {
  if (!takes(n)) return -1;
  switch (log2_of(n)) {
#define X(L) \
  case L:    \
    return Long<L>::THREADS;
    LONG_LENGTHS(X)
#undef X
  }
  return -1;
}

// Blocks a pencil (the cluster's size); -1 where the long body does not take n.
int long_cluster(int n) {
  if (!takes(n)) return -1;
  switch (log2_of(n)) {
#define X(L) \
  case L:    \
    return Long<L>::C;
    LONG_LENGTHS(X)
#undef X
  }
  return -1;
}

// Static shared bytes of a block of long_transpose_kernel.
long long long_transpose_smem_bytes() {
  return 2LL * kTile * (kTile + 1) * (long long)sizeof(float);
}

// Scratch bytes a launch on `pencils` pencils of n needs: two planes of
// one chunk for the fused kernel (fused != 0), none for the others.
long long long_scratch_bytes(int n, long long pencils, int fused) {
  if (!takes(n)) return -1;
  return fused ? 2 * chunk_pencils(n, pencils) * n * (long long)sizeof(float) : 0;
}

// Device-memory bytes a launch moves an element: 16 (read x, write y), the
// fused kernel's scratch 16 more, its twiddle planes 8 more.
int long_hbm_bytes(int fused, int twiddle) {
  return 16 + (fused ? 16 + (twiddle ? 8 : 0) : 0);
}

// Blocks an SM holds, registers a thread and clusters the device holds at
// once (cudaOccupancyMaxActiveClusters) of long_kernel for pencils of n
// (fused != 0: the fused kernel's first launch); the CUDA error, or
// cudaErrorInvalidValue where the long body does not take n.
int long_occupancy(int n, int fused, int* per_sm, int* regs, int* clusters) {
  if (!takes(n)) return (int)cudaErrorInvalidValue;
  switch (log2_of(n)) {
#define X(L)                                                              \
  case L:                                                                 \
    return fused ? occupancy<L, 1>(per_sm, regs, clusters)                \
                 : occupancy<L, 0>(per_sm, regs, clusters);
    LONG_LENGTHS(X)
#undef X
  }
  return (int)cudaErrorInvalidValue;
}

// fft_pencil, fft_matmul and fft_block on `batch` pencils of n, x into y:
// (ar, ai) and (br, bi) the radix-8 tables of NA and NB points, (wr, wi)
// the four-step table W[k1 NB + j]; s = 1 forward, -1 inverse.
int fft_long_launch(const float* xr, const float* xi, float* yr, float* yi, const float* ar,
                    const float* ai, const float* br, const float* bi, const float* wr,
                    const float* wi, long long batch, int n, float s, float scale,
                    void* stream) {
  if (!takes(n)) return (int)cudaErrorInvalidValue;
  switch (log2_of(n)) {
#define X(L)                                                                             \
  case L:                                                                                \
    return run_kernel<L, 0>(xr, xi, yr, yi, ar, ai, br, bi, wr, wi, nullptr, nullptr,    \
                            batch, 0, 1, 0, s, scale, (cudaStream_t)stream);
    LONG_LENGTHS(X)
#undef X
  }
  return (int)cudaErrorInvalidValue;
}

// fft_twiddle_transpose on rows (nl, b, n) into (nl, n, b): (tr, ti) the
// twiddle planes or null, (yr, yi) a scratch of long_scratch_bytes, the
// tables as fft_long_launch's.
int fft_fused_long_launch(const float* xr, const float* xi, const float* tr, const float* ti,
                          float* outr, float* outi, float* yr, float* yi, const float* ar,
                          const float* ai, const float* br, const float* bi, const float* wr,
                          const float* wi, long long nl, long long b, long long wstride, int n,
                          float s, float scale, void* stream) {
  if (!takes(n)) return (int)cudaErrorInvalidValue;
  switch (log2_of(n)) {
#define X(L)                                                                           \
  case L:                                                                              \
    return launch_fused_long<L>(xr, xi, tr, ti, outr, outi, yr, yi, ar, ai, br, bi, wr, \
                                wi, nl, b, wstride, s, scale, (cudaStream_t)stream);
    LONG_LENGTHS(X)
#undef X
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
