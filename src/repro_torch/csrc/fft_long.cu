// The long body for Hopper (sm_90a): pencils of 4096 < n <= 65536, fp32 on
// the CUDA cores, in two passes over device memory.
//
// One body behind all four kernels of the port, at the lengths whose
// pencil no longer fits one block's registers and shared memory:
//
//  * fft_pencil, fft_matmul and fft_block (src/repro/kernels/fft_pencil.py:76,
//    fft_matmul.py:71, fft_block.py:49) take a batch of length-n pencils,
//    planar re/im, and return the DFT of each in natural order
//    (fft_long_launch);
//  * fft_twiddle_transpose (src/repro/kernels/fft_fused.py:58) takes rows
//    (nl, b, n) and returns out[l, k, j] = (W * FFT(x))[l, j, k], W an
//    optional pair of twiddle planes whose leading slices lie `wstride`
//    floats apart (fft_fused_long_launch).
//
// It runs the reference's own split n = NA * NB, four_step_factors(n):
// 128 x 64 at 8192, 128 x 128, 256 x 128, 256 x 256 at 65536. With
// x[i NB + j], i < NA, j < NB,
//   X[k1 + NA k2] = sum_j w_NB^(j k2) w_n^(j k1) sum_i x[i NB + j] w_NA^(i k1).
//
// Pass 1 (long_column_kernel), over columns: a block takes kCols = 16
// consecutive columns j of one pencil, so each of its loads is a run of 16
// floats (two whole 32-byte sectors); each column's NA-point FFT runs on
// NA / 8 threads through the radix-8 register passes of radix8.cuh, the
// result is multiplied by w_n^(j k1) from the four-step's host table
// W[k1 NB + j] (float64 roots rounded to fp32, core/fft1d.py:four_step_tables)
// and staged in shared memory, and the block stores its 16 rows of y[j NA + k1]
// as one contiguous run of 16 NA floats.
//
// Pass 2 (long_row_kernel), in place on y: a block takes 16 consecutive k1
// of one pencil, runs the NB-point FFT over y[j NA + k1], j < NB, and writes
// it back to the same column, y[k2 NA + k1] = X[k1 + NA k2]: natural order.
// The 1/n of the inverse is applied here. Every block reads and writes only
// its own columns, so nothing but the output is needed. The fused kernel's
// pass 2 (long_fused_row_kernel) reads pass 1's result from a scratch plane
// (its transposed store cannot be made in place), scales, applies the
// twiddle plane, read in place when one (b, n) plane serves every slice
// (`wstride` 0), and stores out[l, k, j]. The wrapper hands it a scratch of
// at most kScratchElems elements a plane, and the entry point runs the
// two passes on one chunk of pencils at a time.
//
// Bound: memory, 16 bytes an element for the function. The body moves each
// element twice (32 bytes) and reads the four-step table from L2; a single
// pass through a cluster's distributed shared memory, or tensor-core
// sub-FFTs, is a later redesign. The inverse reads the conjugate tables,
// flips the radix-8 DFT's constants with `s` = -1 and scales by 1/n.

#include <climits>

#include <cuda_runtime.h>

#include "radix8.cuh"

namespace {

constexpr int kCols = 16;                    // columns (pass 1) or k1 (pass 2) a block
constexpr int kStagePad = 2;                 // floats past NA in a staging row
constexpr long long kScratchElems = 1LL << 24;  // the fused kernel's scratch, a plane
constexpr int kMinLog2 = 13, kMaxLog2 = 16;  // 8192 .. 65536

// The split of a length-2^LOG2N pencil: NA = 2^LA >= NB = 2^LB.
template <int LOG2N>
struct LongSplit {
  static constexpr int LA = (LOG2N + 1) / 2, LB = LOG2N / 2;
  static constexpr int NA = 1 << LA, NB = 1 << LB, N = 1 << LOG2N;
};

// Floats one exchange buffer's plane holds for kCols sub-FFTs of 2^LOG2M.
template <int LOG2M>
__host__ __device__ constexpr int exchange_plane() {
  return kCols * Radix8<LOG2M>::LD;
}

// Floats of the shared memory a pass takes: its exchange buffers (one per
// exchange, two at most, a re and an im plane each) and, in pass 1, the
// staging rows, which overlay them once the passes are done.
template <int LOG2M>
__host__ __device__ constexpr int exchange_floats() {
  constexpr int exchanges = Radix8<LOG2M>::PASSES - 1;
  return (exchanges < 2 ? exchanges : 2) * 2 * exchange_plane<LOG2M>();
}

template <int LOG2N>
__host__ __device__ constexpr int column_smem_floats() {
  constexpr int LA = LongSplit<LOG2N>::LA;
  constexpr int stage = 2 * kCols * ((1 << LA) + kStagePad);
  return exchange_floats<LA>() > stage ? exchange_floats<LA>() : stage;
}

template <int LOG2N>
__host__ __device__ constexpr int row_smem_floats() {
  return exchange_floats<LongSplit<LOG2N>::LB>();
}

template <int LOG2N>
__global__ void __launch_bounds__(kCols * LongSplit<LOG2N>::NA / 8)
long_column_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ yr, float* __restrict__ yi,
                   const float* __restrict__ ar, const float* __restrict__ ai,
                   const float* __restrict__ wr, const float* __restrict__ wi, float s) {
  using S = LongSplit<LOG2N>;
  using A = Radix8<S::LA>;
  constexpr int NA = S::NA, NB = S::NB, T = A::T, TILES = NB / kCols;
  constexpr int LDS = NA + kStagePad;
  extern __shared__ float smem[];
  const int c = threadIdx.x % kCols;
  const int t = threadIdx.x / kCols;
  const long long base = (long long)(blockIdx.x / TILES) * S::N;
  const int j0 = (blockIdx.x % TILES) * kCols;
  const int j = j0 + c;
  float vr[8], vi[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const long long at = base + (long long)(t + T * q) * NB + j;
    vr[q] = xr[at];
    vi[q] = xi[at];
  }
  radix8_passes<S::LA, 0>(vr, vi, t, smem, exchange_plane<S::LA>(), c * A::LD, ar, ai, s);
  __syncthreads();  // every thread is past its last exchange read: stage over the buffers
  float* sr = smem;
  float* si = smem + kCols * LDS;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k1 = t + T * q;
    const float tr = __ldg(wr + k1 * NB + j), ti = __ldg(wi + k1 * NB + j);
    sr[c * LDS + k1] = vr[q] * tr - vi[q] * ti;
    si[c * LDS + k1] = vr[q] * ti + vi[q] * tr;
  }
  __syncthreads();
  // rows j0 .. j0 + 15 of y[j NA + k1]: one contiguous run of kCols * NA floats
  const long long out = base + (long long)j0 * NA;
  for (int i = threadIdx.x; i < kCols * NA; i += blockDim.x) {
    const int row = i / NA, k1 = i % NA;
    yr[out + i] = sr[row * LDS + k1];
    yi[out + i] = si[row * LDS + k1];
  }
}

template <int LOG2N>
__global__ void __launch_bounds__(kCols * LongSplit<LOG2N>::NB / 8)
long_row_kernel(float* yr, float* yi, const float* __restrict__ br,
                const float* __restrict__ bi, float s, float scale) {
  using S = LongSplit<LOG2N>;
  using B = Radix8<S::LB>;
  constexpr int NA = S::NA, T = B::T, TILES = NA / kCols;
  extern __shared__ float smem[];
  const int c = threadIdx.x % kCols;
  const int t = threadIdx.x / kCols;
  const long long base =
      (long long)(blockIdx.x / TILES) * S::N + (blockIdx.x % TILES) * kCols + c;
  float vr[8], vi[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    vr[q] = yr[base + (long long)(t + T * q) * NA];
    vi[q] = yi[base + (long long)(t + T * q) * NA];
  }
  radix8_passes<S::LB, 0>(vr, vi, t, smem, exchange_plane<S::LB>(), c * B::LD, br, bi, s);
#pragma unroll
  for (int q = 0; q < 8; ++q) {  // k2 = t + T q
    yr[base + (long long)(t + T * q) * NA] = vr[q] * scale;
    yi[base + (long long)(t + T * q) * NA] = vi[q] * scale;
  }
}

// Pass 2 of the fused kernel on the pencils g0 .. of rows (nl, b, n): pencil
// g = l b + j of the input is pencil g - g0 of the scratch y.
template <int LOG2N>
__global__ void __launch_bounds__(kCols * LongSplit<LOG2N>::NB / 8)
long_fused_row_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                      const float* __restrict__ wr, const float* __restrict__ wi,
                      float* __restrict__ outr, float* __restrict__ outi,
                      const float* __restrict__ br, const float* __restrict__ bi,
                      long long g0, long long b, long long wstride, float s, float scale) {
  using S = LongSplit<LOG2N>;
  using B = Radix8<S::LB>;
  constexpr int NA = S::NA, N = S::N, T = B::T, TILES = NA / kCols;
  extern __shared__ float smem[];
  const int c = threadIdx.x % kCols;
  const int t = threadIdx.x / kCols;
  const long long local = blockIdx.x / TILES;
  const int k1 = (blockIdx.x % TILES) * kCols + c;
  const long long base = local * N + k1;
  float vr[8], vi[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    vr[q] = yr[base + (long long)(t + T * q) * NA];
    vi[q] = yi[base + (long long)(t + T * q) * NA];
  }
  radix8_passes<S::LB, 0>(vr, vi, t, smem, exchange_plane<S::LB>(), c * B::LD, br, bi, s);
  const long long g = g0 + local;
  const long long l = g / b, j = g - l * b;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const long long k = k1 + (long long)NA * (t + T * q);
    float ur = vr[q] * scale, ui = vi[q] * scale;
    if (wr != nullptr) {
      const long long w = l * wstride + j * N + k;
      const float tr = wr[w], ti = wi[w];
      const float u = ur * tr - ui * ti;
      ui = ur * ti + ui * tr;
      ur = u;
    }
    outr[(l * N + k) * b + j] = ur;
    outi[(l * N + k) * b + j] = ui;
  }
}

int log2_of(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

bool takes(int n) {
  const int k = log2_of(n);
  return (1 << k) == n && k >= kMinLog2 && k <= kMaxLog2;
}

// Pencils a chunk of the fused kernel holds: the scratch's kScratchElems
// elements, never more than the batch.
long long chunk_pencils(int n, long long pencils) {
  const long long per = kScratchElems / n > 0 ? kScratchElems / n : 1;
  return pencils < per ? pencils : per;
}

template <int LOG2N>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(long_column_kernel<LOG2N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         column_smem_floats<LOG2N>() * (int)sizeof(float));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(long_row_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             row_smem_floats<LOG2N>() * (int)sizeof(float));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(long_fused_row_kernel<LOG2N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              row_smem_floats<LOG2N>() * (int)sizeof(float));
}

// Pass 1 on `pencils` pencils from x into y; the CUDA error.
template <int LOG2N>
int run_columns(const float* xr, const float* xi, float* yr, float* yi, const float* ar,
                const float* ai, const float* wr, const float* wi, long long pencils, float s,
                cudaStream_t stream) {
  using S = LongSplit<LOG2N>;
  const long long blocks = pencils * (S::NB / kCols);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  long_column_kernel<LOG2N><<<(unsigned)blocks, kCols * S::NA / 8,
                              column_smem_floats<LOG2N>() * sizeof(float), stream>>>(
      xr, xi, yr, yi, ar, ai, wr, wi, s);
  return (int)cudaGetLastError();
}

template <int LOG2N>
int launch_long(const float* xr, const float* xi, float* yr, float* yi, const float* ar,
                const float* ai, const float* br, const float* bi, const float* wr,
                const float* wi, long long batch, float s, float scale, cudaStream_t stream) {
  using S = LongSplit<LOG2N>;
  cudaError_t err = set_smem<LOG2N>();
  if (err != cudaSuccess) return (int)err;
  int e = run_columns<LOG2N>(xr, xi, yr, yi, ar, ai, wr, wi, batch, s, stream);
  if (e) return e;
  const long long blocks = batch * (S::NA / kCols);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  long_row_kernel<LOG2N><<<(unsigned)blocks, kCols * S::NB / 8,
                           row_smem_floats<LOG2N>() * sizeof(float), stream>>>(
      yr, yi, br, bi, s, scale);
  return (int)cudaGetLastError();
}

template <int LOG2N>
int launch_fused_long(const float* xr, const float* xi, const float* wr, const float* wi,
                      float* outr, float* outi, float* yr, float* yi, const float* ar,
                      const float* ai, const float* br, const float* bi, const float* fr,
                      const float* fi, long long nl, long long b, long long wstride, float s,
                      float scale, cudaStream_t stream) {
  using S = LongSplit<LOG2N>;
  cudaError_t err = set_smem<LOG2N>();
  if (err != cudaSuccess) return (int)err;
  const long long pencils = nl * b;
  const long long chunk = chunk_pencils(S::N, pencils);
  for (long long g0 = 0; g0 < pencils; g0 += chunk) {
    const long long m = pencils - g0 < chunk ? pencils - g0 : chunk;
    int e = run_columns<LOG2N>(xr + g0 * S::N, xi + g0 * S::N, yr, yi, ar, ai, fr, fi, m, s,
                               stream);
    if (e) return e;
    const long long blocks = m * (S::NA / kCols);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    long_fused_row_kernel<LOG2N><<<(unsigned)blocks, kCols * S::NB / 8,
                                   row_smem_floats<LOG2N>() * sizeof(float), stream>>>(
        yr, yi, wr, wi, outr, outi, br, bi, g0, b, wstride, s, scale);
    if ((e = (int)cudaGetLastError())) return e;
  }
  return 0;
}

template <class K>
int occupancy(K kern, int threads, long long smem, int* per_sm, int* regs) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                            (size_t)smem);
}

#define LONG_LENGTHS(X) X(13) X(14) X(15) X(16)

}  // namespace

extern "C" {

// Shared bytes a block of pass 1 (pass = 1) or pass 2 (pass = 2, either
// kernel) takes for pencils of n; -1 where the long body does not take n.
long long long_smem_bytes(int n, int pass) {
  if (!takes(n) || (pass != 1 && pass != 2)) return -1;
  switch (log2_of(n)) {
#define X(L)                                                                   \
  case L:                                                                      \
    return (long long)(pass == 1 ? column_smem_floats<L>() : row_smem_floats<L>()) * \
           (long long)sizeof(float);
    LONG_LENGTHS(X)
#undef X
  }
  return -1;
}

// Threads a block of pass 1 or 2 runs; -1 where the long body does not take n.
int long_threads(int n, int pass) {
  if (!takes(n) || (pass != 1 && pass != 2)) return -1;
  const int la = (log2_of(n) + 1) / 2, lb = log2_of(n) / 2;
  return kCols * (1 << (pass == 1 ? la : lb)) / 8;
}

// Scratch bytes a launch on `pencils` pencils of n needs: two planes of
// one chunk for the fused kernel (fused != 0), none for the others.
long long long_scratch_bytes(int n, long long pencils, int fused) {
  if (!takes(n)) return -1;
  return fused ? 2 * chunk_pencils(n, pencils) * n * (long long)sizeof(float) : 0;
}

// Blocks an SM holds and registers a thread, of pass 1 (pass = 1), pass 2
// (pass = 2) or the fused kernel's pass 2 (pass = 3); the CUDA error, or
// cudaErrorInvalidValue where the long body does not take n.
int long_blocks_per_sm(int n, int pass, int* per_sm, int* regs) {
  if (!takes(n) || pass < 1 || pass > 3) return (int)cudaErrorInvalidValue;
  const long long smem = long_smem_bytes(n, pass == 1 ? 1 : 2);
  const int threads = long_threads(n, pass == 1 ? 1 : 2);
  switch (log2_of(n)) {
#define X(L)                                                                        \
  case L:                                                                           \
    return pass == 1   ? occupancy(long_column_kernel<L>, threads, smem, per_sm, regs) \
           : pass == 2 ? occupancy(long_row_kernel<L>, threads, smem, per_sm, regs)    \
                       : occupancy(long_fused_row_kernel<L>, threads, smem, per_sm, regs);
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
#define X(L)                                                                         \
  case L:                                                                            \
    return launch_long<L>(xr, xi, yr, yi, ar, ai, br, bi, wr, wi, batch, s, scale,   \
                          (cudaStream_t)stream);
    LONG_LENGTHS(X)
#undef X
  }
  return (int)cudaErrorInvalidValue;
}

// fft_twiddle_transpose on rows (nl, b, n) into (nl, n, b): (wr, wi) the
// twiddle planes or null, (yr, yi) a scratch of long_scratch_bytes, the
// tables as fft_long_launch's (the four-step table here (fr, fi)).
int fft_fused_long_launch(const float* xr, const float* xi, const float* wr, const float* wi,
                          float* outr, float* outi, float* yr, float* yi, const float* ar,
                          const float* ai, const float* br, const float* bi, const float* fr,
                          const float* fi, long long nl, long long b, long long wstride, int n,
                          float s, float scale, void* stream) {
  if (!takes(n)) return (int)cudaErrorInvalidValue;
  switch (log2_of(n)) {
#define X(L)                                                                          \
  case L:                                                                             \
    return launch_fused_long<L>(xr, xi, wr, wi, outr, outi, yr, yi, ar, ai, br, bi, fr, \
                                fi, nl, b, wstride, s, scale, (cudaStream_t)stream);
    LONG_LENGTHS(X)
#undef X
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
