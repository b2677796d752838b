// Radix-2 Stockham pencil FFTs for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Two kernels share one device function:
//
//  * stockham_kernel replaces the TPU kernel fft_pencil
//    (src/repro/kernels/fft_pencil.py:76): a batch of length-n pencils
//    (planar re/im, n a power of two) is transformed along its last axis.
//  * fused_kernel replaces fft_twiddle_transpose
//    (src/repro/kernels/fft_fused.py:58): the same FFT on rows of
//    (nl, b, n), an optional planar twiddle, and a transposed emit,
//    out[l, k, j] = (W * FFT(x))[l, j, k], which feeds the swap directly.
//
// Bound: memory. One pass reads and writes every element once
// (5 n log2 n flop per pencil against 16 bytes per element), so both
// kernels keep a tile of P pencils in shared memory for all log2(n)
// stages and touch device memory only to load the tile and to store it.
// The stages ping-pong between two shared buffers. A block takes
// P = max(1, 2048 / n) pencils; a ragged last tile is masked, not padded.
// The fused kernel pads each shared row (row stride n + pad) so that the
// transposed read-out, which walks the P pencils fastest, hits distinct
// banks; its global stores are then runs of P contiguous floats.
//
// The twiddle table is the master table w_n^k, k < n/2, for the requested
// direction (the inverse table for the inverse, as the TPU kernel's host
// table); stage s reads it at stride n / 2^(s+1). The inverse multiplies
// by 1/n at the end (`scale`).

#include <cuda_runtime.h>

namespace {

// Runs every stage on `rows` pencils held at rows*ld in (a_re, a_im); the
// result lands in whichever buffer pair the last stage wrote, returned
// through (out_re, out_im).
__device__ void stockham_tile(float* a_re, float* a_im, float* b_re, float* b_im,
                              const float* tw_re, const float* tw_im,
                              int n, int log2n, int ld, int rows,
                              float** out_re, float** out_im) {
  const int half = n >> 1;
  const int total = rows * half;
  for (int s = 0; s < log2n; ++s) {
    const int L = 1 << s;
    const int stride = half >> s;  // n / (2L)
    for (int q = threadIdx.x; q < total; q += blockDim.x) {
      const int p = q / half;
      const int r = q - p * half;  // butterfly index within the pencil
      const int j = r & (L - 1);
      const float* xr = a_re + p * ld;
      const float* xi = a_im + p * ld;
      float* yr = b_re + p * ld;
      float* yi = b_im + p * ld;
      const float ar = xr[r], ai = xi[r];
      const float br = xr[r + half], bi = xi[r + half];
      const float wr = tw_re[j * stride], wi = tw_im[j * stride];
      const float tr = br * wr - bi * wi;
      const float ti = br * wi + bi * wr;
      const int o = 2 * r - j;  // k * 2L + j with k = r / L
      yr[o] = ar + tr;
      yi[o] = ai + ti;
      yr[o + L] = ar - tr;
      yi[o + L] = ai - ti;
    }
    __syncthreads();
    float* t;
    t = a_re; a_re = b_re; b_re = t;
    t = a_im; a_im = b_im; b_im = t;
  }
  *out_re = a_re;
  *out_im = a_im;
}

// Shared layout: table (2 * half), then two buffer pairs of P * ld floats.
__device__ void carve(float* smem, int n, int P, int ld, float** tw_re, float** tw_im,
                      float** a_re, float** a_im, float** b_re, float** b_im) {
  const int half = n > 1 ? n >> 1 : 1;
  *tw_re = smem;
  *tw_im = smem + half;
  *a_re = smem + 2 * half;
  *a_im = *a_re + P * ld;
  *b_re = *a_im + P * ld;
  *b_im = *b_re + P * ld;
}

// Loads the table and `rows` contiguous pencils starting at src.
__device__ void load_tile(const float* __restrict__ xr, const float* __restrict__ xi,
                          const float* __restrict__ twr, const float* __restrict__ twi,
                          float* tw_re, float* tw_im, float* a_re, float* a_im,
                          int n, int ld, int rows) {
  for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
    tw_re[i] = twr[i];
    tw_im[i] = twi[i];
  }
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    const int p = i / n;
    const int k = i - p * n;
    a_re[p * ld + k] = xr[i];
    a_im[p * ld + k] = xi[i];
  }
  __syncthreads();
}

__global__ void stockham_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                                float* __restrict__ yr, float* __restrict__ yi,
                                const float* __restrict__ twr, const float* __restrict__ twi,
                                long long batch, int n, int log2n, int P, float scale) {
  extern __shared__ float smem[];
  float *tw_re, *tw_im, *a_re, *a_im, *b_re, *b_im;
  carve(smem, n, P, n, &tw_re, &tw_im, &a_re, &a_im, &b_re, &b_im);
  const long long row0 = (long long)blockIdx.x * P;
  const int rows = batch - row0 < P ? (int)(batch - row0) : P;
  const long long base = row0 * n;
  load_tile(xr + base, xi + base, twr, twi, tw_re, tw_im, a_re, a_im, n, n, rows);
  float *res_re, *res_im;
  stockham_tile(a_re, a_im, b_re, b_im, tw_re, tw_im, n, log2n, n, rows, &res_re, &res_im);
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    yr[base + i] = res_re[i] * scale;
    yi[base + i] = res_im[i] * scale;
  }
}

__global__ void fused_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                             const float* __restrict__ wr, const float* __restrict__ wi,
                             float* __restrict__ yr, float* __restrict__ yi,
                             const float* __restrict__ twr, const float* __restrict__ twi,
                             long long b, int n, int log2n, int P, int ld,
                             long long tiles, float scale) {
  extern __shared__ float smem[];
  float *tw_re, *tw_im, *a_re, *a_im, *b_re, *b_im;
  carve(smem, n, P, ld, &tw_re, &tw_im, &a_re, &a_im, &b_re, &b_im);
  const long long l = blockIdx.x / tiles;
  const long long j0 = (blockIdx.x - l * tiles) * P;
  const int rows = b - j0 < P ? (int)(b - j0) : P;
  const long long in_base = (l * b + j0) * n;
  load_tile(xr + in_base, xi + in_base, twr, twi, tw_re, tw_im, a_re, a_im, n, ld, rows);
  float *res_re, *res_im;
  stockham_tile(a_re, a_im, b_re, b_im, tw_re, tw_im, n, log2n, ld, rows, &res_re, &res_im);
  // transposed emit: out[l, k, j0 + p], p fastest
  const long long out_base = l * n * b + j0;
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    const int k = i / rows;
    const int p = i - k * rows;
    float vr = res_re[p * ld + k] * scale;
    float vi = res_im[p * ld + k] * scale;
    if (wr != nullptr) {
      const long long w = in_base + (long long)p * n + k;
      const float tr = wr[w], ti = wi[w];
      const float ur = vr * tr - vi * ti;
      vi = vr * ti + vi * tr;
      vr = ur;
    }
    yr[out_base + (long long)k * b + p] = vr;
    yi[out_base + (long long)k * b + p] = vi;
  }
}

int log2_of(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// Shared bytes a launch with P pencils of length n and row stride ld needs.
long long stockham_smem_bytes(int n, int P, int ld) {
  const long long half = n > 1 ? n >> 1 : 1;
  return (2 * half + 4LL * P * ld) * (long long)sizeof(float);
}

int fft_pencil_launch(const float* xr, const float* xi, float* yr, float* yi,
                      const float* twr, const float* twi, long long batch, int n,
                      int P, float scale, void* stream) {
  const long long blocks = (batch + P - 1) / P;
  const long long smem = stockham_smem_bytes(n, P, n);
  cudaError_t err = cudaFuncSetAttribute(
      stockham_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stockham_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, twr, twi, batch, n, log2_of(n), P, scale);
  return (int)cudaGetLastError();
}

int fft_fused_launch(const float* xr, const float* xi, const float* wr, const float* wi,
                     float* yr, float* yi, const float* twr, const float* twi,
                     long long nl, long long b, int n, int P, int ld, float scale,
                     void* stream) {
  const long long tiles = (b + P - 1) / P;
  const long long smem = stockham_smem_bytes(n, P, ld);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_kernel<<<(unsigned)(nl * tiles), kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      xr, xi, wr, wi, yr, yi, twr, twi, b, n, log2_of(n), P, ld, tiles, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
