// Stockham pencil FFTs for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Two kernels, each in two bodies:
//
//  * fft_pencil replaces the TPU kernel fft_pencil
//    (src/repro/kernels/fft_pencil.py:76): a batch of length-n pencils
//    (planar re/im, n a power of two) is transformed along its last axis.
//  * fft_fused replaces fft_twiddle_transpose
//    (src/repro/kernels/fft_fused.py:58): the same FFT on rows of
//    (nl, b, n), an optional planar twiddle, and a transposed emit,
//    out[l, k, j] = (W * FFT(x))[l, j, k], which feeds the swap directly.
//    The twiddle's leading slices lie `wstride` floats apart: 0 for one
//    (b, n) plane that every slice shares, b * n for one plane a slice.
//
// Bound: memory. Each kernel reads and writes every element once (16
// bytes an element, plus 8 bytes a twiddle entry) against 5 n log2 n
// flop a pencil.
//
// The radix-8 body (radix8_pencil_kernel<log2 n>, radix8_fused_kernel<log2 n>,
// every n = 2..4096) keeps the data in registers. n splits into passes
// of radix 8, the first pass taking the remainder (2 or 4) when log2 n is
// not a multiple of 3: 512 = 8*8*8, 256 = 4*8*8. A pencil has T = n / R0
// threads, R0 = min(8, n), and thread t holds elements t + T*j, j < R0,
// so a warp's load or store covers 32 consecutive floats (runs of T where
// T < 32 puts several pencils in a warp). A pass
// of radix r and span Ns (the product of the radices before it) runs
// R0 / r radix-r DFTs a thread: butterfly t' = t + T*g takes the inputs
// t' + m*n/r, multiplies input m by w_{Ns r}^{km}, k = t' mod Ns, and
// puts output q at (t' / Ns) Ns r + k + q Ns (Stockham's autosort). Between
// passes the tile goes once through shared memory and back, one
// __syncthreads() an exchange, the two buffers taken in turn; the last
// pass's outputs land on t + T*j, the thread's own elements. Inside the
// radix-8 DFT the constants are +-1, +-i and (+-1 +- i)/sqrt(2).
// Exchanges are free of bank conflicts: an index i written by a pass of
// span Ns < 32 is stored at i ^ ((i / (Ns r) mod 32/Ns) * Ns), a
// permutation inside each aligned run of 32 floats, and a pencil of
// fewer than 32 threads pads its row by T floats. The per-pass twiddles
// are one host table of n - 1 entries, w_{Ns r}^{km} at
// (Ns - 1) + (m - 1) Ns + k (kernels/fft_pencil.py:radix8_tables), read
// through the read-only cache; the inverse reads the conjugate table,
// flips the DFT's constants with `s` = -1 and scales by 1/n at the store.
// A block holds P pencils, P * T <= 1024 threads; pencils past the batch
// are masked. The fused kernel stages its (twiddled) tile in shared
// memory, rows of n + 32/P floats, and stores it transposed, P pencils
// fastest: with P = 8 each run is one whole 32-byte sector.
//
// The radix-2 body (stockham_kernel, fused_kernel) is the first port's:
// P = max(1, 2048 / n) pencils a block in shared memory through log2 n
// radix-2 stages, reading the master table w_n^k, k < n/2, at stride
// n / 2^(s+1). It runs the lengths the radix-8 body does not take and
// stays as the yardstick the radix-8 body is timed against.

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// The radix-2 body
// ---------------------------------------------------------------------------

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
                             long long b, long long wstride, int n, int log2n, int P,
                             int ld, long long tiles, float scale) {
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
      const long long w = l * wstride + (j0 + p) * n + k;
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


// ---------------------------------------------------------------------------
// The radix-8 body
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 1024;

// The pass plan of a length-2^LOG2N pencil, all compile-time.
template <int LOG2N>
struct Radix8 {
  static constexpr int N = 1 << LOG2N;
  static constexpr int R0 = N < 8 ? N : 8;                 // values a thread holds
  static constexpr int T = N / R0;                         // threads a pencil
  static constexpr int PASSES = (LOG2N + 2) / 3;
  static constexpr int FIRST = LOG2N % 3 ? 1 << (LOG2N % 3) : 8;
  static constexpr int LD = N + (T < 32 ? T : 0);          // exchange row stride
  __host__ __device__ static constexpr int radix(int pass) { return pass == 0 ? FIRST : 8; }
  __host__ __device__ static constexpr int span(int pass) {
    return pass == 0 ? 1 : FIRST << (3 * (pass - 1));
  }
};

// Where index i, written by a pass of span NS and radix R, lies in an
// exchange row: a permutation inside each aligned run of 32 that puts the
// pass's strided writes on distinct banks.
template <int NS, int R>
__device__ __forceinline__ int swizzle(int i) {
  if constexpr (NS >= 32) {
    return i;
  } else {
    return i ^ (((i / (NS * R)) & (32 / NS - 1)) * NS);
  }
}

// In-place radix-4 DFT of (x0, x1, x2, x3); s = 1 forward, -1 inverse.
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1, float& i1,
                                     float& r2, float& i2, float& r3, float& i3, float s) {
  const float a0r = r0 + r2, a0i = i0 + i2, a1r = r0 - r2, a1i = i0 - i2;
  const float a2r = r1 + r3, a2i = i1 + i3, dr = r1 - r3, di = i1 - i3;
  const float a3r = s * di, a3i = -s * dr;  // (x1 - x3) * (-i s)
  r0 = a0r + a2r; i0 = a0i + a2i;
  r1 = a1r + a3r; i1 = a1i + a3i;
  r2 = a0r - a2r; i2 = a0i - a2i;
  r3 = a1r - a3r; i3 = a1i - a3i;
}

// In-place radix-R DFT of (re[m], im[m]), m < R, natural order out.
template <int R>
__device__ __forceinline__ void dft(float (&re)[R], float (&im)[R], float s) {
  if constexpr (R == 2) {
    const float tr = re[0] - re[1], ti = im[0] - im[1];
    re[0] += re[1]; im[0] += im[1];
    re[1] = tr; im[1] = ti;
  } else if constexpr (R == 4) {
    dft4(re[0], im[0], re[1], im[1], re[2], im[2], re[3], im[3], s);
  } else {
    static_assert(R == 8, "radix 2, 4 or 8");
    constexpr float c = 0.70710678118654752f;  // 1/sqrt(2)
    dft4(re[0], im[0], re[2], im[2], re[4], im[4], re[6], im[6], s);  // E
    dft4(re[1], im[1], re[3], im[3], re[5], im[5], re[7], im[7], s);  // O
    float x = re[3], y = im[3];                  // O1 *= (1 - i s)/sqrt(2)
    re[3] = (x + s * y) * c; im[3] = (y - s * x) * c;
    x = re[5]; y = im[5];                        // O2 *= -i s
    re[5] = s * y; im[5] = -s * x;
    x = re[7]; y = im[7];                        // O3 *= (-1 - i s)/sqrt(2)
    re[7] = (s * y - x) * c; im[7] = (-s * x - y) * c;
    float orr[8], oi[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      orr[q] = re[2 * q] + re[2 * q + 1]; oi[q] = im[2 * q] + im[2 * q + 1];
      orr[q + 4] = re[2 * q] - re[2 * q + 1]; oi[q + 4] = im[2 * q] - im[2 * q + 1];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) { re[q] = orr[q]; im[q] = oi[q]; }
  }
}

// Pass PASS and every pass after it on the thread's R0 values. `buf` holds
// two exchange buffers of `plane` floats a plane (re, then im); `row` is
// the pencil's offset in a plane.
template <int LOG2N, int PASS>
__device__ __forceinline__ void radix8_passes(float (&vr)[Radix8<LOG2N>::R0],
                                              float (&vi)[Radix8<LOG2N>::R0], int t,
                                              float* buf, int plane, int row,
                                              const float* __restrict__ twr,
                                              const float* __restrict__ twi, float s) {
  using L = Radix8<LOG2N>;
  constexpr int R = L::radix(PASS), NS = L::span(PASS), G = L::R0 / R, T = L::T;
  if constexpr (PASS > 0) {
    constexpr int PR = L::radix(PASS - 1), PNS = L::span(PASS - 1);
    const float* br = buf + ((PASS - 1) % 2) * 2 * plane + row;
    const float* bi = br + plane;
#pragma unroll
    for (int j = 0; j < L::R0; ++j) {
      const int a = swizzle<PNS, PR>(t + T * j);
      vr[j] = br[a];
      vi[j] = bi[a];
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
    float* br = buf + (PASS % 2) * 2 * plane + row;
    float* bi = br + plane;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int tp = t + T * g;
      const int base = (tp / NS) * NS * R + (tp & (NS - 1));
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int a = swizzle<NS, R>(base + q * NS);
        br[a] = vr[g + G * q];
        bi[a] = vi[g + G * q];
      }
    }
    __syncthreads();
    radix8_passes<LOG2N, PASS + 1>(vr, vi, t, buf, plane, row, twr, twi, s);
  }
}

// Floats a plane of one shared buffer: P rows of the exchange stride, or
// of the fused kernel's staging stride n + 32/P where that is wider.
__host__ __device__ constexpr int radix8_plane(int n, int P, bool fused) {
  const int T = n < 8 ? 1 : n / 8;
  const int ld = n + (T < 32 ? T : 0);
  const int lds = n + 32 / P;
  return P * (fused && lds > ld ? lds : ld);
}

// Shared buffers a launch takes: one per exchange, two at most, and the
// fused kernel's staging buffer (the one the last exchange did not read).
__host__ __device__ constexpr int radix8_buffers(int log2n, bool fused) {
  const int exchanges = (log2n + 2) / 3 - 1 + (fused ? 1 : 0);
  return exchanges < 2 ? exchanges : 2;
}

template <int LOG2N>
__global__ void __launch_bounds__(kMaxThreads)
radix8_pencil_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     float* __restrict__ yr, float* __restrict__ yi,
                     const float* __restrict__ twr, const float* __restrict__ twi,
                     long long batch, int P, float s, float scale) {
  using L = Radix8<LOG2N>;
  extern __shared__ float smem[];
  const int t = threadIdx.x & (L::T - 1);
  const int p = threadIdx.x / L::T;
  const long long pencil = (long long)blockIdx.x * P + p;
  const bool live = pencil < batch;
  const long long base = pencil * L::N + t;
  float vr[L::R0], vi[L::R0];
#pragma unroll
  for (int j = 0; j < L::R0; ++j) {
    vr[j] = live ? xr[base + L::T * j] : 0.f;
    vi[j] = live ? xi[base + L::T * j] : 0.f;
  }
  radix8_passes<LOG2N, 0>(vr, vi, t, smem, radix8_plane(L::N, P, false), p * L::LD,
                          twr, twi, s);
  if (live) {
#pragma unroll
    for (int j = 0; j < L::R0; ++j) {
      yr[base + L::T * j] = vr[j] * scale;
      yi[base + L::T * j] = vi[j] * scale;
    }
  }
}

template <int LOG2N>
__global__ void __launch_bounds__(kMaxThreads)
radix8_fused_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ wr, const float* __restrict__ wi,
                    float* __restrict__ yr, float* __restrict__ yi,
                    const float* __restrict__ twr, const float* __restrict__ twi,
                    long long b, long long wstride, int P, int log2P, long long tiles,
                    float s, float scale) {
  using L = Radix8<LOG2N>;
  constexpr int N = L::N, T = L::T;
  extern __shared__ float smem[];
  const int t = threadIdx.x & (T - 1);
  const int p = threadIdx.x / T;
  const long long l = blockIdx.x / tiles;
  const long long j0 = (blockIdx.x - l * tiles) * P;
  const int rows = b - j0 < P ? (int)(b - j0) : P;
  const bool live = p < rows;
  const long long in = (l * b + j0 + p) * N + t;
  float vr[L::R0], vi[L::R0];
#pragma unroll
  for (int j = 0; j < L::R0; ++j) {
    vr[j] = live ? xr[in + T * j] : 0.f;
    vi[j] = live ? xi[in + T * j] : 0.f;
  }
  const int plane = radix8_plane(N, P, true);
  radix8_passes<LOG2N, 0>(vr, vi, t, smem, plane, p * L::LD, twr, twi, s);
  // scale, twiddle in the pre-transpose layout (coalesced along k), stage
  float* sr = smem + ((L::PASSES - 1) % 2) * 2 * plane;
  float* si = sr + plane;
  const int lds = N + 32 / P;
#pragma unroll
  for (int j = 0; j < L::R0; ++j) {
    float ur = vr[j] * scale, ui = vi[j] * scale;
    if (wr != nullptr && live) {
      const long long w = l * wstride + (j0 + p) * N + t + T * j;
      const float tr = wr[w], ti = wi[w];
      const float u = ur * tr - ui * ti;
      ui = ur * ti + ui * tr;
      ur = u;
    }
    sr[p * lds + t + T * j] = ur;
    si[p * lds + t + T * j] = ui;
  }
  __syncthreads();
  // transposed emit: out[l, k, j0 + q], q fastest, runs of P floats
  const long long out = l * N * b + j0;
  for (int i = threadIdx.x; i < P * N; i += blockDim.x) {
    const int k = i >> log2P;
    const int q = i & (P - 1);
    if (q < rows) {
      yr[out + (long long)k * b + q] = sr[q * lds + k];
      yi[out + (long long)k * b + q] = si[q * lds + k];
    }
  }
}

#define RADIX8_LENGTHS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)

template <int LOG2N>
int launch_radix8_pencil(const float* xr, const float* xi, float* yr, float* yi,
                         const float* twr, const float* twi, long long batch, int P,
                         long long smem, float s, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      radix8_pencil_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (batch + P - 1) / P;
  radix8_pencil_kernel<LOG2N><<<(unsigned)blocks, P * Radix8<LOG2N>::T, (size_t)smem,
                                stream>>>(xr, xi, yr, yi, twr, twi, batch, P, s, scale);
  return (int)cudaGetLastError();
}

template <int LOG2N>
int launch_radix8_fused(const float* xr, const float* xi, const float* wr, const float* wi,
                        float* yr, float* yi, const float* twr, const float* twi,
                        long long nl, long long b, long long wstride, int P,
                        long long smem, float s, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      radix8_fused_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int log2P = 0;
  while ((1 << log2P) < P) ++log2P;
  const long long tiles = (b + P - 1) / P;
  radix8_fused_kernel<LOG2N><<<(unsigned)(nl * tiles), P * Radix8<LOG2N>::T, (size_t)smem,
                               stream>>>(xr, xi, wr, wi, yr, yi, twr, twi, b, wstride, P,
                                         log2P, tiles, s, scale);
  return (int)cudaGetLastError();
}

// Whether the radix-8 body takes a launch of P pencils of n: n = 2..4096,
// P a power of two (at most 32 for the fused kernel's staging rows), at
// most 1024 threads a block.
bool radix8_takes(int n, int P, bool fused) {
  const int log2n = log2_of(n);
  return (1 << log2n) == n && log2n >= 1 && log2n <= 12 && P >= 1 && (P & (P - 1)) == 0 &&
         (!fused || P <= 32) && P * (n < 8 ? 1 : n / 8) <= kMaxThreads;
}

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
                     long long nl, long long b, long long wstride, int n, int P, int ld,
                     float scale, void* stream) {
  const long long tiles = (b + P - 1) / P;
  const long long smem = stockham_smem_bytes(n, P, ld);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_kernel<<<(unsigned)(nl * tiles), kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      xr, xi, wr, wi, yr, yi, twr, twi, b, wstride, n, log2_of(n), P, ld, tiles, scale);
  return (int)cudaGetLastError();
}

// Shared bytes a radix-8 launch with P pencils of length n takes.
long long radix8_smem_bytes(int n, int P, int fused) {
  return (long long)radix8_buffers(log2_of(n), fused != 0) * 2 *
         radix8_plane(n, P, fused != 0) * (long long)sizeof(float);
}

int fft_pencil_radix8_launch(const float* xr, const float* xi, float* yr, float* yi,
                             const float* twr, const float* twi, long long batch, int n,
                             int P, float s, float scale, void* stream) {
  if (!radix8_takes(n, P, false)) return (int)cudaErrorInvalidValue;
  const long long smem = radix8_smem_bytes(n, P, 0);
  switch (log2_of(n)) {
#define X(L)                                                                         \
  case L:                                                                            \
    return launch_radix8_pencil<L>(xr, xi, yr, yi, twr, twi, batch, P, smem, s, scale, \
                                   (cudaStream_t)stream);
    RADIX8_LENGTHS(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int fft_fused_radix8_launch(const float* xr, const float* xi, const float* wr,
                            const float* wi, float* yr, float* yi, const float* twr,
                            const float* twi, long long nl, long long b, long long wstride,
                            int n, int P, float s, float scale, void* stream) {
  if (!radix8_takes(n, P, true)) return (int)cudaErrorInvalidValue;
  const long long smem = radix8_smem_bytes(n, P, 1);
  switch (log2_of(n)) {
#define X(L)                                                                         \
  case L:                                                                            \
    return launch_radix8_fused<L>(xr, xi, wr, wi, yr, yi, twr, twi, nl, b, wstride, P, smem, \
                                  s, scale, (cudaStream_t)stream);
    RADIX8_LENGTHS(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
