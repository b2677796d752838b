// The radix-8 register passes of a power-of-two pencil, shared by the
// radix-8 Stockham body (fft_pencil.cu) and the long body (fft_long.cu),
// which runs them as its sub-FFTs. fft_pencil.cu's head describes them:
// thread t of a pencil of T = n / R0 threads holds elements t + T*j,
// j < R0; every pass but the last ends in one exchange through shared
// memory at swizzled addresses; the last leaves output t + T*j in the
// thread's value j. The caller loads the values, calls
// radix8_passes<LOG2N, 0>, and stores or stages them.
#pragma once

#include <cuda_runtime.h>

namespace {

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

}  // namespace
