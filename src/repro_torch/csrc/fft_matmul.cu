// Bailey four-step pencil FFT for Hopper (sm_90a): two bodies, chosen by the
// pencil length alone (and the long body of fft_long.cu above 4096).
//
// Replaces the TPU kernel fft_matmul (src/repro/kernels/fft_matmul.py:71).
// Each length-n pencil (n = n1 * n2, n1 >= n2, powers of two) is viewed as
// A[k1, k2] = x[k1 * n2 + k2] and transformed as
//   B = F1 . A           (DFT over k1, F1[j1, k1] = w_n1^(j1 k1))
//   C = B * W            (W[j1, k2] = w_n^(j1 k2))
//   D = C . F2           (DFT over k2, F2[k2, j2] = w_n2^(k2 j2))
//   y[j2 * n1 + j1] = D[j1, j2]
// with planar complex arithmetic and fp32 accumulation. The DFT products are
// computed here, in the kernel body, not by a library GEMM. The inverse uses
// the conjugate tables and multiplies by 1/n (`scale`), exact for pow2 n.
//
// Bound: by what an FFT needs, memory (16 bytes per element moved, 0.64 ms
// at 512^3). The dense products do 8 n (n1 + n2) flop a pencil (98,304
// multiply-adds at n = 512), 0.77 ms at 512^3 at the 67 TFLOP/s fp32
// CUDA-core peak: only the tensor cores can bring the kernel to its bound.
//
// matmul_mma_kernel, for 64 <= n <= 1024: the tensor-core four-step of
// four_step_mma.cuh (3xTF32 mma.sync, cp.async tile loads, persistent
// blocks), which fft_block.cu's block_mma_kernel runs too. The TPU kernel's
// four real GEMMs per complex product, F1r Ar - F1i Ai and F1r Ai + F1i Ar,
// are the rows of the block product [[F1r, -F1i], [F1i, F1r]] [Ar; Ai], and
// C F2 is C times the block [[F2r, F2i], [-F2i, F2r]]: the same numbers as
// fft_block's tables, so the host passes those (kernels/fft_matmul.py).
// matmul_mma3_kernel, for n = 2048 and 4096: the same products over three
// factors 16 * 16 * (n / 256) (four_step_mma3, as block_mma3_kernel).
//
// four_step_kernel, for n = 2..32 (above 4096 it needs more shared memory
// than a block has; those lengths run fft_long.cu's two-pass body): fp32
// FMA on the CUDA cores, and the
// body _launch(..., _body='fma') times beside the tensor-core one at 2048
// and 4096. A block keeps everything it needs in shared memory: the three
// tables, a tile of P pencils and the twiddled intermediate C. Device memory
// is read once and written once. Step 2 walks k2 fastest (A reads
// contiguous, F1 reads broadcast); step 4 walks j1 fastest, so the
// natural-order output is stored contiguously and the C rows (stride
// n2 + 1) and F2 reads hit distinct banks. F1 rows are padded to n1 + 1 for
// the same reason.

#include "four_step_mma.cuh"

namespace {

struct Layout {
  int f1, f2, w, x, c;  // float offsets of each region (re; im follows)
  long long total;      // floats
};

__host__ __device__ Layout carve(int n1, int n2, int P) {
  const int n = n1 * n2;
  Layout l;
  l.f1 = 0;
  l.f2 = l.f1 + 2 * n1 * (n1 + 1);
  l.w = l.f2 + 2 * n2 * n2;
  l.x = l.w + 2 * n1 * n2;
  l.c = l.x + 2 * P * n;
  l.total = (long long)l.c + 2LL * P * n1 * (n2 + 1);
  return l;
}

__global__ void four_step_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                                 float* __restrict__ yr, float* __restrict__ yi,
                                 const float* __restrict__ f1r, const float* __restrict__ f1i,
                                 const float* __restrict__ f2r, const float* __restrict__ f2i,
                                 const float* __restrict__ twr, const float* __restrict__ twi,
                                 long long batch, int n1, int n2, int P, float scale) {
  extern __shared__ float smem[];
  const int n = n1 * n2;
  const Layout lay = carve(n1, n2, P);
  float* F1r = smem + lay.f1;
  float* F1i = F1r + n1 * (n1 + 1);
  float* F2r = smem + lay.f2;
  float* F2i = F2r + n2 * n2;
  float* Wr = smem + lay.w;
  float* Wi = Wr + n1 * n2;
  float* Xr = smem + lay.x;
  float* Xi = Xr + P * n;
  float* Cr = smem + lay.c;
  float* Ci = Cr + P * n1 * (n2 + 1);
  const int cld = n2 + 1;          // C row stride
  const int cpl = n1 * cld;        // C pencil stride

  const long long row0 = (long long)blockIdx.x * P;
  const int rows = batch - row0 < P ? (int)(batch - row0) : P;
  const long long base = row0 * n;

  for (int i = threadIdx.x; i < n1 * n1; i += blockDim.x) {
    const int j = i / n1, k = i - j * n1;
    F1r[j * (n1 + 1) + k] = f1r[i];
    F1i[j * (n1 + 1) + k] = f1i[i];
  }
  for (int i = threadIdx.x; i < n2 * n2; i += blockDim.x) {
    F2r[i] = f2r[i];
    F2i[i] = f2i[i];
  }
  for (int i = threadIdx.x; i < n1 * n2; i += blockDim.x) {
    Wr[i] = twr[i];
    Wi[i] = twi[i];
  }
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    Xr[i] = xr[base + i];
    Xi[i] = xi[base + i];
  }
  __syncthreads();

  // steps 2 + 3: C[p, j1, k2] = W[j1, k2] * sum_k1 F1[j1, k1] A[p, k1, k2]
  for (int o = threadIdx.x; o < rows * n; o += blockDim.x) {
    const int p = o / n;
    const int r = o - p * n;
    const int j1 = r / n2;
    const int k2 = r - j1 * n2;
    const float* ar = Xr + p * n + k2;
    const float* ai = Xi + p * n + k2;
    const float* fr = F1r + j1 * (n1 + 1);
    const float* fi = F1i + j1 * (n1 + 1);
    float br = 0.f, bi = 0.f;
    for (int k1 = 0; k1 < n1; ++k1) {
      const float xr_ = ar[k1 * n2], xi_ = ai[k1 * n2];
      br += fr[k1] * xr_ - fi[k1] * xi_;
      bi += fr[k1] * xi_ + fi[k1] * xr_;
    }
    const float wr = Wr[r], wi = Wi[r];
    Cr[p * cpl + j1 * cld + k2] = br * wr - bi * wi;
    Ci[p * cpl + j1 * cld + k2] = br * wi + bi * wr;
  }
  __syncthreads();

  // steps 4 + 5: y[p, j2 * n1 + j1] = sum_k2 C[p, j1, k2] F2[k2, j2]
  for (int o = threadIdx.x; o < rows * n; o += blockDim.x) {
    const int p = o / n;
    const int r = o - p * n;
    const int j2 = r / n1;
    const int j1 = r - j2 * n1;
    const float* cr = Cr + p * cpl + j1 * cld;
    const float* ci = Ci + p * cpl + j1 * cld;
    float dr = 0.f, di = 0.f;
    for (int k2 = 0; k2 < n2; ++k2) {
      const float fr = F2r[k2 * n2 + j2], fi = F2i[k2 * n2 + j2];
      dr += cr[k2] * fr - ci[k2] * fi;
      di += cr[k2] * fi + ci[k2] * fr;
    }
    yr[base + o] = dr * scale;
    yi[base + o] = di * scale;
  }
}

template <int N1, int N2, int U2, int U3>
__global__ void __launch_bounds__(kThreads, 2)
matmul_mma_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi,
                  const float* __restrict__ fa, const float* __restrict__ fb,
                  const float* __restrict__ w, long long batch, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  four_step_mma<MmaShape<N1, N2, U2, U3>>(smem, xr, xi, yr, yi, fa, fb, w, batch, scale, vec);
}

template <int N1, int N2, int N3, int U12, int U3>
__global__ void __launch_bounds__(kThreads, 2)
matmul_mma3_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ yr, float* __restrict__ yi,
                   const float* __restrict__ fa, const float* __restrict__ fb,
                   const float* __restrict__ w, long long batch, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  four_step_mma3<Mma3Shape<N1, N2, N3, U12, U3>>(smem, xr, xi, yr, yi, fa, fb, w, batch, scale,
                                                 vec);
}

// The kernel of this file that runs the tensor-core shape S.
template <int N1, int N2, int U2, int U3>
auto mma_kernel_of(MmaShape<N1, N2, U2, U3>) {
  return matmul_mma_kernel<N1, N2, U2, U3>;
}
template <int N1, int N2, int N3, int U12, int U3>
auto mma_kernel_of(Mma3Shape<N1, N2, N3, U12, U3>) {
  return matmul_mma3_kernel<N1, N2, N3, U12, U3>;
}

// Registers a thread and blocks an SM of `kern` with `smem` dynamic bytes.
template <class K>
cudaError_t occupancy(K kern, long long smem, int* per_sm, int* regs) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  int sms = 0;
  return resident_blocks(kern, smem, per_sm, &sms);
}

}  // namespace

extern "C" {

// Shared bytes a launch with P pencils of n1 * n2 needs.
long long four_step_smem_bytes(int n1, int n2, int P) {
  return carve(n1, n2, P).total * (long long)sizeof(float);
}

int fft_matmul_launch(const float* xr, const float* xi, float* yr, float* yi,
                      const float* f1r, const float* f1i, const float* f2r,
                      const float* f2i, const float* twr, const float* twi,
                      long long batch, int n1, int n2, int P, float scale,
                      void* stream) {
  const long long blocks = (batch + P - 1) / P;
  const long long smem = four_step_smem_bytes(n1, n2, P);
  cudaError_t err = cudaFuncSetAttribute(
      four_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  four_step_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, f1r, f1i, f2r, f2i, twr, twi, batch, n1, n2, P, scale);
  return (int)cudaGetLastError();
}

// Pencils a tile of the tensor-core body for pencils of n; -1 where it does
// not take n.
int fft_matmul_mma_pencils(int n) {
  return (int)with_any_mma_shape(n, [](auto s) { return (long long)decltype(s)::P; });
}

// Shared bytes a block of the tensor-core body takes for pencils of n; -1
// where it does not take n.
long long fft_matmul_mma_smem_bytes(int n) {
  return with_any_mma_shape(n, [](auto s) {
    return (long long)decltype(s)::FLOATS * (long long)sizeof(float);
  });
}

// Blocks an SM holds and registers a thread: of the tensor-core body (mma !=
// 0) for pencils of n, else of four_step_kernel with `smem` bytes; the CUDA
// error, or -1 for a length the tensor-core body does not take.
int fft_matmul_blocks_per_sm(int mma, int n, long long smem, int* per_sm, int* regs) {
  if (!mma) return (int)occupancy(four_step_kernel, smem, per_sm, regs);
  return (int)with_any_mma_shape(n, [&](auto s) {
    return (long long)occupancy(mma_kernel_of(s),
                                (long long)decltype(s)::FLOATS * sizeof(float), per_sm, regs);
  });
}

int fft_matmul_mma_launch(const float* xr, const float* xi, float* yr, float* yi,
                          const float* fa, const float* fb, const float* w, long long batch,
                          int n, float scale, void* stream) {
  return (int)with_any_mma_shape(n, [&](auto s) {
    return launch_mma<decltype(s)>(mma_kernel_of(s), xr, xi, yr, yi, fa, fb, w, batch, scale,
                                   stream);
  });
}

}  // extern "C"
