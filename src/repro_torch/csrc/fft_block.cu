// Block-complex four-step pencil FFT for Hopper (sm_90a): two bodies, chosen
// by the pencil length alone.
//
// Replaces the TPU kernel fft_block (src/repro/kernels/fft_block.py:49). The
// complex axis is a leading axis of size 2 on the TPU; here the two planes
// come as separate re/im pointers, so a stacked (2, ..., n) tensor passes
// x[0] and x[1] and a planar pair passes itself, neither with a copy. Each
// pencil n = n1 * n2 (n1 >= n2, powers of two) is viewed as a[d, k1, k2] =
// x_d[k1 * n2 + k2]. The output is in natural order; the inverse takes the
// inverse tables and multiplies by 1/n (`scale`).
//
// Bound: by what an FFT needs, memory (16 bytes per element moved, 0.64 ms
// at 512^3). The dense four-step does 8 n (n1 + n2) flop a pencil, 0.77 ms
// at 512^3 at the 67 TFLOP/s fp32 CUDA-core peak: more than the byte bound,
// so only the tensor cores can bring the kernel to it.
//
// block_mma_kernel, for 64 <= n <= 1024: the tensor-core four-step of
// four_step_mma.cuh (3xTF32 mma.sync, cp.async tile loads, persistent
// blocks), which fft_matmul.cu's matmul_mma_kernel runs too;
// block_mma3_kernel, for n = 2048 and 4096, its three-factor form
// 16 * 16 * (n / 256) (four_step_mma3, as matmul_mma3_kernel).
//
// block_kernel, for every other n (2..32, and the lengths above 4096 that
// fit a block), and timed beside the tensor-core body at 2048 and 4096
// (_launch(..., _body='fma')): fp32 FMA on the CUDA cores against the TPU
// kernel's two constants F1b and G (core/fft1d.py:_block_consts_np), of
// whose c = 1 rows, which repeat the c = 0 rows, it reads the c = 0 half.
// It keeps F1b, a tile of P pencils, the step-2 result and (for n <= 512)
// G in shared memory; above that Jc of G's j1-slices are staged at a time
// for each tile. A ragged last tile is masked in block_kernel and
// block_mma_kernel; block_mma3_kernel's tile is one pencil.

#include "four_step_mma.cuh"

namespace {

constexpr long long kMaxSmemBytes = 232448;  // opt-in limit of one block on sm_90

// ---------------------------------------------------------------------------
// block_kernel: fp32 FMA on the CUDA cores
// ---------------------------------------------------------------------------

struct Layout {
  int f1;          // F1b c = 0 half: n1 rows of 2 n1 + 1 floats
  int x;           // input tile, then output tile: 2 planes of P n
  int b;           // step-2 result: 2 planes of P n, [p][k2][j1]
  int g;           // G c = 0 half, transposed: 2 n2 n2 rows of Jc floats
  long long total; // floats
};

__host__ __device__ Layout carve(int n1, int n2, int P, int Jc) {
  const int n = n1 * n2;
  Layout l;
  l.f1 = 0;
  l.x = l.f1 + n1 * (2 * n1 + 1);
  l.b = l.x + 2 * P * n;
  l.g = l.b + 2 * P * n;
  l.total = (long long)l.g + 2LL * n2 * n2 * Jc;
  return l;
}

// Stage G[0, m, j0 + jj, d, l] for jj < Jc into Gs[((m * 2 + d) * n2 + l) * Jc + jj].
__device__ void stage_g(float* Gs, const float* __restrict__ g, int n1, int n2, int Jc,
                        int j0) {
  const int total = 2 * n2 * n2 * Jc;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int jj = i % Jc;
    const int r = i / Jc;  // (m * 2 + d) * n2 + l
    const int l = r % n2;
    const int md = r / n2;
    const int d = md & 1;
    const int m = md >> 1;
    Gs[i] = g[((long long)(m * n1 + j0 + jj) * 2 + d) * n2 + l];
  }
}

__global__ void __launch_bounds__(kThreads)
block_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
             float* __restrict__ yr, float* __restrict__ yi,
             const float* __restrict__ f1b, const float* __restrict__ g,
             long long batch, int n1, int n2, int P, int Jc, float scale) {
  extern __shared__ float smem[];
  const int n = n1 * n2;
  const Layout lay = carve(n1, n2, P, Jc);
  const int fld = 2 * n1 + 1;
  float* F1 = smem + lay.f1;
  float* Xr = smem + lay.x;
  float* Xi = Xr + P * n;
  float* Br = smem + lay.b;
  float* Bi = Br + P * n;
  float* Gs = smem + lay.g;
  const bool resident = Jc == n1;

  // F1b[0, j, d, k] at F1[j * fld + d * n1 + k]
  for (int i = threadIdx.x; i < 2 * n1 * n1; i += blockDim.x) {
    const int j = i / (2 * n1);
    const int dk = i - j * 2 * n1;
    F1[j * fld + dk] = f1b[i];
  }
  if (resident) stage_g(Gs, g, n1, n2, Jc, 0);

  const long long tiles = (batch + P - 1) / P;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * P;
    const int rows = batch - row0 < P ? (int)(batch - row0) : P;
    const long long base = row0 * n;
    const int elems = rows * n;

    for (int i = threadIdx.x; i < elems; i += blockDim.x) {
      Xr[i] = xr[base + i];
      Xi[i] = xi[base + i];
    }
    __syncthreads();

    // step 2: o = (p * n2 + k2) * n1 + j1, j1 fastest
    for (int o = threadIdx.x; o < elems; o += blockDim.x) {
      const int j1 = o % n1;
      const int pk = o / n1;
      const int k2 = pk % n2;
      const int p = pk / n2;
      const float* ar = Xr + p * n + k2;
      const float* ai = Xi + p * n + k2;
      const float* f0 = F1 + j1 * fld;  // F1b[0, j1, 0, :]
      const float* f1 = f0 + n1;        // F1b[0, j1, 1, :]
      float b0 = 0.f, b1 = 0.f;
      for (int k1 = 0; k1 < n1; ++k1) {
        const float a0 = ar[k1 * n2], a1 = ai[k1 * n2];
        const float f00 = f0[k1], f01 = f1[k1];
        b0 += f00 * a0 + f01 * a1;    // F1b[0, j1, 0, k1] a0 + F1b[0, j1, 1, k1] a1
        b1 += f00 * a1 - f01 * a0;    // F1b[1, j1, 0, k1] a0 + F1b[1, j1, 1, k1] a1
      }
      Br[o] = b0;
      Bi[o] = b1;
    }
    __syncthreads();

    // steps 3+4 by chunks of Jc j1-slices: o = (p * n2 + m) * Jc + jj
    for (int j0 = 0; j0 < n1; j0 += Jc) {
      if (!resident) {
        stage_g(Gs, g, n1, n2, Jc, j0);
        __syncthreads();
      }
      const int outs = rows * n2 * Jc;
      for (int o = threadIdx.x; o < outs; o += blockDim.x) {
        const int jj = o % Jc;
        const int pm = o / Jc;
        const int m = pm % n2;
        const int p = pm / n2;
        const int j = j0 + jj;
        const float* br = Br + p * n + j;       // b[0, j, l] at br[l * n1]
        const float* bi = Bi + p * n + j;
        const float* g0 = Gs + (m * 2 * n2) * Jc + jj;  // G[0, m, j, 0, l] at g0[l * Jc]
        const float* g1 = g0 + n2 * Jc;                 // G[0, m, j, 1, l]
        float d0 = 0.f, d1 = 0.f;
        for (int l = 0; l < n2; ++l) {
          const float b0 = br[l * n1], b1 = bi[l * n1];
          const float g00 = g0[l * Jc], g01 = g1[l * Jc];
          d0 += g00 * b0 + g01 * b1;
          d1 += g00 * b1 - g01 * b0;
        }
        Xr[p * n + m * n1 + j] = d0;
        Xi[p * n + m * n1 + j] = d1;
      }
      if (!resident) __syncthreads();
    }
    __syncthreads();

    for (int i = threadIdx.x; i < elems; i += blockDim.x) {
      yr[base + i] = Xr[i] * scale;
      yi[base + i] = Xi[i] * scale;
    }
    __syncthreads();
  }
}

template <int N1, int N2, int U2, int U3>
__global__ void __launch_bounds__(kThreads, 2)
block_mma_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float* __restrict__ fa, const float* __restrict__ fb,
                 const float* __restrict__ w, long long batch, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  four_step_mma<MmaShape<N1, N2, U2, U3>>(smem, xr, xi, yr, yi, fa, fb, w, batch, scale, vec);
}

template <int N1, int N2, int N3, int U12, int U3>
__global__ void __launch_bounds__(kThreads, 2)
block_mma3_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
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
  return block_mma_kernel<N1, N2, U2, U3>;
}
template <int N1, int N2, int N3, int U12, int U3>
auto mma_kernel_of(Mma3Shape<N1, N2, N3, U12, U3>) {
  return block_mma3_kernel<N1, N2, N3, U12, U3>;
}

}  // namespace

extern "C" {

// Shared bytes the fma body needs with P pencils of n1 * n2 and Jc staged G slices.
long long fft_block_smem_bytes(int n1, int n2, int P, int Jc) {
  return carve(n1, n2, P, Jc).total * (long long)sizeof(float);
}

// G slices the fma body stages at a time: all n1 when they fit beside the
// tile, else the largest power of two that does; 0 when not even one fits.
int fft_block_slices(int n1, int n2, int P) {
  for (int Jc = n1; Jc >= 1; Jc >>= 1)
    if (fft_block_smem_bytes(n1, n2, P, Jc) <= kMaxSmemBytes) return Jc;
  return 0;
}

int fft_block_launch(const float* xr, const float* xi, float* yr, float* yi,
                     const float* f1b, const float* g, long long batch, int n1, int n2,
                     int P, int Jc, float scale, void* stream) {
  const long long smem = fft_block_smem_bytes(n1, n2, P, Jc);
  int per_sm = 0, sms = 0;
  cudaError_t err = resident_blocks(block_kernel, smem, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (batch + P - 1) / P;
  const long long slots = (long long)sms * per_sm;
  const long long blocks = tiles < slots ? tiles : slots;
  block_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      xr, xi, yr, yi, f1b, g, batch, n1, n2, P, Jc, scale);
  return (int)cudaGetLastError();
}

// Pencils a tile of the tensor-core body for pencils of n; -1 where it does
// not take n.
int fft_block_mma_pencils(int n) {
  return (int)with_any_mma_shape(n, [](auto s) { return (long long)decltype(s)::P; });
}

// Shared bytes a block of the tensor-core body takes for pencils of n; -1
// where it does not take n.
long long fft_block_mma_smem_bytes(int n) {
  return with_any_mma_shape(n, [](auto s) {
    return (long long)decltype(s)::FLOATS * (long long)sizeof(float);
  });
}

// Blocks an SM holds: of the tensor-core body (mma != 0) for pencils of n,
// else of the fma body with `smem` bytes; the CUDA error, or -1 for a
// length the tensor-core body does not take.
int fft_block_blocks_per_sm(int mma, int n, long long smem, int* out) {
  int sms = 0;
  if (!mma) return (int)resident_blocks(block_kernel, smem, out, &sms);
  return (int)with_any_mma_shape(n, [&](auto s) {
    return (long long)resident_blocks(mma_kernel_of(s),
                                      (long long)decltype(s)::FLOATS * sizeof(float), out, &sms);
  });
}

int fft_block_mma_launch(const float* xr, const float* xi, float* yr, float* yi,
                         const float* fa, const float* fb, const float* w, long long batch,
                         int n, float scale, void* stream) {
  return (int)with_any_mma_shape(n, [&](auto s) {
    return launch_mma<decltype(s)>(mma_kernel_of(s), xr, xi, yr, yi, fa, fb, w, batch, scale,
                                   stream);
  });
}

}  // extern "C"
