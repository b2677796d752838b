"""Local (single-device) pencil FFTs, planar complex, batched: the plain
PyTorch versions.

Port of ``repro.core.fft1d``. Every function maps over arbitrary
leading batch dims and transforms the trailing axis. These are the
'reference' tier of the method registry and the CPU path of every
kernel wrapper; the CUDA kernels under ``repro_torch.kernels`` compute
the same functions.

* ``fft_stockham`` — radix-2 Stockham autosort (the paper-faithful
  pencil), the same stage order and twiddles as the reference.
* ``fft_four_step`` — Bailey four-step as planar matmuls against DFT
  matrices. It runs in full fp32 (the reference uses
  ``Precision.HIGHEST``): on a CUDA tensor it sets
  ``torch.backends.cuda.matmul.allow_tf32 = False`` before its
  products, so no TF32 rounding enters.
"""
from __future__ import annotations

import functools
import torch

from repro_torch.core import twiddle as tw
from repro_torch.core.twiddle import Planar


@functools.lru_cache(maxsize=None)
def _stage_tables(n: int, inverse: bool, device: torch.device):
    return tuple((tw.table(r, device), tw.table(i, device))
                 for r, i in tw.stage_twiddles_np(n, inverse=inverse))


@functools.lru_cache(maxsize=None)
def four_step_tables(n1: int, n2: int, inverse: bool, device: torch.device):
    f1 = tuple(tw.table(a, device) for a in tw.dft_matrix_np(n1, inverse=inverse))
    f2 = tuple(tw.table(a, device) for a in tw.dft_matrix_np(n2, inverse=inverse))
    w = tuple(tw.table(a, device)
              for a in tw.four_step_twiddle_np(n1, n2, inverse=inverse))
    return f1, f2, w


def full_fp32_matmul(device: torch.device) -> None:
    """Keep float32 products at full precision on CUDA (no TF32)."""
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# Stockham radix-2 (paper-faithful)
# ---------------------------------------------------------------------------

def fft_stockham(re: torch.Tensor, im: torch.Tensor, *,
                 inverse: bool = False) -> Planar:
    """Batched radix-2 Stockham FFT along the last axis.

    After the stage with subproblem size L the array viewed as (c, L)
    rows holds X[k, :] = DFT_L(x[k::c]), c = n / L; natural order in,
    natural order out."""
    n = re.shape[-1]
    stages = tw.log2i(n)
    batch = tuple(re.shape[:-1])
    twids = _stage_tables(n, inverse, re.device)
    for s in range(stages):
        L = 1 << s
        c = n >> s
        wr, wi = twids[s]
        xr = re.reshape(batch + (2, c // 2, L))
        xi = im.reshape(batch + (2, c // 2, L))
        ar, ai = xr[..., 0, :, :], xi[..., 0, :, :]
        br, bi = xr[..., 1, :, :], xi[..., 1, :, :]
        tr, ti = tw.cmul(br, bi, wr, wi)
        re = torch.cat([ar + tr, ar - tr], dim=-1).reshape(batch + (n,))
        im = torch.cat([ai + ti, ai - ti], dim=-1).reshape(batch + (n,))
    if inverse:
        re, im = re * (1.0 / n), im * (1.0 / n)
    return re, im


# ---------------------------------------------------------------------------
# Bailey four-step (matmul form)
# ---------------------------------------------------------------------------

def fft_four_step(re: torch.Tensor, im: torch.Tensor, *,
                  inverse: bool = False) -> Planar:
    """Batched four-step FFT along the last axis.

    x[k], k = n2*k1 + k2  ->  y[j], j = j1 + n1*j2:
      1. A[k1, k2] = x.reshape(n1, n2)
      2. B = F_{n1} @ A
      3. C = B * W, W[j1, k2] = w_n^{j1 k2}
      4. D = C @ F_{n2}
      5. y = D.T.reshape(n)
    """
    n = re.shape[-1]
    n1, n2 = tw.four_step_factors(n)
    batch = tuple(re.shape[:-1])
    full_fp32_matmul(re.device)
    (f1r, f1i), (f2r, f2i), (wr, wi) = four_step_tables(n1, n2, inverse, re.device)
    ar = re.reshape(batch + (n1, n2))
    ai = im.reshape(batch + (n1, n2))
    br = f1r @ ar - f1i @ ai
    bi = f1r @ ai + f1i @ ar
    cr, ci = tw.cmul(br, bi, wr, wi)
    dr = cr @ f2r - ci @ f2i
    di = cr @ f2i + ci @ f2r
    yr = dr.transpose(-1, -2).reshape(batch + (n,))
    yi = di.transpose(-1, -2).reshape(batch + (n,))
    if inverse:
        yr, yi = yr / n, yi / n
    return yr, yi


# ---------------------------------------------------------------------------
# Fused superstep: FFT + twiddle rotation + transposed emit
# ---------------------------------------------------------------------------

def fft_twiddle_transpose(re: torch.Tensor, im: torch.Tensor,
                          wr=None, wi=None, *, inverse: bool = False,
                          fft_fn=None) -> Planar:
    """FFT along the LAST axis, optional planar twiddle multiply, and
    the last two axes exchanged:
    ``out[..., k, j] = (W * FFT(x))[..., j, k]``. ``wr``/``wi``
    broadcast against the pre-transpose output (..., b, n). Returns
    transposed views; a consumer that needs contiguous storage copies."""
    fft_fn = fft_stockham if fft_fn is None else fft_fn
    yr, yi = fft_fn(re, im, inverse=inverse)
    if wr is not None:
        yr, yi = tw.cmul(yr, yi, wr, wi)
    return yr.transpose(-1, -2), yi.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Direct DFT (oracle for tiny sizes and non-pow2 lengths)
# ---------------------------------------------------------------------------

def dft_direct(re: torch.Tensor, im: torch.Tensor, *,
               inverse: bool = False) -> Planar:
    n = re.shape[-1]
    full_fp32_matmul(re.device)
    fr, fi = (tw.table(a, re.device) for a in tw.dft_matrix_np(n, inverse=inverse))
    yr = re @ fr.T - im @ fi.T
    yi = im @ fr.T + re @ fi.T
    if inverse:
        yr, yi = yr / n, yi / n
    return yr, yi
