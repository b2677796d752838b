"""Bailey four-step pencil FFT: the CUDA kernel and its plain version.

Replaces ``repro.kernels.fft_matmul.fft_matmul``
(src/repro/kernels/fft_matmul.py:71). The kernel is ``four_step_kernel``
in ``csrc/fft_matmul.cu``: each pencil n = n1 * n2 (n1 >= n2) is viewed
as A (n1, n2); B = F1 A, C = B * W, D = C F2 and the output is D read
column-major, with fp32 FMA on the CUDA cores (no TF32) and the DFT
products computed in the kernel body. A block holds its tables and P =
max(1, 2048 / n) pencils in shared memory. Its dense products cost
4 n (n1 + n2) real multiply-adds per pencil, more than an FFT needs;
the function's bound is the same 16 bytes per element as the Stockham
kernels'.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fft1d as f1
from repro_torch.core import twiddle as tw
from repro_torch.core.twiddle import Planar
from repro_torch.kernels import _build, check_planar, stream_of
from repro_torch.kernels.fft_pencil import tile_pencils

#: launches of the CUDA kernel (plain-version calls do not count)
launches = 0


def fft_matmul_plain(re: torch.Tensor, im: torch.Tensor, *,
                     inverse: bool = False) -> Planar:
    """Plain PyTorch version of :func:`fft_matmul`: the reference-tier
    four-step, the same steps as full-fp32 matmuls."""
    return f1.fft_four_step(re, im, inverse=inverse)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('fft_matmul')
    _build.declare(lib, 'fft_matmul_launch', 10,
                   (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float))
    lib.four_step_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.four_step_smem_bytes.restype = ctypes.c_longlong
    return lib


def fft_matmul(re: torch.Tensor, im: torch.Tensor, *,
               inverse: bool = False) -> Planar:
    """Batched four-step FFT along the last axis of planar fp32 (..., n).

    A CPU tensor runs :func:`fft_matmul_plain`; a CUDA tensor launches
    the kernel (or raises)."""
    global launches
    n = check_planar('fft_matmul', re, im)
    if re.device.type == 'cpu':
        return fft_matmul_plain(re, im, inverse=inverse)
    batch = re.numel() // n
    yr, yi = torch.empty_like(re), torch.empty_like(im)
    if batch == 0:
        return yr, yi
    n1, n2 = tw.four_step_factors(n)
    lib = _lib()
    P = tile_pencils(n, batch)
    smem = lib.four_step_smem_bytes(n1, n2, P)
    (f1r, f1i), (f2r, f2i), (wr, wi) = f1.four_step_tables(n1, n2, inverse, re.device)
    with torch.cuda.device(re.device):
        err = lib.fft_matmul_launch(
            re.data_ptr(), im.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            f1r.data_ptr(), f1i.data_ptr(), f2r.data_ptr(), f2i.data_ptr(),
            wr.data_ptr(), wi.data_ptr(), batch, n1, n2, P,
            (1.0 / n) if inverse else 1.0, stream_of(re))
    if err:
        raise RuntimeError(f"fft_matmul: launch failed with CUDA error {err} (n={n}, "
                           f"{P} pencils per block, {smem} bytes of shared memory)")
    launches += 1
    return yr, yi
