"""Radix-2 Stockham pencil FFT: the CUDA kernel and its plain version.

Replaces ``repro.kernels.fft_pencil.fft_pencil``
(src/repro/kernels/fft_pencil.py:76). The kernel is ``stockham_kernel``
in ``csrc/fft_pencil.cu``: a block holds P = max(1, 2048 / n) pencils in
shared memory for all log2(n) stages, so device memory is read and
written once (memory-bound: 16 bytes per element per pass). Stage s
reads the master table w_n^k, k < n/2, of the requested direction at
stride n / 2^(s+1); the inverse scales by 1/n at the end.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fft1d as f1
from repro_torch.core import twiddle as tw
from repro_torch.core.twiddle import Planar
from repro_torch.kernels import _build, check_planar, stream_of

#: pencils per block are chosen so a tile holds about this many elements
TILE_ELEMS = 2048

#: launches of the CUDA kernel (plain-version calls do not count)
launches = 0


def tile_pencils(n: int, batch: int) -> int:
    """Pencils per block, for all three kernels: a tile of about
    ``TILE_ELEMS`` elements, never more pencils than the batch holds."""
    return max(1, min(TILE_ELEMS // n, batch))


@functools.lru_cache(maxsize=None)
def master_table(n: int, inverse: bool, device: torch.device) -> Planar:
    """w_n^k, k < n/2, for the direction, as fp32 on ``device``."""
    wr, wi = tw.roots_of_unity_np(n, inverse=inverse)
    h = max(n // 2, 1)
    return tw.table(wr[:h], device), tw.table(wi[:h], device)


def fft_pencil_plain(re: torch.Tensor, im: torch.Tensor, *,
                     inverse: bool = False) -> Planar:
    """Plain PyTorch version of :func:`fft_pencil`: the reference-tier
    Stockham pencil, whose per-stage tables hold the same roots."""
    return f1.fft_stockham(re, im, inverse=inverse)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('fft_pencil')
    _build.declare(lib, 'fft_pencil_launch', 6,
                   (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float))
    lib.stockham_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.stockham_smem_bytes.restype = ctypes.c_longlong
    return lib


def fft_pencil(re: torch.Tensor, im: torch.Tensor, *,
               inverse: bool = False) -> Planar:
    """Batched Stockham FFT along the last axis of planar fp32 (..., n).

    A CPU tensor runs :func:`fft_pencil_plain`; a CUDA tensor launches
    the kernel (or raises). Outputs are new contiguous tensors."""
    global launches
    n = check_planar('fft_pencil', re, im)
    if re.device.type == 'cpu':
        return fft_pencil_plain(re, im, inverse=inverse)
    batch = re.numel() // n
    yr, yi = torch.empty_like(re), torch.empty_like(im)
    if batch == 0:
        return yr, yi
    lib = _lib()
    P = tile_pencils(n, batch)
    smem = lib.stockham_smem_bytes(n, P, n)
    wr, wi = master_table(n, inverse, re.device)
    with torch.cuda.device(re.device):
        err = lib.fft_pencil_launch(
            re.data_ptr(), im.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            wr.data_ptr(), wi.data_ptr(), batch, n, P,
            (1.0 / n) if inverse else 1.0, stream_of(re))
    if err:
        raise RuntimeError(f"fft_pencil: launch failed with CUDA error {err} (n={n}, "
                           f"{P} pencils per block, {smem} bytes of shared memory)")
    launches += 1
    return yr, yi
