"""Fused superstep: Stockham FFT + optional twiddle + transposed emit.

Replaces ``repro.kernels.fft_fused.fft_twiddle_transpose``
(src/repro/kernels/fft_fused.py:58). The kernel is ``fused_kernel`` in
``csrc/fft_pencil.cu``, sharing the Stockham stages of
:mod:`.fft_pencil`: a block loads P pencils of one leading slice, runs
every stage in shared memory, applies the twiddle and stores the tile
transposed, ``out[..., k, j] = (W * FFT(x))[..., j, k]``, so the swap
that follows reads its split axis next to memory. Memory-bound: one
read and one write of every element (plus one read of the twiddle when
there is one).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import fft1d as f1
from repro_torch.core.twiddle import Planar
from repro_torch.kernels import _build, check_planar, stream_of
from repro_torch.kernels.fft_pencil import master_table, tile_pencils

#: launches of the CUDA kernel (plain-version calls do not count)
launches = 0


def tile_layout(n: int, b: int):
    """(P, ld): pencils per block and the padded shared row stride that
    keeps the transposed read-out free of bank conflicts."""
    P = tile_pencils(n, b)
    return P, n + max(1, 32 // P)


def _twiddle(re: torch.Tensor, w: Optional[torch.Tensor]):
    if w is None:
        return None
    w = torch.as_tensor(w, dtype=torch.float32, device=re.device)
    return w.expand(re.shape).contiguous()


def fft_twiddle_transpose_plain(re: torch.Tensor, im: torch.Tensor,
                                wr=None, wi=None, *,
                                inverse: bool = False) -> Planar:
    """Plain PyTorch version of :func:`fft_twiddle_transpose`, with the
    kernel's contiguous (..., n, b) output."""
    yr, yi = f1.fft_twiddle_transpose(re, im, _twiddle(re, wr), _twiddle(re, wi),
                                      inverse=inverse)
    return yr.contiguous(), yi.contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('fft_pencil')
    _build.declare(lib, 'fft_fused_launch', 8,
                   (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_float))
    lib.stockham_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.stockham_smem_bytes.restype = ctypes.c_longlong
    return lib


def fft_twiddle_transpose(re: torch.Tensor, im: torch.Tensor,
                          wr=None, wi=None, *,
                          inverse: bool = False) -> Planar:
    """Fused superstep on planar fp32 (..., b, n) -> (..., n, b).

    ``wr``/``wi`` is an optional planar twiddle broadcastable to the
    pre-transpose output (..., b, n). A CPU tensor runs
    :func:`fft_twiddle_transpose_plain`; a CUDA tensor launches the
    kernel (or raises)."""
    global launches
    n = check_planar('fft_twiddle_transpose', re, im, min_ndim=2)
    if (wr is None) != (wi is None):
        raise ValueError("fft_twiddle_transpose: give both twiddle planes or neither")
    if re.device.type == 'cpu':
        return fft_twiddle_transpose_plain(re, im, wr, wi, inverse=inverse)
    b = re.shape[-2]
    lead = tuple(re.shape[:-2])
    nl = re.numel() // (b * n) if b else 0
    yr = torch.empty(lead + (n, b), dtype=re.dtype, device=re.device)
    yi = torch.empty_like(yr)
    if re.numel() == 0:
        return yr, yi
    twr, twi = _twiddle(re, wr), _twiddle(re, wi)
    lib = _lib()
    P, ld = tile_layout(n, b)
    smem = lib.stockham_smem_bytes(n, P, ld)
    mr, mi = master_table(n, inverse, re.device)
    with torch.cuda.device(re.device):
        err = lib.fft_fused_launch(
            re.data_ptr(), im.data_ptr(),
            None if twr is None else twr.data_ptr(),
            None if twi is None else twi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), mr.data_ptr(), mi.data_ptr(),
            nl, b, n, P, ld, (1.0 / n) if inverse else 1.0, stream_of(re))
    if err:
        raise RuntimeError(f"fft_twiddle_transpose: launch failed with CUDA error {err} "
                           f"(n={n}, {P} pencils per block, {smem} bytes of shared memory)")
    launches += 1
    return yr, yi
