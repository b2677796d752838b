"""Fused superstep: Stockham FFT + optional twiddle + transposed emit.

Replaces ``repro.kernels.fft_fused.fft_twiddle_transpose``
(src/repro/kernels/fft_fused.py:58). ``csrc/fft_pencil.cu`` holds two
bodies, chosen as :mod:`.fft_pencil`'s are (:func:`variant`):

* ``'radix8'`` (``radix8_fused_kernel``, 2 <= n <= 4096): the radix-8
  passes of ``fft_pencil``'s body on P pencils of one leading slice, the
  scale and the twiddle applied in registers in the pre-transpose layout
  (coalesced along the pencil), then the tile staged in shared memory
  and stored transposed, ``out[..., k, j] = (W * FFT(x))[..., j, k]``,
  in runs of P pencils (:func:`tile_layout`);
* ``'radix2'`` (``fused_kernel``, every other n): the radix-2 body.

Memory-bound: one read and one write of every element, 16 bytes an
element, plus one read of the twiddle when there is one: a (b, n) plane
broadcast over the leading axes is read in place, 8 bytes a twiddle
entry, by every leading slice (the kernel's ``wstride`` = 0).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import fft1d as f1
from repro_torch.core.twiddle import Planar
from repro_torch.kernels import _build, check_planar, refuse_grad, stream_of
from repro_torch.kernels.fft_pencil import (MAX_THREADS, _pow2_at_least, master_table,
                                            radix8_smem_bytes, radix8_tables, radix8_threads,
                                            tile_pencils, variant)

#: pencils a block of the radix-8 body aims for: the length of each run
#: of the transposed store (8 floats fill one 32-byte sector)
RUN = 8

#: launches of either CUDA body (plain-version calls do not count)
launches = 0
#: of those, launches of the radix-8 body
launches_radix8 = 0
#: of those, launches that applied twiddle planes
launches_twiddle = 0


def tile_layout(n: int, b: int):
    """``(P, threads, smem_bytes)`` of a radix-8 launch on rows of b
    pencils of n: P = ``RUN`` pencils a block (fewer where b is smaller,
    or where P * n/8 threads would pass 1024, at n >= 2048), so the
    transposed store writes runs of P floats."""
    T = radix8_threads(n)
    P = min(RUN, MAX_THREADS // T, _pow2_at_least(b))
    return P, P * T, radix8_smem_bytes(n, P, fused=True)


def _radix2_layout(n: int, b: int):
    """(P, ld) of the radix-2 body: pencils per block and the padded row
    stride that keeps its transposed read-out free of bank conflicts."""
    P = tile_pencils(n, b)
    return P, n + max(1, 32 // P)


def _twiddle(re: torch.Tensor, w: Optional[torch.Tensor]):
    """The twiddle plane expanded to the input's shape (the plain version)."""
    if w is None:
        return None
    w = torch.as_tensor(w, dtype=torch.float32, device=re.device)
    return w.expand(re.shape).contiguous()


def _twiddle_planes(re: torch.Tensor, wr, wi):
    """``(twr, twi, wstride)`` as the kernel reads them: a twiddle with no
    leading axes past (b, n) (or only axes of 1) stays one contiguous
    (b, n) plane that every leading slice reads (``wstride`` 0); any
    other is expanded to the input's shape (``wstride`` b * n)."""
    if wr is None:
        return None, None, 0
    b, n = re.shape[-2:]
    ws = [torch.as_tensor(w, dtype=torch.float32, device=re.device) for w in (wr, wi)]
    if all(all(d == 1 for d in w.shape[:-2]) for w in ws):
        return (*(w.reshape(w.shape[-2:]).expand(b, n).contiguous() for w in ws), 0)
    return (*(w.expand(re.shape).contiguous() for w in ws), b * n)


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
                   (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_float))
    _build.declare(lib, 'fft_fused_radix8_launch', 8,
                   (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_float))
    lib.stockham_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.stockham_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch(re: torch.Tensor, im: torch.Tensor, wr, wi, yr: torch.Tensor,
            yi: torch.Tensor, inverse: bool, _body: str | None = None) -> None:
    """Run the kernel on contiguous fp32 planes (..., b, n), the twiddle
    planes ``wr``/``wi`` broadcastable to them or None, into (yr, yi) of
    (..., n, b). The body is :func:`variant` of n; ``_body`` overrides it
    only to time the radix-2 body beside the radix-8 one."""
    global launches, launches_radix8, launches_twiddle
    b, n = re.shape[-2:]
    if re.numel() == 0:
        return
    twr, twi, wstride = _twiddle_planes(re, wr, wi)
    nl = re.numel() // (b * n)
    body = _body or variant(n)
    scale = (1.0 / n) if inverse else 1.0
    ptrs = (re.data_ptr(), im.data_ptr(),
            None if twr is None else twr.data_ptr(),
            None if twi is None else twi.data_ptr(),
            yr.data_ptr(), yi.data_ptr())
    lib = _lib()
    with torch.cuda.device(re.device):
        if body == 'radix8':
            P, _, smem = tile_layout(n, b)
            mr, mi = radix8_tables(n, inverse, re.device)
            err = lib.fft_fused_radix8_launch(*ptrs, mr.data_ptr(), mi.data_ptr(), nl, b,
                                              wstride, n, P, -1.0 if inverse else 1.0,
                                              scale, stream_of(re))
        else:
            P, ld = _radix2_layout(n, b)
            smem = lib.stockham_smem_bytes(n, P, ld)
            mr, mi = master_table(n, inverse, re.device)
            err = lib.fft_fused_launch(*ptrs, mr.data_ptr(), mi.data_ptr(), nl, b, wstride, n,
                                       P, ld, scale, stream_of(re))
    if err:
        raise RuntimeError(f"fft_twiddle_transpose: {body} launch failed with CUDA error "
                           f"{err} (n={n}, {P} pencils per block, {smem} bytes of shared "
                           "memory)")
    launches += 1
    launches_radix8 += body == 'radix8'
    launches_twiddle += twr is not None


def fft_twiddle_transpose(re: torch.Tensor, im: torch.Tensor,
                          wr=None, wi=None, *,
                          inverse: bool = False) -> Planar:
    """Fused superstep on planar fp32 (..., b, n) -> (..., n, b).

    ``wr``/``wi`` is an optional planar twiddle broadcastable to the
    pre-transpose output (..., b, n). A CPU tensor runs
    :func:`fft_twiddle_transpose_plain`; a CUDA tensor launches the
    kernel (or raises)."""
    n = check_planar('fft_twiddle_transpose', re, im, min_ndim=2)
    if (wr is None) != (wi is None):
        raise ValueError("fft_twiddle_transpose: give both twiddle planes or neither")
    if re.device.type == 'cpu':
        return fft_twiddle_transpose_plain(re, im, wr, wi, inverse=inverse)
    refuse_grad('fft_twiddle_transpose', re, im, wr, wi)
    b = re.shape[-2]
    yr = torch.empty(tuple(re.shape[:-2]) + (n, b), dtype=re.dtype, device=re.device)
    yi = torch.empty_like(yr)
    _launch(re, im, wr, wi, yr, yi, inverse)
    return yr, yi
