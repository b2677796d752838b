"""Block-complex four-step pencil FFT: the CUDA kernel and its plain version.

Replaces ``repro.kernels.fft_block.fft_block``
(src/repro/kernels/fft_block.py:49). The kernel is ``block_kernel`` in
``csrc/fft_block.cu``: each pencil n = n1 * n2 runs the two real
contractions of the TPU kernel, against F1b (the 2x2-block DFT of the
first factor) and G (the twiddle folded into the second factor, which
emits natural order), with fp32 FMA on the CUDA cores. The C entry takes
separate re/im planes, so the stacked form :func:`fft_block` passes
``x[0]``/``x[1]`` and the planar form :func:`fft_block_planar` passes
its pair, neither with a stack copy. Blocks are persistent and keep
F1b, a tile of P pencils and (for n <= 512) G in shared memory; its
dense products cost 8 n (n1 + n2) flop a pencil, and the function's
bound is the FFT's 16 bytes per element.
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


def fft_block_plain(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`fft_block`: the reference-tier
    block four-step along the last axis of a stacked (2, ..., n)."""
    return f1.fft_four_step_block(x, -1, inverse=inverse)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('fft_block')
    _build.declare(lib, 'fft_block_launch', 6,
                   (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float))
    lib.fft_block_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fft_block_smem_bytes.restype = ctypes.c_longlong
    lib.fft_block_slices.argtypes = [ctypes.c_int] * 3
    lib.fft_block_slices.restype = ctypes.c_int
    return lib


def _launch(re: torch.Tensor, im: torch.Tensor, yr: torch.Tensor, yi: torch.Tensor,
            n: int, inverse: bool) -> None:
    """Run the kernel on contiguous fp32 planes (..., n) into (yr, yi)."""
    global launches
    batch = re.numel() // n
    if batch == 0:
        return
    n1, n2 = tw.four_step_factors(n)
    lib = _lib()
    P = tile_pencils(n, batch)
    jc = lib.fft_block_slices(n1, n2, P)
    if jc == 0:
        raise ValueError(
            f"fft_block: n={n} does not fit one block: {P} pencil(s) and one G slice "
            f"need {lib.fft_block_smem_bytes(n1, n2, P, 1)} bytes of shared memory")
    f1b, g = f1.block_tables(n1, n2, inverse, re.device)
    with torch.cuda.device(re.device):
        err = lib.fft_block_launch(
            re.data_ptr(), im.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            f1b.data_ptr(), g.data_ptr(), batch, n1, n2, P, jc,
            (1.0 / n) if inverse else 1.0, stream_of(re))
    if err:
        raise RuntimeError(
            f"fft_block: launch failed with CUDA error {err} (n={n}, {P} pencils per "
            f"tile, {jc} G slices, {lib.fft_block_smem_bytes(n1, n2, P, jc)} bytes of "
            "shared memory)")
    launches += 1


def fft_block(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Batched block-complex FFT along the last axis of a contiguous fp32
    (2, ..., n) whose leading axis holds (re, im); natural order.

    A CPU tensor runs :func:`fft_block_plain`; a CUDA tensor launches
    the kernel (or raises)."""
    if x.ndim < 2 or x.shape[0] != 2:
        raise ValueError(f"fft_block: needs a leading complex axis of 2, got {tuple(x.shape)}")
    n = check_planar('fft_block', x[0], x[1])
    if x.device.type == 'cpu':
        return fft_block_plain(x, inverse=inverse)
    y = torch.empty_like(x)
    _launch(x[0], x[1], y[0], y[1], n, inverse)
    return y


def fft_block_planar(re: torch.Tensor, im: torch.Tensor, *,
                     inverse: bool = False) -> Planar:
    """The same FFT on a planar fp32 pair (..., n): the method registry's
    kernel form. A CPU tensor runs the plain version on the stacked
    pair; a CUDA tensor launches the kernel (or raises)."""
    n = check_planar('fft_block', re, im)
    if re.device.type == 'cpu':
        y = fft_block_plain(torch.stack([re, im]), inverse=inverse)
        return y[0], y[1]
    yr, yi = torch.empty_like(re), torch.empty_like(im)
    _launch(re, im, yr, yi, n, inverse)
    return yr, yi
