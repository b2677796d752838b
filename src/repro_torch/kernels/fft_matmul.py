"""Bailey four-step pencil FFT: the CUDA kernel and its plain version.

Replaces ``repro.kernels.fft_matmul.fft_matmul``
(src/repro/kernels/fft_matmul.py:71). Each pencil n = n1 * n2 (n1 >= n2)
is viewed as A (n1, n2); B = F1 A, C = B * W, D = C F2 and the output is
D read column-major, the DFT products computed in the kernel body.
``csrc/fft_matmul.cu`` holds two bodies, chosen by the pencil length
alone (:func:`variant`, the same lengths as ``fft_block``'s):

* ``'mma'`` (64 <= n <= 4096): the tensor-core body of
  ``csrc/four_step_mma.cuh`` that ``fft_block`` runs too (3xTF32
  ``mma.sync``, persistent blocks): ``matmul_mma_kernel``, the two-factor
  four-step, for 64 <= n <= 1024, and ``matmul_mma3_kernel``, the same
  steps over three factors 16 * 16 * (n / 256), for n = 2048 and 4096.
  The TPU kernel's planar products against F1, W and F2 are, written as
  real block matrices, ``fft_block``'s tables, so this module passes
  those (:func:`repro_torch.kernels.fft_block.mma_tables_for`, one cache
  for both);
* ``'fma'`` (``four_step_kernel``, every other n): fp32 FMA on the CUDA
  cores, a block holding the planar F1, F2, W and P = max(1, 2048 / n)
  pencils in shared memory.

The function's bound is the FFT's 16 bytes per element.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fft1d as f1
from repro_torch.core import twiddle as tw
from repro_torch.core.twiddle import Planar
from repro_torch.kernels import _build, check_planar, refuse_grad, stream_of
from repro_torch.kernels.fft_block import MMA_LENGTHS, mma_factors, mma_tables_for
from repro_torch.kernels.fft_pencil import tile_pencils

#: launches of either CUDA body (plain-version calls do not count)
launches = 0
#: of those, launches of the tensor-core body
launches_mma = 0

def variant(n: int) -> str:
    """The body a CUDA launch of length-n pencils runs: ``'mma'`` for
    64 <= n <= 4096 (:data:`MMA_LENGTHS`, ``fft_block``'s), else
    ``'fma'``."""
    return 'mma' if MMA_LENGTHS[0] <= n <= MMA_LENGTHS[1] else 'fma'


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
    _build.declare(lib, 'fft_matmul_mma_launch', 7,
                   (ctypes.c_longlong, ctypes.c_int, ctypes.c_float))
    lib.four_step_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.four_step_smem_bytes.restype = ctypes.c_longlong
    lib.fft_matmul_mma_pencils.argtypes = [ctypes.c_int]
    lib.fft_matmul_mma_pencils.restype = ctypes.c_int
    lib.fft_matmul_mma_smem_bytes.argtypes = [ctypes.c_int]
    lib.fft_matmul_mma_smem_bytes.restype = ctypes.c_longlong
    lib.fft_matmul_blocks_per_sm.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.fft_matmul_blocks_per_sm.restype = ctypes.c_int
    return lib


def _shape(n: int, batch: int, body: str):
    """(n1, n2, pencils a tile, shared bytes a block) of a launch of
    ``body`` on ``batch`` pencils of n."""
    n1, n2 = tw.four_step_factors(n)
    lib = _lib()
    if body == 'mma':
        return n1, n2, lib.fft_matmul_mma_pencils(n), lib.fft_matmul_mma_smem_bytes(n)
    P = tile_pencils(n, batch)
    return n1, n2, P, lib.four_step_smem_bytes(n1, n2, P)


def launch_info(n: int, batch: int) -> dict:
    """What a launch on ``batch`` pencils of n runs on the current card:
    its body, the factors of n it runs, pencils a tile, registers a
    thread, shared bytes a block and blocks an SM."""
    body = variant(n)
    n1, n2, P, smem = _shape(n, batch, body)
    per_sm, regs = ctypes.c_int(0), ctypes.c_int(0)
    err = _lib().fft_matmul_blocks_per_sm(int(body == 'mma'), n, smem,
                                          ctypes.byref(per_sm), ctypes.byref(regs))
    if err:
        raise RuntimeError(f"fft_matmul: occupancy query failed with CUDA error {err}")
    factors = mma_factors(n) if body == 'mma' else (n1, n2)
    return dict(variant=body, factors='x'.join(map(str, factors)), pencils_per_tile=P,
                registers=regs.value, smem_bytes=smem, blocks_per_sm=per_sm.value)


def _launch(re: torch.Tensor, im: torch.Tensor, yr: torch.Tensor, yi: torch.Tensor,
            n: int, inverse: bool, _body: str | None = None) -> None:
    """Run the kernel on contiguous fp32 planes (..., n) into (yr, yi).
    The body is :func:`variant` of n; ``_body`` overrides it only to time
    the CUDA-core body beside the tensor-core one."""
    global launches, launches_mma
    batch = re.numel() // n
    if batch == 0:
        return
    body = _body or variant(n)
    n1, n2, P, smem = _shape(n, batch, body)
    scale = (1.0 / n) if inverse else 1.0
    ptrs = (re.data_ptr(), im.data_ptr(), yr.data_ptr(), yi.data_ptr())
    with torch.cuda.device(re.device):
        if body == 'mma':
            fa, fb, w = mma_tables_for(n, inverse, re.device)
            err = _lib().fft_matmul_mma_launch(*ptrs, fa.data_ptr(), fb.data_ptr(),
                                               w.data_ptr(), batch, n, scale, stream_of(re))
        else:
            (f1r, f1i), (f2r, f2i), (wr, wi) = f1.four_step_tables(n1, n2, inverse,
                                                                   re.device)
            err = _lib().fft_matmul_launch(
                *ptrs, f1r.data_ptr(), f1i.data_ptr(), f2r.data_ptr(), f2i.data_ptr(),
                wr.data_ptr(), wi.data_ptr(), batch, n1, n2, P, scale, stream_of(re))
    if err:
        raise RuntimeError(
            f"fft_matmul: {body} launch failed with CUDA error {err} (n={n}, {P} pencils "
            f"per tile, {smem} bytes of shared memory)")
    launches += 1
    launches_mma += body == 'mma'


def fft_matmul(re: torch.Tensor, im: torch.Tensor, *,
               inverse: bool = False) -> Planar:
    """Batched four-step FFT along the last axis of planar fp32 (..., n).

    A CPU tensor runs :func:`fft_matmul_plain`; a CUDA tensor launches
    the kernel (or raises)."""
    n = check_planar('fft_matmul', re, im)
    if re.device.type == 'cpu':
        return fft_matmul_plain(re, im, inverse=inverse)
    refuse_grad('fft_matmul', re, im)
    yr, yi = torch.empty_like(re), torch.empty_like(im)
    _launch(re, im, yr, yi, n, inverse)
    return yr, yi
