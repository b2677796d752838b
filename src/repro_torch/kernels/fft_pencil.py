"""Stockham pencil FFT: the CUDA kernel and its plain version.

Replaces ``repro.kernels.fft_pencil.fft_pencil``
(src/repro/kernels/fft_pencil.py:76). Three bodies, chosen by the pencil
length alone (:func:`variant`):

* ``'radix8'`` (``radix8_pencil_kernel`` in ``csrc/fft_pencil.cu``,
  2 <= n <= 4096): the data stay in registers through radix-8 passes
  (the first pass radix 2 or 4 when log2 n is not a multiple of 3,
  :func:`radix8_passes`), one trip through shared memory between passes,
  twiddles from the per-pass table :func:`radix8_tables`; a block holds
  :func:`radix8_layout` pencils;
* ``'long'`` (``csrc/fft_long.cu``, 4096 < n <= 65536): the
  single-pass four-step of :mod:`._long`, whose sub-FFTs run the same radix-8
  passes; all four kernels share it;
* ``'radix2'`` (``stockham_kernel``, n = 1 only, and timed beside the
  radix-8 body through ``_launch(..., _body='radix2')``): P = max(1,
  2048 / n) pencils a block in shared memory through log2 n radix-2
  stages, which read the master table w_n^k, k < n/2, at stride
  n / 2^(s+1).

A CUDA or ``meta`` operand of n > 65536 raises ``ValueError``. All are
memory-bound: 16 bytes per element per call. The inverse scales by 1/n
at the store.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import fft1d as f1
from repro_torch.core import twiddle as tw
from repro_torch.core.twiddle import Planar
from repro_torch.kernels import _build, _long, check_planar, refuse_grad, report, stream_of

#: pencils per block are chosen so a tile holds about this many elements
TILE_ELEMS = 2048
#: the pencil lengths the radix-8 body takes, inclusive
RADIX8_LENGTHS = (2, 4096)
#: the radix-8 body's block: about this many threads, never more than MAX_THREADS
RADIX8_THREADS = 256
MAX_THREADS = 1024

#: launches of any CUDA body (plain-version calls do not count)
launches = 0
#: of those, launches of the radix-8 body
launches_radix8 = 0
#: of those, launches of the long body
launches_long = 0


def tile_pencils(n: int, batch: int) -> int:
    """Pencils per block of the shared-memory bodies (the radix-2 body,
    and the CUDA-core bodies of ``fft_matmul`` and ``fft_block``): a tile
    of about ``TILE_ELEMS`` elements, never more pencils than the batch
    holds."""
    return max(1, min(TILE_ELEMS // n, batch))


def variant(n: int) -> str:
    """The body a CUDA launch of length-n pencils runs: ``'radix8'`` for
    2 <= n <= 4096, ``'long'`` for 4096 < n <= 65536, ``'radix2'`` for
    n = 1; ``ValueError`` above 65536."""
    _long.check_length('fft_pencil', n)
    if RADIX8_LENGTHS[0] <= n <= RADIX8_LENGTHS[1]:
        return 'radix8'
    return 'long' if _long.takes(n) else 'radix2'


def launch_info(n: int, batch: int) -> dict:
    """What a long launch on ``batch`` pencils of n runs on the current
    card (:func:`repro_torch.kernels._long.launch_info`); ``ValueError``
    at a length the long body does not take."""
    if variant(n) != 'long':
        raise ValueError(f"fft_pencil: launch_info reports the long body; n = {n} runs "
                         f"{variant(n)!r}")
    return _long.launch_info(n, batch)


def radix8_passes(n: int) -> tuple:
    """The radices of the radix-8 body's passes, in order: radix 8, the
    first pass taking 2 or 4 when log2 n is not a multiple of 3."""
    k = tw.log2i(n)
    rem = (2 ** (k % 3),) if k % 3 else ()
    return rem + (8,) * (k // 3)


def radix8_threads(n: int) -> int:
    """Threads a pencil of the radix-8 body: each holds min(8, n) values."""
    return n // min(8, n)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def radix8_smem_bytes(n: int, P: int, fused: bool = False) -> int:
    """Shared bytes a radix-8 launch of P pencils of n takes (the C
    function ``radix8_smem_bytes`` computes the same): up to two buffers,
    one per exchange between passes and the fused kernel's staging, each
    a re and an im plane of P rows. An exchange row is n floats, n + T
    when a pencil has T < 32 threads (its warps then hold several
    pencils); a staging row is n + 32/P floats."""
    T = radix8_threads(n)
    ld = n + (T if T < 32 else 0)
    if fused:
        ld = max(ld, n + 32 // P)
    buffers = min(2, len(radix8_passes(n)) - 1 + int(fused))
    return buffers * 2 * P * ld * 4


def radix8_layout(n: int, batch: int):
    """``(P, threads, smem_bytes)`` of a radix-8 ``fft_pencil`` launch on
    ``batch`` pencils of n: about ``RADIX8_THREADS`` threads a block, P a
    power of two no larger than the batch needs."""
    T = radix8_threads(n)
    P = min(max(1, RADIX8_THREADS // T), _pow2_at_least(batch))
    return P, P * T, radix8_smem_bytes(n, P)


@functools.lru_cache(maxsize=None)
def radix8_tables_np(n: int, inverse: bool):
    """The radix-8 body's twiddles, one table of n - 1 entries: a pass of
    radix r and span Ns (the product of the radices before it) reads
    w_{Ns r}^{k m} at (Ns - 1) + (m - 1) Ns + k, k < Ns, 1 <= m < r. The
    roots are the float64 w_n^e of ``master_table``, rounded to fp32."""
    wr, wi = tw.roots_of_unity_np(n, inverse=inverse)
    out_r = np.ones(max(n - 1, 1), np.float64)
    out_i = np.zeros(max(n - 1, 1), np.float64)
    ns = 1
    for r in radix8_passes(n):
        k = np.arange(ns)
        for m in range(1, r):
            e = (k * m * (n // (ns * r))) % n
            idx = ns - 1 + (m - 1) * ns + k
            out_r[idx], out_i[idx] = wr[e], wi[e]
        ns *= r
    return out_r.astype(np.float32), out_i.astype(np.float32)


@functools.lru_cache(maxsize=None)
def radix8_tables(n: int, inverse: bool, device: torch.device) -> Planar:
    """:func:`radix8_tables_np` as fp32 tensors on ``device``."""
    r, i = radix8_tables_np(n, inverse)
    return tw.table(r, device), tw.table(i, device)


@functools.lru_cache(maxsize=None)
def master_table(n: int, inverse: bool, device: torch.device) -> Planar:
    """w_n^k, k < n/2, for the direction, as fp32 on ``device`` (the
    radix-2 body's table)."""
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
    _build.declare(lib, 'fft_pencil_radix8_launch', 6,
                   (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float))
    lib.stockham_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.stockham_smem_bytes.restype = ctypes.c_longlong
    lib.radix8_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.radix8_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch(re: torch.Tensor, im: torch.Tensor, yr: torch.Tensor, yi: torch.Tensor,
            n: int, inverse: bool, _body: str | None = None) -> None:
    """Run the kernel on contiguous fp32 planes (..., n) into (yr, yi).
    The body is :func:`variant` of n; ``_body`` overrides it only to time
    the radix-2 body beside the radix-8 one."""
    global launches, launches_radix8, launches_long
    body = _body or variant(n)
    batch = re.numel() // n
    if batch == 0:
        return
    if re.device.type == 'meta':
        report('fft_pencil', body, n, batch)
        return
    scale = (1.0 / n) if inverse else 1.0
    ptrs = (re.data_ptr(), im.data_ptr(), yr.data_ptr(), yi.data_ptr())
    lib = _lib()
    with torch.cuda.device(re.device):
        if body == 'long':
            P, smem = f"1/{_long.cluster(n)}", _long.smem_bytes(n)
            err = _long.launch(re, im, yr, yi, n, inverse)
        elif body == 'radix8':
            P, _, smem = radix8_layout(n, batch)
            wr, wi = radix8_tables(n, inverse, re.device)
            err = lib.fft_pencil_radix8_launch(*ptrs, wr.data_ptr(), wi.data_ptr(), batch,
                                               n, P, -1.0 if inverse else 1.0, scale,
                                               stream_of(re))
        else:
            P = tile_pencils(n, batch)
            smem = lib.stockham_smem_bytes(n, P, n)
            wr, wi = master_table(n, inverse, re.device)
            err = lib.fft_pencil_launch(*ptrs, wr.data_ptr(), wi.data_ptr(), batch, n, P,
                                        scale, stream_of(re))
    if err:
        raise RuntimeError(f"fft_pencil: {body} launch failed with CUDA error {err} "
                           f"(n={n}, {P} pencils per block, {smem} bytes of shared memory)")
    launches += 1
    launches_radix8 += body == 'radix8'
    launches_long += body == 'long'
    report('fft_pencil', body, n, batch)


def fft_pencil(re: torch.Tensor, im: torch.Tensor, *,
               inverse: bool = False) -> Planar:
    """Batched Stockham FFT along the last axis of planar fp32 (..., n).

    A CPU tensor runs :func:`fft_pencil_plain`; a CUDA tensor launches
    the kernel (or raises); a ``meta`` tensor returns the card's shapes.
    Outputs are new contiguous tensors."""
    n = check_planar('fft_pencil', re, im)
    if re.device.type == 'cpu':
        return fft_pencil_plain(re, im, inverse=inverse)
    refuse_grad('fft_pencil', re, im)
    yr, yi = torch.empty_like(re), torch.empty_like(im)
    _launch(re, im, yr, yi, n, inverse)
    return yr, yi
