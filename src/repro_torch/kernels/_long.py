"""The long body: pencils of 4096 < n <= 65536, shared by all four kernels.

``csrc/fft_long.cu`` runs the reference's four-step split n = NA * NB
(``four_step_factors``: 128 x 64 at 8192 up to 256 x 256 at 65536) in
two passes over device memory, each sub-FFT on the radix-8 register
passes of ``csrc/radix8.cuh``:

1. over columns: a block takes :data:`COLS` consecutive columns j of
   one pencil, runs each column's NA-point FFT, multiplies by
   w_n^(j k1) (the four-step's table W[k1 NB + j]) and stores the rows
   y[j NA + k1] as one contiguous run;
2. in place on y: a block takes :data:`COLS` consecutive k1, runs the
   NB-point FFT over j and writes y[k2 NA + k1] = X[k1 + NA k2], the
   inverse's 1/n applied here. ``fft_twiddle_transpose``'s pass 2
   reads pass 1's result from a scratch of at most
   :data:`SCRATCH_ELEMS` elements a plane, applies the twiddle planes
   and stores out[..., k, j].

``fft_pencil``, ``fft_matmul`` and ``fft_block`` run it through
:func:`launch`, ``fft_twiddle_transpose`` through :func:`launch_fused`;
each counts the launch in its own module. The pure functions below
mirror the C side's shared and scratch bytes (``long_smem_bytes``,
``long_scratch_bytes``); ``chip_smoke.py``'s ``[long]`` phase checks
them equal.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fft1d as f1
from repro_torch.core import twiddle as tw
from repro_torch.kernels import _build, stream_of

#: the pencil lengths of the long body, inclusive: 4096 < n <= 65536, the
#: longest any CUDA kernel takes
LENGTHS = (8192, 65536)
#: columns (pass 1) or k1 (pass 2) a block
COLS = 16
#: floats past NA in a staging row of pass 1
STAGE_PAD = 2
#: the fused kernel's scratch, elements a plane: its passes run on chunks
#: of at most this many elements
SCRATCH_ELEMS = 1 << 24


def takes(n: int) -> bool:
    """Whether the long body runs pencils of n."""
    return tw.is_pow2(n) and LENGTHS[0] <= n <= LENGTHS[1]


def check_length(name: str, n: int) -> None:
    """Raise ``ValueError`` where a CUDA or ``meta`` operand's pencils are
    longer than the kernels take (the plain version takes any n)."""
    if n > LENGTHS[1]:
        raise ValueError(
            f"{name}: the CUDA kernels take pencils of at most {LENGTHS[1]} (the long "
            f"body above 4096), got n = {n}; plan with kernel='reference' or a tensor "
            "on the CPU for longer pencils")


def factors(n: int) -> tuple:
    """(NA, NB) = ``four_step_factors(n)``: the column FFT's length, then
    the row FFT's."""
    return tw.four_step_factors(n)


def _passes(m: int) -> int:
    """The radix-8 passes of an m-point sub-FFT (``radix8_passes``)."""
    return -(-tw.log2i(m) // 3)


def _exchange_floats(m: int) -> int:
    """Floats of the exchange buffers of :data:`COLS` m-point sub-FFTs:
    one a pass but the last, two at most, a re and an im plane of COLS
    rows each; a row is m floats, m + T where the sub-FFT has T = m/8 <
    32 threads (``Radix8<>::LD``)."""
    T = m // 8
    ld = m + (T if T < 32 else 0)
    return min(2, _passes(m) - 1) * 2 * COLS * ld


def smem_bytes(n: int, pass_: int) -> int:
    """Shared bytes a block of pass 1 or pass 2 takes for pencils of n
    (the C function ``long_smem_bytes``): pass 1 the larger of its
    exchange buffers and its staging rows (2 COLS rows of NA +
    :data:`STAGE_PAD` floats, laid over the buffers), pass 2 its
    exchange buffers."""
    na, nb = factors(n)
    if pass_ == 1:
        return 4 * max(_exchange_floats(na), 2 * COLS * (na + STAGE_PAD))
    return 4 * _exchange_floats(nb)


def block_smem_bytes(n: int) -> int:
    """Shared bytes of the larger of the two passes' blocks."""
    return max(smem_bytes(n, 1), smem_bytes(n, 2))


def threads(n: int, pass_: int) -> int:
    """Threads a block of pass 1 or pass 2 runs: NA/8 or NB/8 a column."""
    return COLS * factors(n)[pass_ - 1] // 8


def chunk_pencils(n: int, pencils: int) -> int:
    """Pencils a chunk of the fused kernel's passes holds."""
    return min(pencils, max(1, SCRATCH_ELEMS // n))


def scratch_bytes(n: int, pencils: int, fused: bool) -> int:
    """Scratch bytes a launch on ``pencils`` pencils of n takes (the C
    function ``long_scratch_bytes``): two planes of one chunk for the
    fused kernel, none for the others (their pass 2 runs in place on the
    output)."""
    return 2 * 4 * chunk_pencils(n, pencils) * n if fused else 0


@functools.lru_cache(maxsize=None)
def tables(n: int, inverse: bool, device: torch.device):
    """What the body reads: the radix-8 tables of NA and NB points and
    the four-step's W[k1 NB + j] = w_n^(k1 j) (float64 roots rounded to
    fp32), conjugated for the inverse; six fp32 tensors on ``device``."""
    from repro_torch.kernels.fft_pencil import radix8_tables
    na, nb = factors(n)
    ar, ai = radix8_tables(na, inverse, device)
    br, bi = radix8_tables(nb, inverse, device)
    wr, wi = f1.four_step_tables(na, nb, inverse, device)[2]
    return ar, ai, br, bi, wr, wi


@functools.lru_cache(maxsize=None)
def lib():
    lib = _build.load('fft_long')
    _build.declare(lib, 'fft_long_launch', 10,
                   (ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float))
    _build.declare(lib, 'fft_fused_long_launch', 14,
                   (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_float, ctypes.c_float))
    lib.long_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.long_smem_bytes.restype = ctypes.c_longlong
    lib.long_threads.argtypes = [ctypes.c_int] * 2
    lib.long_threads.restype = ctypes.c_int
    lib.long_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    lib.long_scratch_bytes.restype = ctypes.c_longlong
    lib.long_blocks_per_sm.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.long_blocks_per_sm.restype = ctypes.c_int
    return lib


def launch(re: torch.Tensor, im: torch.Tensor, yr: torch.Tensor, yi: torch.Tensor,
           n: int, inverse: bool) -> int:
    """Both passes on contiguous fp32 planes (..., n) into (yr, yi), on
    the current stream; the CUDA error."""
    t = tables(n, inverse, re.device)
    return lib().fft_long_launch(re.data_ptr(), im.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                                 *(a.data_ptr() for a in t), re.numel() // n, n,
                                 -1.0 if inverse else 1.0, (1.0 / n) if inverse else 1.0,
                                 stream_of(re))


def launch_fused(re: torch.Tensor, im: torch.Tensor, twr, twi, wstride: int,
                 yr: torch.Tensor, yi: torch.Tensor, n: int, inverse: bool) -> int:
    """``fft_twiddle_transpose``'s passes on rows (..., b, n) into (yr,
    yi) of (..., n, b), the twiddle planes (``twr``, ``twi``) as
    ``fft_fused._twiddle_planes`` gives them or None, through a scratch
    of :func:`scratch_bytes` allocated here; the CUDA error."""
    b = re.shape[-2]
    nl = re.numel() // (b * n)
    per = chunk_pencils(n, nl * b) * n
    sr = torch.empty(per, dtype=torch.float32, device=re.device)
    si = torch.empty(per, dtype=torch.float32, device=re.device)
    t = tables(n, inverse, re.device)
    return lib().fft_fused_long_launch(
        re.data_ptr(), im.data_ptr(), None if twr is None else twr.data_ptr(),
        None if twi is None else twi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
        sr.data_ptr(), si.data_ptr(), *(a.data_ptr() for a in t), nl, b, wstride, n,
        -1.0 if inverse else 1.0, (1.0 / n) if inverse else 1.0, stream_of(re))


def launch_info(n: int, batch: int, fused: bool = False) -> dict:
    """What a long launch on ``batch`` pencils of n runs on the current
    card: the body, its split, columns a tile, then for (pass 1, pass 2)
    threads, shared bytes, blocks an SM and registers a thread, and the
    scratch bytes it allocates."""
    per_sm, regs = [], []
    for kind in (1, 3 if fused else 2):
        p, r = ctypes.c_int(0), ctypes.c_int(0)
        err = lib().long_blocks_per_sm(n, kind, ctypes.byref(p), ctypes.byref(r))
        if err:
            raise RuntimeError(f"long body: occupancy query failed with CUDA error {err}")
        per_sm.append(p.value)
        regs.append(r.value)
    return dict(variant='long', factors='x'.join(map(str, factors(n))),
                columns_per_tile=COLS, threads=[threads(n, 1), threads(n, 2)],
                smem_bytes=[smem_bytes(n, 1), smem_bytes(n, 2)], blocks_per_sm=per_sm,
                registers=regs, scratch_bytes=scratch_bytes(n, batch, fused))

