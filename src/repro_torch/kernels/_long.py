"""The long body: pencils of 4096 < n <= 65536, shared by all four kernels.

``csrc/fft_long.cu`` runs the reference's four-step split n = NA * NB
(``four_step_factors``: 128 x 64 at 8192 up to 256 x 256 at 65536) in
one pass over device memory, a pencil held in shared memory by one
block, or by a thread-block cluster of :func:`cluster` blocks at 32768
and 65536 (each block a slab of NB / C columns j, a tile of NA rows):

1. columns: a group of NA/8 warps takes 32 columns, one a lane, loads
   them (runs of 32 consecutive j; at 8192 as ``cp.async`` copies into
   the tile, every round's at once), runs each column's NA-point FFT on
   the radix-8 register passes of ``csrc/radix8.cuh`` with its
   exchanges in place in the tile, multiplies by w_n^(j k1) (two entries
   of the four-step's table W[k1 NB + j] a thread, the rest by products)
   and writes the result back in place;
2. rows, after the cluster's barrier: block r takes its NA / C rows k1,
   a group of NB/8 warps 32 of them, one a lane, reads each row's NB
   values from the cluster's tiles (distributed shared memory), runs the
   NB-point FFT with its exchanges in place in the tile (one block) or
   in a staging area (a cluster), and stores X[k1 + NA k2] in natural
   order, a warp's store a run of 32 consecutive k1; the inverse's 1/n
   is applied here.

A tile's element (e, jl) lies at jl NA + (e ^ (jl & 31)), or at 8192
at e J + (jl ^ (e & 31)) (:func:`tile_at`), so every shared access of a
warp touches 32 banks and, in a cluster, a warp's read of another
block's tile is one 128-byte run. ``fft_pencil``,
``fft_matmul`` and ``fft_block`` run it through :func:`launch` (16 bytes
an element of device memory); ``fft_twiddle_transpose`` through
:func:`launch_fused`: the same kernel scales, applies the twiddle planes
and writes a scratch of at most :data:`SCRATCH_ELEMS` elements a plane
in natural (l, j, k) order, then a tiled transpose (32 x 32 tiles
through shared rows of 33 floats) stores out[l, k, j] in runs of 32
consecutive j (32 bytes an element, 40 with twiddle planes). Each
counts the launch in its own module. The pure functions below mirror
the C side's sizes (``long_smem_bytes``, ``long_threads``,
``long_cluster``, ``long_scratch_bytes``, ``long_hbm_bytes``);
``chip_smoke.py``'s ``[long]`` phase checks them equal.
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
#: sub-FFTs a group of warps takes: one a lane
LANES = 32
#: the fused kernel's scratch, elements a plane: it runs on chunks of at
#: most this many elements
SCRATCH_ELEMS = 1 << 24
#: the transpose's tile side and the threads of its block
TILE = 32
TRANSPOSE_THREADS = TILE * 8
#: static shared bytes of a transpose block: both planes' tiles, rows of
#: TILE + 1 floats
TRANSPOSE_SMEM_BYTES = 2 * TILE * (TILE + 1) * 4


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


def cluster(n: int) -> int:
    """Blocks a pencil of n: one at 8192 and 16384 (64 and 128 KiB), a
    cluster of 2 at 32768 and 4 at 65536 (128 KiB a block)."""
    return max(1, n >> 14)


def threads(n: int) -> int:
    """Threads a block runs: a group of NA/8 (columns) or NB/8 (rows)
    warps takes 32 sub-FFTs, so 512 where NA = 128 (8192 and 16384: two
    blocks an SM at 8192, and at 16384 up to 128 registers a thread,
    where 1024 threads spilled), 1024 where NA = 256."""
    return 512 if n <= 16384 else 1024


def row_major(n: int) -> bool:
    """Whether the tile is row-major at n (``Long<LOG2N>::ROW_MAJOR``):
    at 8192 only, where one block holds the pencil and its column loads
    go by ``cp.async`` (:func:`async_loads`); a cluster's tiles are
    column-major, so a remote read is one run."""
    return n == 8192


def async_loads(n: int) -> bool:
    """Whether the column loads go by ``cp.async`` into the tile
    (``Long<LOG2N>::ASYNC``): at 8192 only."""
    return n == 8192


def tile_at(e, jl, n: int):
    """Offset of element (e, jl) in a plane of a tile of pencils of n
    (``tile_at`` in ``csrc/fft_long.cu``): column-major, column jl a run
    of NA floats and the column's five low bits XOR the row index, so
    lanes that differ in e read one 128-byte run; row-major at 8192
    (:func:`row_major`), row e a run of J floats and the row's five low
    bits XOR the column index. Either way 32 lanes that differ in either
    index touch 32 banks. Takes ints or integer tensors."""
    if row_major(n):
        return e * (factors(n)[1] // cluster(n)) + (jl ^ (e & 31))
    return jl * factors(n)[0] + (e ^ (jl & 31))


def plan(n: int) -> dict:
    """The kernel's compile-time plan for pencils of n (``Long<LOG2N>``):
    the split, the cluster C, columns J and rows KA a block, warps TA
    and TB of a column and a row group, groups GA and GB a block, column
    rounds a group, floats of a tile's plane and of the rows' staging
    (clusters only)."""
    na, nb = factors(n)
    c = cluster(n)
    warps = threads(n) // 32
    ta, tb = na // 8, nb // 8
    ga, gb = warps // ta, warps // tb
    return dict(NA=na, NB=nb, C=c, J=nb // c, KA=na // c, TA=ta, TB=tb, GA=ga, GB=gb,
                ROUNDS=nb // c // LANES // ga, TILE=na * (nb // c),
                STAGE=2 * gb * LANES * nb if c > 1 else 0)


def smem_bytes(n: int) -> int:
    """Shared bytes a block takes for pencils of n (the C function
    ``long_smem_bytes``): the tile's two planes (NA x NB / C floats
    each) and, in a cluster, the rows' staging (32 rows of NB a group,
    two planes)."""
    p = plan(n)
    return 4 * (2 * p['TILE'] + p['STAGE'])


def hbm_bytes_per_elem(fused: bool, twiddle: bool = False) -> int:
    """Device-memory bytes a launch moves an element (``long_hbm_bytes``):
    16, the function's own (read x, write y); the fused kernel's scratch
    16 more, its twiddle planes 8 more."""
    return 16 + (16 + (8 if twiddle else 0) if fused else 0)


def chunk_pencils(n: int, pencils: int) -> int:
    """Pencils a chunk of the fused kernel's launches holds."""
    return min(pencils, max(1, SCRATCH_ELEMS // n))


def scratch_bytes(n: int, pencils: int, fused: bool) -> int:
    """Scratch bytes a launch on ``pencils`` pencils of n takes (the C
    function ``long_scratch_bytes``): two planes of one chunk for the
    fused kernel, none for the others (they store the output directly)."""
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
    for fn, args, res in (('long_smem_bytes', [ctypes.c_int], ctypes.c_longlong),
                          ('long_threads', [ctypes.c_int], ctypes.c_int),
                          ('long_cluster', [ctypes.c_int], ctypes.c_int),
                          ('long_transpose_smem_bytes', [], ctypes.c_longlong),
                          ('long_scratch_bytes', [ctypes.c_int, ctypes.c_longlong,
                                                  ctypes.c_int], ctypes.c_longlong),
                          ('long_hbm_bytes', [ctypes.c_int] * 2, ctypes.c_int),
                          ('long_occupancy', [ctypes.c_int] * 2
                           + [ctypes.POINTER(ctypes.c_int)] * 3, ctypes.c_int)):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res
    return lib


def launch(re: torch.Tensor, im: torch.Tensor, yr: torch.Tensor, yi: torch.Tensor,
           n: int, inverse: bool) -> int:
    """The single-pass kernel on contiguous fp32 planes (..., n) into
    (yr, yi), on the current stream; the CUDA error (a refused cluster
    launch or shared-memory request included)."""
    t = tables(n, inverse, re.device)
    return lib().fft_long_launch(re.data_ptr(), im.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                                 *(a.data_ptr() for a in t), re.numel() // n, n,
                                 -1.0 if inverse else 1.0, (1.0 / n) if inverse else 1.0,
                                 stream_of(re))


def launch_fused(re: torch.Tensor, im: torch.Tensor, twr, twi, wstride: int,
                 yr: torch.Tensor, yi: torch.Tensor, n: int, inverse: bool) -> int:
    """``fft_twiddle_transpose`` on rows (..., b, n) into (yr, yi) of
    (..., n, b), the twiddle planes (``twr``, ``twi``) as
    ``fft_fused._twiddle_planes`` gives them or None: the single-pass
    kernel into a scratch of :func:`scratch_bytes` allocated here, then
    the tiled transpose, a chunk at a time; the CUDA error."""
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
    card: the body, its split, blocks a pencil (the cluster), threads,
    shared bytes, blocks an SM, clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``) and registers a thread of the
    single-pass kernel, the scratch bytes the fused wrapper allocates and
    the device-memory bytes an element without twiddle planes
    (:func:`hbm_bytes_per_elem`)."""
    p, r, c = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = lib().long_occupancy(n, int(fused), ctypes.byref(p), ctypes.byref(r),
                               ctypes.byref(c))
    if err:
        raise RuntimeError(f"long body: occupancy query failed with CUDA error {err}")
    return dict(variant='long', factors='x'.join(map(str, factors(n))), cluster=cluster(n),
                threads=threads(n), smem_bytes=smem_bytes(n), blocks_per_sm=p.value,
                clusters_per_device=c.value, registers=r.value,
                scratch_bytes=scratch_bytes(n, batch, fused),
                hbm_bytes_per_elem=hbm_bytes_per_elem(fused))
