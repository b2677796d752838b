"""Block-complex four-step pencil FFT: the CUDA kernel and its plain version.

Replaces ``repro.kernels.fft_block.fft_block``
(src/repro/kernels/fft_block.py:49). Three bodies, chosen by the pencil
length alone (:func:`variant`):

* ``'mma'`` (``csrc/fft_block.cu``, 64 <= n <= 4096): the dense
  products on the tensor cores, ``mma.sync`` m16n8k8 in 3xTF32, with the
  twiddles applied between them in registers; the split tables go to the
  card in the mma fragment order (:func:`frag_a`, :func:`frag_b`). For
  64 <= n <= 1024 ``block_mma_kernel`` runs the two-factor four-step
  n = n1 * n2 against F1b and the block F2
  (``core/fft1d.py:block_mma_tables``); for n = 2048 and 4096
  ``block_mma3_kernel`` runs three products against the 16-point F1b
  (twice) and the block F of n3 = n / 256 points
  (``core/fft1d.py:block_mma3_tables``). :func:`mma_factors` names the
  split;
* ``'long'`` (``csrc/fft_long.cu``, 4096 < n <= 65536): the
  single-pass body of :mod:`._long` that all four kernels share, the four-step over
  ``four_step_factors(n)``, on the two planes of the stacked
  (2, ..., n) form, fp32 on the CUDA cores;
* ``'fma'`` (``block_kernel``, n <= 32, and timed beside the
  tensor-core body through ``_launch(..., _body='fma')``): fp32 FMA on
  the CUDA cores against the TPU kernel's F1b and G (the twiddle folded
  into F2).

A CUDA or ``meta`` operand of n > 65536 raises ``ValueError``. The C
entries take separate re/im planes, so the stacked form
:func:`fft_block` passes ``x[0]``/``x[1]`` and the planar form
:func:`fft_block_planar` its pair, neither with a stack copy. The
function's bound is the FFT's 16 bytes per element.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fft1d as f1
from repro_torch.core import twiddle as tw
from repro_torch.core.twiddle import Planar
from repro_torch.kernels import _build, _long, check_planar, refuse_grad, report, stream_of
from repro_torch.kernels.fft_pencil import tile_pencils

#: launches of any CUDA body (plain-version calls do not count)
launches = 0
#: of those, launches of the tensor-core body
launches_mma = 0
#: of those, launches of the long body
launches_long = 0

#: the pencil lengths the tensor-core body takes, inclusive: the two-factor
#: split (n2 >= 8) up to 1024, the three-factor one above
MMA_LENGTHS = (64, 4096)
#: the lengths on the three-factor split 16 * 16 * n3
MMA3_LENGTHS = (2048, 4096)


def variant(n: int) -> str:
    """The body a CUDA launch of length-n pencils runs: ``'mma'`` for
    64 <= n <= 4096, ``'long'`` for 4096 < n <= 65536, ``'fma'`` for
    n <= 32; ``ValueError`` above 65536."""
    _long.check_length('fft_block', n)
    if MMA_LENGTHS[0] <= n <= MMA_LENGTHS[1]:
        return 'mma'
    return 'long' if _long.takes(n) else 'fma'


def mma_factors(n: int) -> tuple:
    """The split the tensor-core body runs for pencils of n: (16, 16,
    n / 256) for :data:`MMA3_LENGTHS`, else the four-step's (n1, n2)."""
    return (16, 16, n // 256) if n in MMA3_LENGTHS else tw.four_step_factors(n)


def fft_block_plain(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`fft_block`: the reference-tier
    block four-step along the last axis of a stacked (2, ..., n)."""
    return f1.fft_four_step_block(x, -1, inverse=inverse)


# ---------------------------------------------------------------------------
# Tables in the m16n8k8 fragment order
# ---------------------------------------------------------------------------

def frag_a(a: torch.Tensor) -> torch.Tensor:
    """A (..., M, K) as m16n8k8 A fragments: for m-tile mi, k-step s and
    lane 4 g + t, the four floats a0..a3 = A[16 mi + g, 8 s + t],
    A[16 mi + g + 8, 8 s + t], A[16 mi + g, 8 s + t + 4],
    A[16 mi + g + 8, 8 s + t + 4], flat in (mi, s, lane, reg) order."""
    *lead, m, k = a.shape
    t = a.reshape(*lead, m // 16, 2, 8, k // 8, 2, 4)      # mi, hr, g, s, hk, t
    nl = len(lead)
    t = t.permute(*range(nl), *(nl + i for i in (0, 3, 2, 5, 4, 1)))
    return t.reshape(*lead, -1)


def frag_b(b: torch.Tensor) -> torch.Tensor:
    """B (..., K, N) as m16n8k8 B fragments: for k-step s, n-tile nj and
    lane 4 g + t, the two floats b0, b1 = B[8 s + t, 8 nj + g],
    B[8 s + t + 4, 8 nj + g], flat in (s, nj, lane, reg) order."""
    *lead, k, n = b.shape
    t = b.reshape(*lead, k // 8, 2, 4, n // 8, 8)          # s, hk, t, nj, g
    nl = len(lead)
    t = t.permute(*range(nl), *(nl + i for i in (0, 3, 4, 2, 1)))
    return t.reshape(*lead, -1)


def mma_rows(n1: int) -> torch.Tensor:
    """The order of F1b's rows (c, j1) = c n1 + j1 in the mma body: each
    16-row m-tile holds 8 j1 of c = 0, then the same 8 j1 of c = 1, so
    the real and imaginary part of one output land in one thread."""
    return torch.arange(2 * n1).reshape(2, n1 // 8, 8).permute(1, 0, 2).reshape(-1)


@functools.lru_cache(maxsize=None)
def mma_tables(n1: int, n2: int, inverse: bool, device: torch.device):
    """(F1b, F2b, W) as the mma body reads them: F1b's 3xTF32 pair with
    rows in :func:`mma_rows` order as A fragments, F2b's pair as B
    fragments, each [big, small] flat and contiguous; W planar fp32."""
    f1b, f2b, w = f1.block_mma_tables(n1, n2, inverse, device)
    fa = frag_a(f1b[:, mma_rows(n1).to(device)]).contiguous()
    return fa, frag_b(f2b).contiguous(), w


@functools.lru_cache(maxsize=None)
def mma3_tables(n3: int, inverse: bool, device: torch.device):
    """(F1b, F3b, W) as the three-factor body reads them for n = 16 * 16 *
    n3: :func:`mma_tables` of (16, n3), the 16-point F1b (both left
    products) and the n3-point block F, and W2 (2, 16, n3) followed by
    W1 (2, 16, 16 n3) of ``core/fft1d.py:block_mma3_tables`` in one flat
    fp32 table."""
    fa, fb, w2 = mma_tables(16, n3, inverse, device)
    w1 = f1.block_mma3_tables(n3, inverse, device)[3]
    return fa, fb, torch.cat([w2.reshape(-1), w1.reshape(-1)])


def mma_tables_for(n: int, inverse: bool, device: torch.device):
    """What the tensor-core body reads for pencils of n: (fa, fb, w) of
    :func:`mma3_tables` or :func:`mma_tables`, by :func:`mma_factors`."""
    f = mma_factors(n)
    return mma3_tables(f[2], inverse, device) if len(f) == 3 else mma_tables(*f, inverse, device)


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load('fft_block')
    _build.declare(lib, 'fft_block_launch', 6,
                   (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float))
    _build.declare(lib, 'fft_block_mma_launch', 7,
                   (ctypes.c_longlong, ctypes.c_int, ctypes.c_float))
    lib.fft_block_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fft_block_smem_bytes.restype = ctypes.c_longlong
    lib.fft_block_slices.argtypes = [ctypes.c_int] * 3
    lib.fft_block_slices.restype = ctypes.c_int
    lib.fft_block_mma_pencils.argtypes = [ctypes.c_int]
    lib.fft_block_mma_pencils.restype = ctypes.c_int
    lib.fft_block_mma_smem_bytes.argtypes = [ctypes.c_int]
    lib.fft_block_mma_smem_bytes.restype = ctypes.c_longlong
    lib.fft_block_blocks_per_sm.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
    lib.fft_block_blocks_per_sm.restype = ctypes.c_int
    return lib


def _shape(n: int, batch: int, body: str):
    """(n1, n2, pencils a tile, G slices, shared bytes a block) of a
    launch of ``body`` on ``batch`` pencils of n."""
    n1, n2 = tw.four_step_factors(n)
    lib = _lib()
    if body == 'mma':
        return n1, n2, lib.fft_block_mma_pencils(n), 0, lib.fft_block_mma_smem_bytes(n)
    P = tile_pencils(n, batch)
    jc = lib.fft_block_slices(n1, n2, P)
    if jc == 0:
        raise ValueError(
            f"fft_block: n={n} does not fit one block: {P} pencil(s) and one G slice "
            f"need {lib.fft_block_smem_bytes(n1, n2, P, 1)} bytes of shared memory")
    return n1, n2, P, jc, lib.fft_block_smem_bytes(n1, n2, P, jc)


def launch_info(n: int, batch: int) -> dict:
    """What a launch on ``batch`` pencils of n runs on the current card:
    its body, the factors of n it runs, pencils a tile, shared bytes a
    block and blocks an SM; for the long body
    :func:`repro_torch.kernels._long.launch_info`'s fields."""
    body = variant(n)
    if body == 'long':
        return _long.launch_info(n, batch)
    n1, n2, P, _, smem = _shape(n, batch, body)
    per_sm = ctypes.c_int(0)
    err = _lib().fft_block_blocks_per_sm(int(body == 'mma'), n, smem, ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f"fft_block: occupancy query failed with CUDA error {err}")
    factors = mma_factors(n) if body == 'mma' else (n1, n2)
    return dict(variant=body, factors='x'.join(map(str, factors)), pencils_per_tile=P,
                smem_bytes=smem, blocks_per_sm=per_sm.value)


def _launch(re: torch.Tensor, im: torch.Tensor, yr: torch.Tensor, yi: torch.Tensor,
            n: int, inverse: bool, _body: str | None = None) -> None:
    """Run the kernel on contiguous fp32 planes (..., n) into (yr, yi).
    The body is :func:`variant` of n; ``_body`` overrides it only to time
    the CUDA-core body beside the tensor-core one."""
    global launches, launches_mma, launches_long
    body = _body or variant(n)
    batch = re.numel() // n
    if batch == 0:
        return
    if re.device.type == 'meta':
        report('fft_block', body, n, batch)
        return
    if body == 'long':
        P, smem = f"1/{_long.cluster(n)}", _long.smem_bytes(n)
    else:
        n1, n2, P, jc, smem = _shape(n, batch, body)
    scale = (1.0 / n) if inverse else 1.0
    ptrs = (re.data_ptr(), im.data_ptr(), yr.data_ptr(), yi.data_ptr())
    with torch.cuda.device(re.device):
        if body == 'long':
            err = _long.launch(re, im, yr, yi, n, inverse)
        elif body == 'mma':
            fa, fb, w = mma_tables_for(n, inverse, re.device)
            err = _lib().fft_block_mma_launch(*ptrs, fa.data_ptr(), fb.data_ptr(),
                                              w.data_ptr(), batch, n, scale, stream_of(re))
        else:
            f1b, g = f1.block_tables(n1, n2, inverse, re.device)
            err = _lib().fft_block_launch(*ptrs, f1b.data_ptr(), g.data_ptr(), batch,
                                          n1, n2, P, jc, scale, stream_of(re))
    if err:
        raise RuntimeError(
            f"fft_block: {body} launch failed with CUDA error {err} (n={n}, {P} pencils "
            f"per tile, {smem} bytes of shared memory)")
    launches += 1
    launches_mma += body == 'mma'
    launches_long += body == 'long'
    report('fft_block', body, n, batch)


def fft_block(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Batched block-complex FFT along the last axis of a contiguous fp32
    (2, ..., n) whose leading axis holds (re, im); natural order.

    A CPU tensor runs :func:`fft_block_plain`; a CUDA tensor launches
    the kernel (or raises); a ``meta`` tensor returns the card's shape."""
    if x.ndim < 2 or x.shape[0] != 2:
        raise ValueError(f"fft_block: needs a leading complex axis of 2, got {tuple(x.shape)}")
    n = check_planar('fft_block', x[0], x[1])
    if x.device.type == 'cpu':
        return fft_block_plain(x, inverse=inverse)
    refuse_grad('fft_block', x)
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
    refuse_grad('fft_block', re, im)
    yr, yi = torch.empty_like(re), torch.empty_like(im)
    _launch(re, im, yr, yi, n, inverse)
    return yr, yi
