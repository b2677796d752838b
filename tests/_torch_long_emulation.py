"""A torch emulation of the long body on the CPU.

``long_column_kernel``, ``long_row_kernel`` and ``long_fused_row_kernel``
(``src/repro_torch/csrc/fft_long.cu``) run only on the card. This module
repeats, in fp32 torch and in the kernels' order, what their blocks do
for pencils of 4096 < n <= 65536, split n = NA * NB by
``four_step_factors``:

* pass 1: a block takes ``COLS`` consecutive columns j of one pencil;
  each column's NA-point FFT runs on the radix-8 register passes of
  ``tests/_torch_stockham_emulation.py`` (the exchange rows at the
  kernel's stride, one row a column), the result is multiplied by
  w_n^(j k1) from the fp32 table W[k1 NB + j] and staged in a NaN-filled
  shared plane of ``_long.smem_bytes(n, 1)`` bytes, rows of NA +
  ``STAGE_PAD`` floats, whose read-out is the block's run of y[j NA + k1];
* pass 2: a block takes ``COLS`` consecutive k1, runs the NB-point FFT
  over y[j NA + k1] and writes y[k2 NA + k1], scaled, in place;
* the fused kernel's pass 2 reads pass 1's result from a scratch of one
  chunk (``_long.chunk_pencils``), scales, applies the twiddle plane as
  the wrapper passes it (``fft_fused._twiddle_planes``: element
  (l, j, k) at ``l * wstride + j * n + k``) and stores out[l, k, j].

Every exchange plane is checked to fit the pass's shared bytes.
``tests/test_torch_long_pencils.py`` holds it against the plain
versions, ``np.fft`` and the JAX package's Pallas kernels.
"""
import math

import torch

from repro_torch.core import twiddle as tw
from repro_torch.kernels import _long
from repro_torch.kernels import fft_fused as tkf
from repro_torch.kernels import fft_pencil as tkp

from _torch_stockham_emulation import run_passes

COLS = _long.COLS


def _exchange_plane(m: int) -> int:
    """Floats a plane of one exchange buffer of COLS m-point sub-FFTs."""
    T = tkp.radix8_threads(m)
    return COLS * (m + (T if T < 32 else 0))


def _sub_ffts(re: torch.Tensor, im: torch.Tensor, m: int, inverse: bool, pass_: int, n: int):
    """The m-point FFT of each row of (blocks, COLS, m) on the radix-8
    passes, with a block's COLS rows at the kernel's exchange stride."""
    plane = _exchange_plane(m)
    buffers = min(2, len(tkp.radix8_passes(m)) - 1)
    assert buffers * 2 * plane * 4 <= _long.smem_bytes(n, pass_)
    T = tkp.radix8_threads(m)
    blocks = re.shape[0]
    v = [tuple(a.reshape(blocks, COLS, 8, T)[:, :, j] for a in (re, im)) for j in range(8)]
    v = run_passes(v, m, inverse, plane, COLS)          # value q: output t + T q
    return tuple(torch.stack([v[q][c] for q in range(8)], 2).reshape(blocks, COLS, m)
                 for c in (0, 1))


def column_pass(re: torch.Tensor, im: torch.Tensor, inverse: bool = False):
    """Pass 1 on (pencils, n): y[j NA + k1], twiddled."""
    pencils, n = re.shape
    na, nb = _long.factors(n)
    tiles = nb // COLS
    cols = [a.reshape(pencils, na, tiles, COLS).permute(0, 2, 3, 1).reshape(-1, COLS, na)
            for a in (re, im)]
    vr, vi = _sub_ffts(*cols, na, inverse, 1, n)
    wr, wi = (torch.from_numpy(a).float() for a in tw.four_step_twiddle_np(na, nb,
                                                                          inverse=inverse))
    # column j = tile COLS + c reads W[k1 NB + j]
    tr, ti = (w.t().reshape(1, tiles, COLS, na).expand(pencils, -1, -1, -1).reshape(-1, COLS, na)
              for w in (wr, wi))
    ur, ui = vr * tr - vi * ti, vr * ti + vi * tr
    # the staging rows: row c at c * LDS, the im plane after COLS rows
    lds = na + _long.STAGE_PAD
    stage = torch.full((ur.shape[0], _long.smem_bytes(n, 1) // 4), math.nan)
    assert 2 * COLS * lds <= stage.shape[1]
    addr = (torch.arange(COLS) * lds)[:, None] + torch.arange(na)
    stage[:, addr] = ur
    stage[:, COLS * lds + addr] = ui
    i = torch.arange(COLS * na)
    read = (i // na) * lds + i % na
    return tuple(stage[:, off + read].reshape(pencils, n) for off in (0, COLS * lds))


def _row_ffts(yr: torch.Tensor, yi: torch.Tensor, n: int, inverse: bool):
    """Pass 2's sub-FFTs on y (pencils, n): X[k1 + NA k2] as (pencils, n)."""
    pencils = yr.shape[0]
    na, nb = _long.factors(n)
    tiles = na // COLS
    cols = [a.reshape(pencils, nb, tiles, COLS).permute(0, 2, 3, 1).reshape(-1, COLS, nb)
            for a in (yr, yi)]
    vr, vi = _sub_ffts(*cols, nb, inverse, 2, n)
    # block (pencil, tile), row c = k1 - tile COLS, element k2 -> y[k2 NA + k1]
    return tuple(v.reshape(pencils, tiles, COLS, nb).permute(0, 3, 1, 2).reshape(pencils, n)
                 for v in (vr, vi))


def emulate_long(re: torch.Tensor, im: torch.Tensor, inverse: bool = False):
    """``fft_long_launch`` (``fft_pencil``, ``fft_matmul``, ``fft_block``)
    on planar fp32 (..., n)."""
    n = re.shape[-1]
    assert _long.takes(n)
    yr, yi = column_pass(re.reshape(-1, n), im.reshape(-1, n), inverse)
    scale = torch.tensor(1.0 / n if inverse else 1.0, dtype=torch.float32)
    return tuple((v * scale).reshape(re.shape) for v in _row_ffts(yr, yi, n, inverse))


def emulate_fused_long(re: torch.Tensor, im: torch.Tensor, wr=None, wi=None,
                       inverse: bool = False):
    """``fft_fused_long_launch`` on planar fp32 (..., b, n) -> (..., n, b),
    chunk by chunk of ``_long.chunk_pencils`` pencils."""
    *lead, b, n = re.shape
    assert _long.takes(n)
    nl = math.prod(lead)
    pencils = nl * b
    twr, twi, wstride = tkf._twiddle_planes(re, wr, wi)
    w = None if twr is None else [a.reshape(-1) for a in (twr, twi)]
    scale = torch.tensor(1.0 / n if inverse else 1.0, dtype=torch.float32)
    x = [a.reshape(pencils, n) for a in (re, im)]
    out = [torch.full((nl, n, b), math.nan) for _ in range(2)]
    chunk = _long.chunk_pencils(n, pencils)
    k = torch.arange(n)
    for g0 in range(0, pencils, chunk):
        m = min(chunk, pencils - g0)
        scratch = column_pass(x[0][g0:g0 + m], x[1][g0:g0 + m], inverse)
        ur, ui = (v * scale for v in _row_ffts(*scratch, n, inverse))
        g = torch.arange(g0, g0 + m)
        l, j = g // b, g % b
        if w is not None:
            at = (l * wstride + j * n)[:, None] + k
            tr, ti = w[0][at], w[1][at]
            ur, ui = ur * tr - ui * ti, ur * ti + ui * tr
        for o, v in zip(out, (ur, ui)):
            o[l[:, None], k, j[:, None]] = v
    return tuple(o.reshape(*lead, n, b) for o in out)
