"""A torch emulation of the radix-8 Stockham body on the CPU.

``radix8_pencil_kernel`` and ``radix8_fused_kernel``
(``src/repro_torch/csrc/fft_pencil.cu``) run only on the card. This
module repeats, in fp32 torch and in the kernels' order, what every
thread of a block does: the pass plan (:func:`fft_pencil.radix8_passes`),
the mapping of thread t to elements t + T*j, the per-pass twiddles read
from the host table (:func:`fft_pencil.radix8_tables`) at the kernel's
indices, the radix-2/4/8 DFTs with their constants, each exchange
written to and read from a flat shared plane at the kernel's swizzled
addresses (planes filled with NaN, sized by the layout functions, so an
address that no thread wrote, or one past the plane, shows), and, for
the fused kernel, the scale, the twiddle, the staging rows and the
transposed read-out with its ragged last tile.
``tests/test_torch_stockham_radix.py`` holds it against the plain
versions and the JAX kernels.
"""
import math

import torch

from repro_torch.kernels import fft_fused as tkf
from repro_torch.kernels import fft_pencil as tkp

C8 = 0.70710678118654752  # 1/sqrt(2), rounded to fp32 by the multiply as in the kernel


def swizzle(i: torch.Tensor, ns: int, r: int) -> torch.Tensor:
    """Where the kernel stores index i written by a pass of span ns."""
    if ns >= 32:
        return i
    return i ^ (((i // (ns * r)) & (32 // ns - 1)) * ns)


def _dft4(x, s):
    (r0, i0), (r1, i1), (r2, i2), (r3, i3) = x
    a0r, a0i, a1r, a1i = r0 + r2, i0 + i2, r0 - r2, i0 - i2
    a2r, a2i, dr, di = r1 + r3, i1 + i3, r1 - r3, i1 - i3
    a3r, a3i = s * di, -s * dr
    return [(a0r + a2r, a0i + a2i), (a1r + a3r, a1i + a3i),
            (a0r - a2r, a0i - a2i), (a1r - a3r, a1i - a3i)]


def dft(x, s):
    """The kernel's in-register DFT of the R (re, im) pairs in ``x``."""
    if len(x) == 2:
        (r0, i0), (r1, i1) = x
        return [(r0 + r1, i0 + i1), (r0 - r1, i0 - i1)]
    if len(x) == 4:
        return _dft4(x, s)
    e, o = _dft4(x[0::2], s), _dft4(x[1::2], s)
    c = torch.tensor(C8, dtype=torch.float32)
    (xr, yi) = o[1]
    o[1] = ((xr + s * yi) * c, (yi - s * xr) * c)
    (xr, yi) = o[2]
    o[2] = (s * yi, -s * xr)
    (xr, yi) = o[3]
    o[3] = ((s * yi - xr) * c, (-s * xr - yi) * c)
    return ([(e[q][0] + o[q][0], e[q][1] + o[q][1]) for q in range(4)]
            + [(e[q][0] - o[q][0], e[q][1] - o[q][1]) for q in range(4)])


def run_passes(v, n: int, inverse: bool, plane: int, P: int):
    """Every pass on blocks of P pencils. ``v[j]`` is the (re, im) pair
    of shape (blocks, P, T) thread t of pencil p holds as value j; the
    result has the same form, value j being output t + T*j."""
    R0, T = min(8, n), tkp.radix8_threads(n)
    ld = n + (T if T < 32 else 0)
    twr, twi = (torch.from_numpy(a) for a in tkp.radix8_tables_np(n, inverse))
    s = -1.0 if inverse else 1.0
    t = torch.arange(T)
    row = (torch.arange(P) * ld)[:, None]
    blocks = v[0][0].shape[0]
    radices = tkp.radix8_passes(n)
    ns, prev = 1, None
    for k, r in enumerate(radices):
        if prev is not None:                 # read back the exchange
            buf = bufs[(k - 1) % 2]
            v = [tuple(b[:, row + swizzle(t + T * j, *prev)] for b in buf)
                 for j in range(R0)]
        G = R0 // r
        for g in range(G):
            x = [v[g + G * m] for m in range(r)]
            if ns > 1:
                kk = (t + T * g) & (ns - 1)
                for m in range(1, r):
                    w = ns - 1 + (m - 1) * ns + kk
                    wr, wi = twr[w], twi[w]
                    xr, xi = x[m]
                    x[m] = (xr * wr - xi * wi, xr * wi + xi * wr)
            y = dft(x, s)
            for m in range(r):
                v[g + G * m] = y[m]
        if k + 1 < len(radices):             # write the exchange
            if k == 0:
                bufs = [tuple(torch.full((blocks, plane), math.nan) for _ in range(2))
                        for _ in range(2)]
            buf = bufs[k % 2]
            for g in range(G):
                tp = t + T * g
                base = (tp // ns) * ns * r + (tp & (ns - 1))
                for q in range(r):
                    addr = row + swizzle(base + q * ns, ns, r)
                    for b, val in zip(buf, v[g + G * q]):
                        b[:, addr] = val
            prev = (ns, r)
        ns *= r
    return v


def _load(x: torch.Tensor, P: int, n: int):
    """(pencils, n) -> per value j, (blocks, P, T): zero past the batch."""
    R0, T = min(8, n), tkp.radix8_threads(n)
    pencils = x.shape[0]
    blocks = -(-pencils // P)
    xp = torch.zeros(blocks * P, n)
    xp[:pencils] = x
    xp = xp.view(blocks, P, R0, T)           # element t + T*j
    return [xp[:, :, j] for j in range(R0)]


def _plane(n: int, P: int, fused: bool) -> int:
    smem = tkp.radix8_smem_bytes(n, P, fused)
    buffers = min(2, len(tkp.radix8_passes(n)) - 1 + int(fused))
    return smem // (buffers * 2 * 4) if buffers else 0


def emulate_pencil(re: torch.Tensor, im: torch.Tensor, inverse: bool = False):
    """``radix8_pencil_kernel`` on planar fp32 (..., n)."""
    n = re.shape[-1]
    pencils = re.numel() // n
    P = tkp.radix8_layout(n, pencils)[0]
    parts = zip(_load(re.reshape(-1, n), P, n), _load(im.reshape(-1, n), P, n))
    v = run_passes(list(parts), n, inverse, _plane(n, P, False), P)
    scale = torch.tensor(1.0 / n if inverse else 1.0, dtype=torch.float32)
    out = [torch.stack([v[j][c] for j in range(len(v))], 2) * scale for c in (0, 1)]
    return tuple(o.reshape(-1, n)[:pencils].reshape(re.shape) for o in out)


def emulate_fused(re: torch.Tensor, im: torch.Tensor, wr=None, wi=None,
                  inverse: bool = False):
    """``radix8_fused_kernel`` on planar fp32 (..., b, n) -> (..., n, b),
    with an optional twiddle broadcastable to the input, read as the
    kernel reads it: the flat planes and slice stride the wrapper passes
    (``fft_fused._twiddle_planes``), element (l, j, k) at
    ``l * wstride + j * n + k``."""
    *lead, b, n = re.shape
    nl = math.prod(lead)
    P = tkf.tile_layout(n, b)[0]
    R0, T = min(8, n), tkp.radix8_threads(n)
    plane = _plane(n, P, True)
    tiles = -(-b // P)
    lds = n + 32 // P
    out = [torch.full((nl, n, b), math.nan) for _ in range(2)]
    x = [a.reshape(nl, b, n) for a in (re, im)]
    twr, twi, wstride = tkf._twiddle_planes(re, wr, wi)
    w = None if twr is None else [a.reshape(-1) for a in (twr, twi)]
    scale = torch.tensor(1.0 / n if inverse else 1.0, dtype=torch.float32)
    t = torch.arange(T)
    for tile in range(tiles):               # one block per (slice, tile)
        j0 = tile * P
        rows = min(P, b - j0)
        v = []
        for j in range(R0):
            pair = []
            for c in (0, 1):
                xp = torch.zeros(nl, P, n)       # rows past b stay 0
                xp[:, :rows] = x[c][:, j0:j0 + rows]
                pair.append(xp.view(nl, P, R0, T)[:, :, j])
            v.append(tuple(pair))
        v = run_passes(v, n, inverse, plane, P)
        stage = [torch.full((nl, plane), math.nan) for _ in range(2)]
        for j in range(R0):
            ur, ui = v[j][0] * scale, v[j][1] * scale
            if w is not None:
                tr, ti = torch.zeros(nl, P, T), torch.zeros(nl, P, T)
                at = (torch.arange(nl)[:, None, None] * wstride
                      + ((j0 + torch.arange(rows)) * n)[None, :, None] + (t + T * j))
                tr[:, :rows] = w[0][at]
                ti[:, :rows] = w[1][at]
                ur, ui = ur * tr - ui * ti, ur * ti + ui * tr
            addr = (torch.arange(P) * lds)[:, None] + t + T * j
            stage[0][:, addr], stage[1][:, addr] = ur, ui
        i = torch.arange(P * n)
        k, q = i // P, i % P
        keep = q < rows
        for o, st in zip(out, stage):
            o[:, k[keep], j0 + q[keep]] = st[:, q[keep] * lds + k[keep]]
    return tuple(o.reshape(*lead, n, b) for o in out)
