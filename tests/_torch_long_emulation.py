"""A torch emulation of the long body on the CPU.

``long_kernel`` and ``long_transpose_kernel``
(``src/repro_torch/csrc/fft_long.cu``) run only on the card. This module
repeats, in fp32 torch and in the kernels' order, what their blocks do
for pencils of 4096 < n <= 65536, split n = NA * NB by
``four_step_factors``:

* the cluster: C = ``_long.cluster(n)`` blocks a pencil, block r holding
  the slab of columns j in [r J, r J + J), J = NB / C, in its shared
  memory, modelled as a flat NaN-filled plane of ``_long.smem_bytes(n)``
  bytes a block (the tile's re plane, its im plane, then the rows'
  staging), element (e, jl) of a tile at ``_long.tile_at`` (row-major
  at 8192, column-major above);
* columns: at 8192 the loads are ``cp.async`` copies into the tile,
  read back by the thread that made them (elsewhere they go to
  registers); a group of NA/8 warps, one column a lane, warp t thread t of
  the column's radix-8 passes (the arithmetic of
  ``tests/_torch_stockham_emulation.py``), each exchange in place in
  the tile: a pass reads, the positions it read are set to NaN (dead
  once the group has passed its barrier), then it writes; the four-step
  twiddle from two table entries a thread and its products, written
  back in place;
* rows: block r's rows k1 in [r KA, r KA + KA), a group of NB/8 warps,
  one row a lane, reading each row from the tiles of the blocks that
  hold its columns (distributed shared memory), exchanging in place in
  the tile (C = 1) or in the group's staging rows, set to NaN at every
  round (C > 1); the store of X[k1 + NA k2], scaled;
* the fused route: the same kernel scales, applies the twiddle planes as
  the wrapper passes them (``fft_fused._twiddle_planes``: element
  (l, j, k) at ``l * wstride + j * n + k``) and writes a scratch of one
  chunk (``_long.chunk_pencils``) in natural order; the tiled transpose
  moves 32 pencils x 32 k through a NaN-filled shared tile of rows of 33
  floats into out[l, k, j].

Every shared access can be recorded in ``trace`` as (name, offsets),
the offsets' last axis the 32 lanes of a warp, so a test can count the
banks each warp touches. ``tests/test_torch_long_pencils.py`` holds the
emulation against the plain versions, ``np.fft`` and the JAX package's
Pallas kernels.
"""
import math

import torch

from repro_torch.core import twiddle as tw
from repro_torch.kernels import _long
from repro_torch.kernels import fft_fused as tkf
from repro_torch.kernels import fft_pencil as tkp

from _torch_stockham_emulation import dft

LANES = _long.LANES
TILE = _long.TILE
NAN = math.nan


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


class _Shared:
    """The shared memory of every block of a launch: (pencils, C, floats),
    NaN-filled. An access names its blocks ``block`` and its offsets
    ``at`` (broadcast together, the lanes last); a read sets what it read
    to NaN (no place is read twice), a write checks that no two threads
    write one place. Named accesses are recorded in ``trace`` (the im
    plane's lie a multiple of 32 floats on, on the same banks)."""

    def __init__(self, pencils: int, n: int, trace):
        self.mem = torch.full((pencils, _long.cluster(n), _long.smem_bytes(n) // 4), NAN)
        self.trace = trace

    def _note(self, name, block, at):
        at = at.expand(torch.broadcast_shapes(torch.as_tensor(block).shape, at.shape))
        if name and self.trace is not None:
            self.trace.append((name, at))
        return at

    def read(self, name, block, at):
        self._note(name, block, at)
        got = self.mem[:, block, at]
        self.mem[:, block, at] = NAN
        return got

    def write(self, name, block, at, val):
        at = self._note(name, block, at)
        flat = (torch.as_tensor(block) * self.mem.shape[2] + at).reshape(-1)
        assert flat.unique().numel() == flat.numel(), f"{name}: two threads write one place"
        self.mem[:, block, at] = val

    def pair(self, name, block, at, plane):
        """Read the (re, im) pair at ``at`` and ``at + plane``."""
        return self.read(name, block, at), self.read('', block, at + plane)

    def put(self, name, block, at, plane, val):
        self.write(name, block, at, val[0])
        self.write('', block, at + plane, val[1])


def _sub_fft(v, m: int, inverse: bool, read, write):
    """Every radix-8 pass of the m-point sub-FFTs of a group: ``v[q]`` the
    (re, im) pair thread (t, lane) holds as value q, shaped (..., T, 32);
    ``read(e)`` and ``write(e, pair)`` the exchange at element index e,
    a (T, 1) tensor. Returns the output, value q being element t + T q."""
    T = m // 8
    twr, twi = (torch.from_numpy(a) for a in tkp.radix8_tables_np(m, inverse))
    s = -1.0 if inverse else 1.0
    t = torch.arange(T)[:, None]
    radices = tkp.radix8_passes(m)
    ns = 1
    v = list(v)
    for k, r in enumerate(radices):
        if k > 0:
            v = [read(t + T * j) for j in range(8)]
        G = 8 // r
        for g in range(G):
            x = [v[g + G * mm] for mm in range(r)]
            if ns > 1:
                kk = (t + T * g) & (ns - 1)
                for mm in range(1, r):
                    w = ns - 1 + (mm - 1) * ns + kk
                    x[mm] = _cmul(x[mm], (twr[w], twi[w]))
            y = dft(x, s)
            for mm in range(r):
                v[g + G * mm] = y[mm]
        if k + 1 < len(radices):
            for g in range(G):
                tp = t + T * g
                base = (tp // ns) * ns * r + (tp & (ns - 1))
                for q in range(r):
                    write(base + q * ns, v[g + G * q])
        ns *= r
    return v


def _twiddles(n: int, inverse: bool, t: torch.Tensor, j: torch.Tensor):
    """w_n^(j k1) for k1 = t + TA q, q < 8, as the kernel makes them: the
    table's w_n^(j t) and w_n^(j TA), then products in its order."""
    na, nb = _long.factors(n)
    ta = na // 8
    wr, wi = (torch.from_numpy(a).float().reshape(-1)
              for a in tw.four_step_twiddle_np(na, nb, inverse=inverse))
    p = [(wr[t * nb + j], wi[t * nb + j]), (wr[ta * nb + j], wi[ta * nb + j])]
    p.append(_cmul(p[1], p[1]))
    p.append(_cmul(p[2], p[1]))
    p.append(_cmul(p[2], p[2]))
    p.append(_cmul(p[4], p[1]))
    p.append(_cmul(p[4], p[2]))
    p.append(_cmul(p[4], p[3]))
    return [p[0]] + [_cmul(p[0], p[q]) for q in range(1, 8)]


def _columns(sh: _Shared, x, n: int, inverse: bool) -> None:
    """The column phase of every block, its groups and rounds at once
    (they touch disjoint columns): x (pencils, n) planar into the tiles."""
    na, nb = _long.factors(n)
    P = _long.plan(n)
    C, J, TA, plane = P['C'], P['J'], P['TA'], P['TILE']
    blk = torch.arange(C)[:, None, None, None]
    t = torch.arange(TA)[:, None]
    jl = torch.arange(J // LANES)[:, None, None] * LANES + torch.arange(LANES)  # (J/32, 1, 32)
    j = blk * J + jl
    v = [tuple(a.reshape(-1, na, nb)[:, t + TA * q, j] for a in x) for q in range(8)]
    if _long.async_loads(n):
        for q in range(8):
            sh.put('column load write', blk, _long.tile_at(t + TA * q, jl, n), plane, v[q])
        v = [sh.pair('column load read', blk, _long.tile_at(t + TA * q, jl, n), plane)
             for q in range(8)]

    def read(e):
        return sh.pair('column exchange read', blk, _long.tile_at(e, jl, n), plane)

    def write(e, val):
        sh.put('column exchange write', blk, _long.tile_at(e, jl, n), plane, val)
    v = _sub_fft(v, na, inverse, read, write)
    tws = _twiddles(n, inverse, t, j)
    for q in range(8):
        sh.put('column twiddled write', blk, _long.tile_at(t + TA * q, jl, n), plane,
               _cmul(v[q], tws[q]))


def column_pass(re: torch.Tensor, im: torch.Tensor, inverse: bool = False):
    """The column phase on (pencils, n), read back from the tiles as
    y[j NA + k1]: w_n^(j k1) times the NA-point FFT of column j."""
    pencils, n = re.shape
    na, nb = _long.factors(n)
    P = _long.plan(n)
    sh = _Shared(pencils, n, None)
    _columns(sh, (re, im), n, inverse)
    j = torch.arange(nb)
    blk, jl = j // P['J'], j % P['J']
    k1 = torch.arange(na)[:, None]
    a = _long.tile_at(k1, jl, n)                   # (NA, NB)
    return tuple(sh.mem[:, blk, a + off].transpose(1, 2).reshape(pencils, n)
                 for off in (0, P['TILE']))


def _rows(sh: _Shared, n: int, inverse: bool, epilogue) -> None:
    """The row phase: every block's rows, round by round; ``epilogue(k1,
    k2, pair)`` takes each thread's outputs X[k1 + NA k2]."""
    na, nb = _long.factors(n)
    P = _long.plan(n)
    C, J, KA, TB, GB, plane = P['C'], P['J'], P['KA'], P['TB'], P['GB'], P['TILE']
    t = torch.arange(TB)[:, None]
    blk = torch.arange(C)[:, None, None, None]
    grp = torch.arange(GB)[:, None, None]
    lane = torch.arange(LANES)
    for rnd in range(KA // LANES // GB):
        k1 = blk * KA + (rnd * GB + grp) * LANES + lane          # (C, GB, 1, 32)
        if C == 1:                         # in place in the tile
            def at(e, k1=k1):
                return _long.tile_at(k1, e, n)
            v = [sh.pair('row read', blk, at(t + TB * q), plane) for q in range(8)]
            stage = plane
        else:                              # j = t + TB q lies in block (TB q) // J
            v = [sh.pair('row remote read', torch.tensor((TB * q) // J),
                         _long.tile_at(k1, t + (TB * q) % J, n), plane) for q in range(8)]
            sh.mem[:, :, 2 * plane:] = NAN      # nothing of an earlier round is read
            stage = LANES * nb

            def at(e, base=2 * plane + grp * 2 * LANES * nb):
                return base + e * LANES + lane

        def read(e, at=at, stage=stage):
            return sh.pair('row exchange read', blk, at(e), stage)

        def write(e, val, at=at, stage=stage):
            sh.put('row exchange write', blk, at(e), stage, val)
        out = _sub_fft(v, nb, inverse, read, write)
        for q in range(8):
            epilogue(k1, t + TB * q, out[q])


def _run(re: torch.Tensor, im: torch.Tensor, inverse: bool, trace, epilogue):
    n = re.shape[-1]
    sh = _Shared(re.shape[0], n, trace)
    _columns(sh, (re, im), n, inverse)
    _rows(sh, n, inverse, epilogue)


def emulate_long(re: torch.Tensor, im: torch.Tensor, inverse: bool = False, trace=None):
    """``fft_long_launch`` (``fft_pencil``, ``fft_matmul``, ``fft_block``)
    on planar fp32 (..., n)."""
    n = re.shape[-1]
    assert _long.takes(n)
    na = _long.factors(n)[0]
    x = [a.reshape(-1, n) for a in (re, im)]
    out = [torch.full_like(a, NAN) for a in x]
    scale = torch.tensor(1.0 / n if inverse else 1.0, dtype=torch.float32)

    def store(k1, k2, val):
        k = k1 + na * k2
        for o, u in zip(out, val):
            o[:, k] = u * scale
    _run(*x, inverse, trace, store)
    return tuple(o.reshape(re.shape) for o in out)


def _transpose(scratch, out, g0: int, b: int, trace) -> None:
    """``long_transpose_kernel`` on a chunk of m pencils: every tile of 32
    pencils x 32 k through NaN-filled shared rows of 33 floats, thread
    (ty, tx) moving rows ty + 8 i."""
    m, n = scratch[0].shape
    pt, kt, ld = -(-m // TILE), n // TILE, TILE + 1
    warps = _long.TRANSPOSE_THREADS // TILE
    assert 2 * TILE * ld * 4 == _long.TRANSPOSE_SMEM_BYTES
    tx, ty = torch.arange(TILE), torch.arange(warps)[:, None]
    p = torch.arange(pt)[:, None, None, None] * TILE + tx      # the pencil a read-out lane stores
    g = g0 + p
    l, j = g // b, g % b
    for c in range(2):
        pad = torch.full((pt * TILE, n), NAN)
        pad[:m] = scratch[c]
        tiles = pad.reshape(pt, TILE, kt, TILE).permute(0, 2, 1, 3)   # (pt, kt, p, k)
        sm = torch.full((pt, kt, TILE * ld), NAN)
        for i in range(TILE // warps):
            r = ty + warps * i
            if trace is not None and c == 0:
                trace.append(('transpose write', (r * ld + tx).expand(warps, TILE)))
            sm[:, :, r * ld + tx] = tiles[:, :, r, tx]
        for i in range(TILE // warps):
            r = ty + warps * i
            if trace is not None and c == 0:
                trace.append(('transpose read', (tx * ld + r).expand(warps, TILE)))
            got = sm[:, :, tx * ld + r]                    # (pt, kt, 8, 32): k = r, p = tx
            k = torch.arange(kt)[:, None, None] * TILE + r
            at = ((l * n + k) * b + j).expand_as(got)
            keep = (p < m).expand_as(got)
            out[c].view(-1)[at[keep]] = got[keep]


def emulate_fused_long(re: torch.Tensor, im: torch.Tensor, wr=None, wi=None,
                       inverse: bool = False, trace=None):
    """``fft_fused_long_launch`` on planar fp32 (..., b, n) -> (..., n, b),
    chunk by chunk of ``_long.chunk_pencils`` pencils."""
    *lead, b, n = re.shape
    assert _long.takes(n)
    na = _long.factors(n)[0]
    nl = math.prod(lead)
    pencils = nl * b
    twr, twi, wstride = tkf._twiddle_planes(re, wr, wi)
    w = None if twr is None else [a.reshape(-1) for a in (twr, twi)]
    scale = torch.tensor(1.0 / n if inverse else 1.0, dtype=torch.float32)
    x = [a.reshape(pencils, n) for a in (re, im)]
    out = [torch.full((nl, n, b), NAN) for _ in range(2)]
    chunk = _long.chunk_pencils(n, pencils)
    for g0 in range(0, pencils, chunk):
        m = min(chunk, pencils - g0)
        scratch = [torch.full((m, n), NAN) for _ in range(2)]
        g = torch.arange(g0, g0 + m)[:, None, None, None, None]
        l, j = g // b, g % b

        def epilogue(k1, k2, val, l=l, j=j, scratch=scratch):
            k = k1 + na * k2
            ur, ui = val[0] * scale, val[1] * scale
            if w is not None:
                at = l * wstride + j * n + k
                ur, ui = _cmul((ur, ui), (w[0][at], w[1][at]))
            for s, u in zip(scratch, (ur, ui)):
                s[torch.arange(m)[:, None, None, None, None], k] = u
        _run(x[0][g0:g0 + m], x[1][g0:g0 + m], inverse, trace, epilogue)
        _transpose(scratch, out, g0, b, trace)
        trace = None                             # one chunk's accesses stand for all
    return tuple(o.reshape(*lead, n, b) for o in out)
