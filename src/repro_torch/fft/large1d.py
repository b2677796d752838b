"""Large 1-D FFT: the four-step algorithm distributed over the mesh.

Port of ``repro.fft.large1d`` (the transform path). The length-n
transform is factored n = n1 * n2 and viewed as the 2-D array A[k1, k2]
(k = k1*n2 + k2) with rows sharded over the flattened mesh axes: column
DFT -> inter-factor twiddle -> row DFT, with one ownership swap on each
side, the 1-D analogue of the paper's pencil supersteps. The swaps go
through the :mod:`repro_torch.comm.strategies` registry; with a batch
of more than one signal, ``overlap_chunks`` pipelines the whole
four-step over chunks of the batch (:func:`repro_torch.comm.overlap.pipelined`).

Each factory returns the per-rank function on this rank's block with
ONE leading batch axis, as :func:`repro_torch.fft.pencil.make_fft` does.
The column DFT, the twiddle and the orientation restore run as one
fused superstep (``methods.apply_fused`` with the twiddle planes: on the
kernel tier with ``method='stockham'`` one ``fft_twiddle_transpose``
launch), and the natural-order row DFT emits its own transpose.

Users go through ``repro_torch.fft.plan((n,), mesh)``, which owns the
(n,) <-> (n1, n2) views and the real spectrum's assembly, or
``plan_op((n,), mesh, ...)``, whose operator (:func:`make_fourstep_op`)
keeps the spectrum in the four-step's own form and never assembles it.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.comm import overlap as ov
from repro_torch.comm import strategies
from repro_torch.core import twiddle as tw
from repro_torch.core.twiddle import Planar
from repro_torch.fft import methods
from repro_torch.fft.pencil import splice_op


def twiddle(n: int, rows: int, k2_first: int, m2: int, *, transposed: bool = False,
            conj: bool = False, device=None) -> Planar:
    """The inter-factor twiddle W[j1, k2] = w_n^(j1*k2) for j1 < ``rows``
    and this rank's k2 chunk ``[k2_first, k2_first + m2)``, planar fp32 of
    (rows, m2), or (m2, rows) when ``transposed``. Each angle is taken in
    float64 from the integer product j1*k2 mod n, so the two
    orientations hold the same bits. ``conj`` negates the imaginary
    plane (the inverse's rotation)."""
    j1 = torch.arange(rows, dtype=torch.int64, device=device)
    k2 = k2_first + torch.arange(m2, dtype=torch.int64, device=device)
    jk = k2[:, None] * j1[None, :] if transposed else j1[:, None] * k2[None, :]
    ang = (jk % n).to(torch.float64) * (-2.0 * math.pi / n)
    wr, wi = torch.cos(ang).float(), torch.sin(ang).float()
    return (wr, -wi) if conj else (wr, wi)


def _group(n1: int, n2: int, mesh, mesh_axes, comm: str, wire_dtype: str):
    """(mesh_axis, p, this rank's index in the group, swap) of a plan over
    ``mesh_axes`` flattened. ``swap(*arrays, shard_pos=, mem_pos=)``
    starts every array's swap, then finishes them in order."""
    ax = tuple(mesh_axes) if isinstance(mesh_axes, (tuple, list)) else (mesh_axes,)
    mesh_axis = ax if len(ax) > 1 else ax[0]
    p = strategies.static_group_size(mesh_axis, mesh.shape)
    if n1 % p or n2 % p:
        raise ValueError(f"{p} devices must divide both factors ({n1},{n2})")
    strategy = strategies.resolve(comm)
    strategies.validate_wire_dtype(wire_dtype)
    idx = mesh.group_index(mesh_axis) if p > 1 else 0

    def swap(*arrays, shard_pos: int, mem_pos: int):
        started = [strategies.swap_start_wire(strategy, a, mesh, mesh_axis,
                                              shard_pos=shard_pos, mem_pos=mem_pos,
                                              wire_dtype=wire_dtype) for a in arrays]
        out = tuple(h.wait() for h in started)
        return out if len(out) > 1 else out[0]
    return mesh_axis, p, idx, swap


def _batched(fn: Callable, overlap_chunks: int) -> Callable:
    """``fn`` pipelined over chunks of the leading batch axis where it
    divides into ``overlap_chunks``, else unchunked."""
    def run(*arrays):
        ck = ov.pick_chunk_axis(arrays[0].shape[:1], (), overlap_chunks)
        if ck is not None:
            return ov.pipelined(overlap_chunks, ck, fn, *arrays)
        return fn(*arrays)
    return run


def make_fft1d_large(n1: int, n2: int, mesh, mesh_axes=('x', 'y'), *,
                     inverse: bool = False, method: str = 'auto', kernel: str = 'auto',
                     comm: str = 'all_to_all', overlap_chunks: int = 1,
                     wire_dtype: str = 'native', compute_dtype=None) -> Callable:
    """1-D FFT of length n = n1*n2 as a distributed four-step, in natural
    order (the reference's ``natural_order=True``).

    ``fn(ar, ai)`` takes this rank's planar block (B, n1/p, n2) of the
    row-major view A[k1, k2] and returns its rows of the natural-order
    (n2, n1) matrix, y[j1 + n1*j2] at [j2, j1]: (B, n2/p, n1)."""
    methods.validate(method)
    methods.validate_kernel(kernel)
    mesh_axis, p, idx, swap = _group(n1, n2, mesh, mesh_axes, comm, wire_dtype)
    n, m2 = n1 * n2, n2 // p
    # (m2, n1): the orientation of the fused superstep's pre-transpose output
    wr, wi = twiddle(n, n1, idx * m2, m2, transposed=True, conj=inverse,
                     device=mesh.device)
    kw = dict(inverse=inverse, method=method, kernel=kernel, compute_dtype=compute_dtype)

    def body(ar, ai):
        ar, ai = swap(ar, ai, shard_pos=1, mem_pos=2)                 # (B, n1, m2)
        # column DFT over k1, twiddle and orientation restore in one pass
        ar, ai = methods.apply_fused(ar.transpose(1, 2), ai.transpose(1, 2),
                                     wr=wr, wi=wi, **kw)
        ar, ai = swap(ar, ai, shard_pos=2, mem_pos=1)                 # (B, n1/p, n2)
        # row DFT over k2 with transposed emit: (B, n2, n1/p) is the
        # natural order's local transpose, so only the exchange remains
        ar, ai = methods.apply_fused(ar, ai, **kw)
        return swap(ar, ai, shard_pos=2, mem_pos=1)                   # (B, n2/p, n1)

    return _batched(body, overlap_chunks)


def _real_fourstep(n1: int, n2: int, mesh, mesh_axes, *, method: str, kernel: str,
                   comm: str, wire_dtype: str, compute_dtype=None):
    """The real four-step bodies on this rank's block with one leading
    batch axis: ``(body_fwd, body_inv)``.

    ``body_fwd(x)`` takes the real rows (B, n1/p, n2) and returns the
    planar half plane D[j1, j2], j1 <= n1//2, its rows padded to a
    multiple of p and sharded, (B, nh1p/p, n2). The column DFT is r2c
    (``methods.apply_real``), so the first swap moves one real array and
    the second the halved rows. ``body_inv`` is its mirror.

    The ``np.fft.rfft`` assembly keeps one bin of each conjugate pair in
    rows 0 and n1/2, so the transform leaves their other halves as the
    butterflies computed them; the operator plans canonicalize them
    (:func:`_canon`)."""
    methods.validate(method)
    methods.validate_kernel(kernel)
    mesh_axis, p, idx, swap = _group(n1, n2, mesh, mesh_axes, comm, wire_dtype)
    n, m2 = n1 * n2, n2 // p
    nh1 = n1 // 2 + 1
    nh1p = -(-nh1 // p) * p
    # (nh1p, m2); the pad rows carry zeros, whatever their phase
    wr, wi = twiddle(n, nh1p, idx * m2, m2, device=mesh.device)
    kw = dict(method=method, kernel=kernel, compute_dtype=compute_dtype)

    def body_fwd(x):
        x = swap(x, shard_pos=1, mem_pos=2)                           # (B, n1, m2)
        ar, ai = methods.apply_real(x, axis=1, **kw)                  # (B, nh1, m2)
        pad = (0, 0, 0, nh1p - nh1)
        ar, ai = torch.nn.functional.pad(ar, pad), torch.nn.functional.pad(ai, pad)
        ar, ai = tw.cmul(ar, ai, wr, wi)
        ar, ai = swap(ar, ai, shard_pos=2, mem_pos=1)                 # (B, nh1p/p, n2)
        return methods.apply(ar, ai, axis=2, **kw)

    def body_inv(ar, ai):
        ar, ai = methods.apply(ar, ai, axis=2, inverse=True, **kw)    # row IDFT
        ar, ai = swap(ar, ai, shard_pos=1, mem_pos=2)                 # (B, nh1p, m2)
        ar, ai = tw.cmul(ar, ai, wr, -wi)
        # drop the pad rows, c2r column IDFT -> (B, n1, m2) real
        x = methods.apply_real(ar[:, :nh1], ai[:, :nh1], axis=1, inverse=True, **kw)
        return swap(x, shard_pos=2, mem_pos=1)                        # (B, n1/p, n2)

    return body_fwd, body_inv


def make_rfft1d_large(n1: int, n2: int, mesh, mesh_axes=('x', 'y'), *,
                      inverse: bool = False, method: str = 'auto',
                      kernel: str = 'auto', comm: str = 'all_to_all',
                      overlap_chunks: int = 1, wire_dtype: str = 'native',
                      compute_dtype=None) -> Callable:
    """Rank-1 REAL four-step in the rows-halved half-plane form: the
    forward ``fn(x)`` maps this rank's real rows (B, n1/p, n2) of A[k1, k2]
    to its rows of the planar half plane D[j1, j2], j1 <= n1//2 padded to
    a multiple of p, (B, nh1p/p, n2); the inverse ``fn(re, im)`` maps
    them back. The assembly of ``np.fft.rfft``'s order lives in the
    facade."""
    body_fwd, body_inv = _real_fourstep(n1, n2, mesh, mesh_axes, method=method,
                                        kernel=kernel, comm=comm, wire_dtype=wire_dtype,
                                        compute_dtype=compute_dtype)
    return _batched(body_inv if inverse else body_fwd, overlap_chunks)



# ---------------------------------------------------------------------------
# Operator bodies: the spectrum in the four-step's own form
# ---------------------------------------------------------------------------

def _canon(ar: torch.Tensor, ai: torch.Tensor, n1: int, n2: int,
           first_row: int) -> Planar:
    """Hermitian-canonicalize rows 0 and n1/2 of this rank's rows of the
    real half plane D (global rows from ``first_row``), in place.

    Those two rows hold conjugate pairs inside themselves (row 0: (0, j2)
    with (0, n2 - j2); row n1/2: (n1/2, j2) with (n1/2, n2-1-j2)), which
    the butterflies compute along different paths, so they are not exact
    conjugates. The ``np.fft.rfft`` order keeps the j2 < n2/2 member of
    each pair and its inverse rebuilds the other as its conjugate; this
    does the same here (a sign flip, no rounding), so an operator's
    pointwise sees the bins the unfused forward -> pointwise -> inverse
    composition sees. The other rows survive that round trip bit for
    bit already. The tensors are the body's fresh outputs."""
    h = n2 // 2
    for row, dst, src in ((0, slice(h + 1, None), slice(1, h)),
                          (n1 // 2, slice(h, None), slice(0, h))):
        r = row - first_row
        if 0 <= r < ar.shape[-2]:
            ar[..., r, dst] = ar[..., r, src].flip(-1)
            ai[..., r, dst] = ai[..., r, src].flip(-1).neg()
    return ar, ai


def _complex_fourstep(n1: int, n2: int, mesh, mesh_axes, *, method: str, kernel: str,
                      comm: str, wire_dtype: str, compute_dtype=None, fused: bool = True):
    """The complex four-step bodies in the factor-transposed D-form, on
    this rank's block with one leading batch axis: ``(body_fwd,
    body_inv)``.

    ``body_fwd(ar, ai)`` is :func:`make_fft1d_large`'s body without the
    natural-order epilogue: it maps the rows (B, n1/p, n2) of A[k1, k2]
    to the rows (B, n1/p, n2) of D[j1, j2] = y[j1 + n1*j2], every bin
    once. ``body_inv`` maps them back: row IDFT over j2, the conjugate
    twiddle, column IDFT over j1. D's rows are what the natural-order
    inverse holds after its first swap, so with ``fused`` the inverse is
    that inverse's remaining supersteps (the row IDFT, twiddle and
    transposed emit as one ``apply_fused`` with its own planes): the
    same kernels on the same pencils, so an operator gives the bits of
    the natural-order forward and inverse. Without ``fused`` each
    direction runs its DFTs and twiddle as separate steps."""
    methods.validate(method)
    methods.validate_kernel(kernel)
    mesh_axis, p, idx, swap = _group(n1, n2, mesh, mesh_axes, comm, wire_dtype)
    n, m2, m1 = n1 * n2, n2 // p, n1 // p
    kw = dict(method=method, kernel=kernel, compute_dtype=compute_dtype)
    wr, wi = twiddle(n, n1, idx * m2, m2, device=mesh.device)              # (n1, m2)
    wtr, wti = twiddle(n, n1, idx * m2, m2, transposed=True, device=mesh.device)
    wci = -wi
    # (m1, n2): the natural-order inverse's planes (its factors swapped)
    wir, wii = twiddle(n, n2, idx * m1, m1, transposed=True, conj=True, device=mesh.device)

    def body_fwd(ar, ai):
        ar, ai = swap(ar, ai, shard_pos=1, mem_pos=2)                 # (B, n1, m2)
        if fused:
            ar, ai = methods.apply_fused(ar.transpose(1, 2), ai.transpose(1, 2),
                                         wr=wtr, wi=wti, **kw)
        else:
            ar, ai = methods.apply(ar, ai, axis=1, **kw)
            ar, ai = tw.cmul(ar, ai, wr, wi)
        ar, ai = swap(ar, ai, shard_pos=2, mem_pos=1)                 # (B, n1/p, n2)
        return methods.apply(ar, ai, axis=2, **kw)

    def body_inv(ar, ai):
        if fused:
            ar, ai = methods.apply_fused(ar, ai, wr=wir, wi=wii, inverse=True, **kw)
            ar, ai = swap(ar, ai, shard_pos=2, mem_pos=1)             # (B, n2/p, n1)
            ar, ai = methods.apply_fused(ar, ai, inverse=True, **kw)  # (B, n1, n2/p)
        else:
            ar, ai = methods.apply(ar, ai, axis=2, inverse=True, **kw)
            ar, ai = swap(ar, ai, shard_pos=1, mem_pos=2)             # (B, n1, m2)
            ar, ai = tw.cmul(ar, ai, wr, wci)
            ar, ai = methods.apply(ar, ai, axis=1, inverse=True, **kw)
        return swap(ar, ai, shard_pos=2, mem_pos=1)                   # (B, n1/p, n2)

    return body_fwd, body_inv


def fourstep_bodies(n1: int, n2: int, mesh, mesh_axes, *, real: bool, method: str = 'auto',
                    kernel: str = 'auto', comm: str = 'all_to_all',
                    wire_dtype: str = 'native', compute_dtype=None, fused: bool = True):
    """``(fwd, inv)`` of a rank-1 operator on this rank's block with one
    leading batch axis, the spectrum in its native form: for a real plan
    the rows (B, nh1p/p, n2) of the half plane D[j1 <= n1//2, j2], rows
    0 and n1/2 canonicalized (:func:`_canon`), pad rows past n1//2
    dropped by ``inv``; for a complex plan the D-form
    (:func:`_complex_fourstep`). ``fwd`` is also what bakes an
    operator's spectra given in operand space."""
    kw = dict(method=method, kernel=kernel, comm=comm, wire_dtype=wire_dtype,
              compute_dtype=compute_dtype)
    if not real:
        return _complex_fourstep(n1, n2, mesh, mesh_axes, fused=fused, **kw)
    body_fwd, body_inv = _real_fourstep(n1, n2, mesh, mesh_axes, **kw)
    _, p, idx, _ = _group(n1, n2, mesh, mesh_axes, comm, wire_dtype)
    rows = -(-(n1 // 2 + 1) // p)

    def fwd(x):
        ar, ai = body_fwd(x)
        return _canon(ar, ai, n1, n2, idx * rows)

    return fwd, body_inv


def make_fourstep_op(n1: int, n2: int, mesh, mesh_axes, pointwise: Callable, *,
                     real: bool = True, batch_ndims=(0,), baked_batch_ndims=(),
                     method: str = 'auto', kernel: str = 'auto', compute_dtype=None,
                     comm: str = 'all_to_all', wire_dtype: str = 'native',
                     fused: bool = True) -> Callable:
    """The rank-1 fused spectral operator: the four-step forward,
    ``pointwise`` on this rank's rows of the spectrum in its native form
    (:func:`fourstep_bodies`), then the mirrored inverse. The
    half-plane / natural-order assembly that ``plan((n,), ...)`` makes
    never happens. ``pointwise`` must be elementwise in the bins and,
    for a real plan, conjugation-equivariant (any multiplicative factor
    is). Operands are this rank's rows of the (n1, n2) row-major view,
    (..., n1/p, n2); a real plan takes ``fn(x, *extras, *baked) -> y``,
    a complex one planar pairs. ``batch_ndims`` / ``baked_batch_ndims``
    as in :func:`repro_torch.fft.pencil.make_fused_op`."""
    fwd, inv = fourstep_bodies(n1, n2, mesh, mesh_axes, real=real, method=method,
                               kernel=kernel, comm=comm, wire_dtype=wire_dtype,
                               compute_dtype=compute_dtype, fused=fused)
    return splice_op(fwd, inv, pointwise, per_operand=1 if real else 2, core_rank=2,
                     batch_ndims=tuple(batch_ndims),
                     baked_batch_ndims=tuple(baked_batch_ndims))
