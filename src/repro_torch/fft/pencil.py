"""wsFFT pencil machinery: the distributed multidimensional FFT.

Port of ``repro.fft.pencil``. For a 3-D transform the input A[x, y, z]
lives with (x, y) on the two mesh axes and z in memory; each superstep
FFTs the in-memory axis, and between supersteps one all-to-all along
one mesh axis exchanges the in-memory axis with a mesh-owned one. The
semantic (x, y, z) axis order never changes; only ownership rotates:
('x', 'y', None) -> ('y', None, 'x') after a forward 3-D FFT.

Where the reference wraps its local function in ``shard_map``, the
port runs it on each rank's local block. Each serial (fft, swap) pair
runs as one fused superstep (:func:`_fused_pair`); the last fft runs
through :func:`repro_torch.fft.methods.apply`. With ``overlap_chunks > 1``
each (fft, swap) pair is pipelined over chunks of a free local axis
(:mod:`repro_torch.comm.overlap`), its fft unfused, as in the reference.
``method='block'`` plans run this same planar executor; the block
kernel takes planar pairs. Real plans transform the last axis
real-to-complex first and run the rest as a complex sub-plan on the
padded half spectrum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.comm import overlap as ov
from repro_torch.comm import strategies
from repro_torch.core import plan as planlib
from repro_torch.core.plan import Layout, PencilPlan
from repro_torch.core.twiddle import Planar
from repro_torch.fft import methods


# ---------------------------------------------------------------------------
# Schedule derivation (pure layout algebra)
# ---------------------------------------------------------------------------

def forward_schedule(layout: Layout,
                     first_mem: Optional[int] = None) -> Tuple[Tuple, Layout]:
    """Returns (steps, final_layout). Each step is ('fft', mem_pos) or
    ('swap', mesh_axis, mem_pos). ``first_mem`` forces that memory axis
    into the first superstep: real plans transform the r2c axis before
    any exchange, so everything on the wire is half spectrum."""
    steps: List[Tuple] = []
    lay = layout
    transformed = set()
    ndim = len(layout)
    while len(transformed) < ndim:
        mems = [p for p in planlib.memory_axes(lay) if p not in transformed]
        if not mems:
            raise ValueError(f"no untransformed memory axis in {lay}")
        if first_mem is not None and first_mem not in transformed:
            if first_mem not in mems:
                raise ValueError(f"axis {first_mem} must start in memory to be the "
                                 f"first superstep of {layout}")
            mem = first_mem
        else:
            mem = mems[0]
        steps.append(('fft', mem))
        transformed.add(mem)
        # swap with the first untransformed mesh-owned axis, position order
        pend = [(p, o) for p, o in enumerate(lay) if o is not None and p not in transformed]
        if pend:
            _, owner = pend[0]
            steps.append(('swap', owner, mem))
            lay = planlib.swap(lay, owner, mem)
    return tuple(steps), lay


def inverse_schedule(layout: Layout,
                     first_mem: Optional[int] = None) -> Tuple[Tuple, Layout]:
    """Mirror of forward_schedule from the forward's final layout: each
    swap reversed, IFFTs in reverse superstep order, ending at
    ``layout``."""
    fwd, final = forward_schedule(layout, first_mem)
    pre_layouts = []
    lay = layout
    for step in fwd:
        pre_layouts.append(lay)
        if step[0] == 'swap':
            lay = planlib.swap(lay, step[1], step[2])
    if lay != final:
        raise AssertionError(f"schedule replay ended at {lay}, not {final}")
    steps: List[Tuple] = []
    for step, pre in zip(reversed(fwd), reversed(pre_layouts)):
        if step[0] == 'fft':
            steps.append(step)
        else:
            _, mesh_axis, _ = step
            # the position sharded before the forward swap is the memory
            # position of the inverse swap
            steps.append(('swap', mesh_axis, planlib.owner_pos(pre, mesh_axis)))
    return tuple(steps), layout


# ---------------------------------------------------------------------------
# Half-spectrum extent bookkeeping (real plans)
# ---------------------------------------------------------------------------

def real_half_extent(n: int) -> int:
    """Half-spectrum length of a length-n real transform."""
    return n // 2 + 1


def real_padded_extent(shape, layout: Layout, mesh_shape, *,
                       restore_layout: bool = False) -> int:
    """On-wire extent of the half-spectrum last axis: n//2 + 1 zero-padded
    to the smallest multiple of every group size that owns the axis
    along the swap sequence (restore swaps included). The pad lies
    wholly in the trailing shards."""
    ra = len(shape) - 1
    nh = real_half_extent(shape[-1])
    steps, final = forward_schedule(tuple(layout), first_mem=ra)
    swaps = [(s[1], s[2]) for s in steps if s[0] == 'swap']
    if restore_layout:
        swaps += list(planlib.plan_swaps(final, tuple(layout)))
    lay = tuple(layout)
    lcm = 1
    for ax, mp in swaps:
        lay = planlib.swap(lay, ax, mp)
        if lay[ra] is not None:
            lcm = math.lcm(lcm, strategies.static_group_size(lay[ra], mesh_shape))
    return -(-nh // lcm) * lcm


def packed_plan(plan: PencilPlan, nh_pad: int) -> PencilPlan:
    """The complex plan of a real plan's post-r2c supersteps: the same
    mesh, layout and method, the last axis at its padded half extent."""
    return dataclasses.replace(plan, shape=plan.shape[:-1] + (nh_pad,), real=False)


# ---------------------------------------------------------------------------
# Local execution of a schedule (per rank)
# ---------------------------------------------------------------------------

def _fft_along(re, im, axis: int, *, inverse: bool, plan: PencilPlan) -> Planar:
    return methods.apply(re, im, axis=axis, inverse=inverse, method=plan.method,
                         kernel=plan.kernel, compute_dtype=plan.compute_dtype)


def _swap_start(x, mesh_axis, *, shard_pos: int, mem_pos: int,
                plan: PencilPlan) -> strategies.PendingSwap:
    return strategies.swap_start_wire(
        strategies.resolve(plan.comm), x, plan.mesh, mesh_axis,
        shard_pos=shard_pos, mem_pos=mem_pos, wire_dtype=plan.wire_dtype)


def _swap(x, mesh_axis, *, shard_pos: int, mem_pos: int, plan: PencilPlan):
    return _swap_start(x, mesh_axis, shard_pos=shard_pos, mem_pos=mem_pos,
                       plan=plan).wait()


def _fused_pair(re, im, *, a: int, s: int, mesh_axis, inverse: bool,
                plan: PencilPlan) -> Planar:
    """One fused superstep: FFT along local axis ``a`` and the swap that
    exchanges it with the mesh axis at local position ``s``. The fft
    axis is moved last, the fused op emits the last two axes exchanged,
    the collective runs at the permuted positions, and a permutation
    (a view) restores the original axis order."""
    nd = re.ndim
    fr, fi = methods.apply_fused(re.movedim(a, -1), im.movedim(a, -1),
                                 inverse=inverse, method=plan.method,
                                 kernel=plan.kernel, compute_dtype=plan.compute_dtype)
    # net arrange+emit permutation: order[i] = original axis at new pos i
    order = [p for p in range(nd) if p != a]
    order = order[:-1] + [a] + order[-1:]
    s_new = order.index(s)
    fr = _swap(fr, mesh_axis, shard_pos=s_new, mem_pos=nd - 2, plan=plan)
    fi = _swap(fi, mesh_axis, shard_pos=s_new, mem_pos=nd - 2, plan=plan)
    inv = [0] * nd
    for i2, p in enumerate(order):
        inv[p] = i2
    return fr.permute(inv), fi.permute(inv)


def _execute(re, im, layout: Layout, steps, *, inverse: bool,
             plan: PencilPlan, batch_ndim: int, overlap_chunks: int = 1) -> Planar:
    """Run fft/swap steps, threading the layout. With ``overlap_chunks >
    1`` each (fft, swap) pair is pipelined over chunks of a local axis
    that is neither its fft axis nor its swap's axes (leading batch axes
    included), its fft unfused; a pair with no such axis runs serially.
    A serial (fft, swap) pair whose swap splits the just-transformed
    axis (the schedule invariant in both directions) runs as one fused
    superstep."""
    off = batch_ndim
    lay = layout
    i = 0
    while i < len(steps):
        step = steps[i]
        nxt = steps[i + 1] if i + 1 < len(steps) else None
        pair = step[0] == 'fft' and nxt is not None and nxt[0] == 'swap'
        if pair and overlap_chunks > 1:
            mem = step[1]
            _, mesh_axis, mem_pos = nxt
            sp = planlib.owner_pos(lay, mesh_axis)
            ck = ov.pick_chunk_axis(re.shape, (off + mem, off + mem_pos, off + sp),
                                    overlap_chunks)
            if ck is not None:
                re, im = ov.pipelined_pair(
                    overlap_chunks, ck,
                    compute=lambda r, i_, m=mem: _fft_along(
                        r, i_, off + m, inverse=inverse, plan=plan),
                    swap_start=lambda a, ma=mesh_axis, s=sp, mp=mem_pos: _swap_start(
                        a, ma, shard_pos=off + s, mem_pos=off + mp, plan=plan),
                    arrays=(re, im))
                lay = planlib.swap(lay, mesh_axis, mem_pos)
                i += 2
                continue
        if pair and nxt[2] == step[1] and re.ndim >= 2:
            _, mesh_axis, _ = nxt
            re, im = _fused_pair(
                re, im, a=off + step[1],
                s=off + planlib.owner_pos(lay, mesh_axis),
                mesh_axis=mesh_axis, inverse=inverse, plan=plan)
            lay = planlib.swap(lay, mesh_axis, nxt[2])
            i += 2
            continue
        if step[0] == 'fft':
            re, im = _fft_along(re, im, off + step[1], inverse=inverse, plan=plan)
        else:
            _, mesh_axis, mem_pos = step
            sp = off + planlib.owner_pos(lay, mesh_axis)
            re = _swap(re, mesh_axis, shard_pos=sp, mem_pos=off + mem_pos, plan=plan)
            im = _swap(im, mesh_axis, shard_pos=sp, mem_pos=off + mem_pos, plan=plan)
            lay = planlib.swap(lay, mesh_axis, mem_pos)
        i += 1
    return re, im


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def make_fft(plan: PencilPlan, *, inverse: bool = False,
             restore_layout: bool = False,
             overlap_chunks: int = 1) -> Tuple[Callable, Layout, Layout]:
    """Build the per-rank FFT of a plan.

    Returns (fn, in_layout, out_layout). For a complex plan ``fn(re, im)``
    maps this rank's planar block, with ONE leading batch axis, in
    ``in_layout`` to its block in ``out_layout``. A real plan differs at
    the r2c boundary only: the forward takes ONE real block and returns
    the planar padded half spectrum (last axis ``real_padded_extent``),
    the inverse takes that and returns the real block. The inverse
    consumes the forward's output layout and returns the plan's layout;
    with ``restore_layout`` both directions consume and produce the
    plan's layout (extra swaps)."""
    plan.validate()
    methods.validate(plan.method)
    strategies.validate(plan.comm)
    first = plan.real_axis
    if inverse:
        steps, _ = inverse_schedule(plan.layout, first)
        in_layout, out_layout = forward_schedule(plan.layout, first)[1], plan.layout
        if restore_layout:
            steps = tuple(('swap', ax, mp) for ax, mp
                          in planlib.plan_swaps(plan.layout, in_layout)) + steps
            in_layout = plan.layout
    else:
        steps, out_layout = forward_schedule(plan.layout, first)
        in_layout = plan.layout
        if restore_layout:
            steps = steps + tuple(('swap', ax, mp) for ax, mp
                                  in planlib.plan_swaps(out_layout, plan.layout))
            out_layout = plan.layout

    if plan.real:
        fn = _real_local(plan, steps, in_layout, inverse=inverse,
                         restore_layout=restore_layout, overlap_chunks=overlap_chunks)
    else:
        def fn(re: torch.Tensor, im: torch.Tensor) -> Planar:
            return _execute(re, im, in_layout, steps, inverse=inverse, plan=plan,
                            batch_ndim=1, overlap_chunks=overlap_chunks)
    return fn, in_layout, out_layout


def _real_local(plan: PencilPlan, steps, in_layout: Layout, *, inverse: bool,
                restore_layout: bool, overlap_chunks: int) -> Callable:
    """The per-rank function of a real plan. The r2c superstep is first
    (forward) or last (inverse) by the ``first_mem`` rule; the steps in
    between run as a complex plan on the padded half spectrum.

    With ``overlap_chunks > 1`` the r2c superstep joins the pipeline by
    split-combine: chunks of a free axis of the REAL input (not the real
    axis, not the first swap's axes) each run r2c + pad + swap, and the
    inverse mirrors it with the last (swap, c2r) pair; with no such axis
    the pair runs unchunked."""
    ra = plan.real_axis
    off = 1
    nh = real_half_extent(plan.shape[-1])
    nh_pad = real_padded_extent(plan.shape, plan.layout, plan.mesh.shape,
                                restore_layout=restore_layout)
    packed = packed_plan(plan, nh_pad)

    def r2c(x: torch.Tensor) -> Planar:
        re, im = methods.apply_real(x, axis=off + ra, method=plan.method,
                                    kernel=plan.kernel, compute_dtype=plan.compute_dtype)
        if nh_pad != nh:      # the real axis is the last one
            re = torch.nn.functional.pad(re, (0, nh_pad - nh))
            im = torch.nn.functional.pad(im, (0, nh_pad - nh))
        return re, im

    def c2r(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        re, im = re.narrow(off + ra, 0, nh), im.narrow(off + ra, 0, nh)
        return methods.apply_real(re, im, axis=off + ra, inverse=True,
                                  method=plan.method, kernel=plan.kernel,
                                  compute_dtype=plan.compute_dtype)

    def chunked_swap(shape, lay: Layout, swap_step):
        """(chunk axis or None, start function) of the swap that pairs
        with the r2c/c2r superstep, on a block of ``shape`` under ``lay``."""
        _, mesh_axis, mem_pos = swap_step
        sp = planlib.owner_pos(lay, mesh_axis)
        ck = ov.pick_chunk_axis(shape, (off + ra, off + mem_pos, off + sp),
                                overlap_chunks)

        def start(t):
            return _swap_start(t, mesh_axis, shard_pos=off + sp, mem_pos=off + mem_pos,
                               plan=packed)
        return ck, start

    def forward(x: torch.Tensor) -> Planar:
        if steps[0] != ('fft', ra):
            raise AssertionError(f"real schedule starts with {steps[0]}")
        rest = steps[1:]
        if overlap_chunks > 1 and rest and rest[0][0] == 'swap':
            ck, start = chunked_swap(x.shape, in_layout, rest[0])
            if ck is not None:
                re, im = ov.pipelined_pair(overlap_chunks, ck, compute=r2c,
                                           swap_start=start, arrays=(x,))
                lay = planlib.swap(in_layout, rest[0][1], rest[0][2])
                return _execute(re, im, lay, rest[1:], inverse=False, plan=packed,
                                batch_ndim=off, overlap_chunks=overlap_chunks)
        re, im = r2c(x)
        return _execute(re, im, in_layout, rest, inverse=False, plan=packed,
                        batch_ndim=off, overlap_chunks=overlap_chunks)

    def inverse_(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        if steps[-1] != ('fft', ra):
            raise AssertionError(f"real schedule ends with {steps[-1]}")
        head = steps[:-1]
        if overlap_chunks > 1 and head and head[-1][0] == 'swap':
            lay = in_layout
            for st in head[:-1]:
                if st[0] == 'swap':
                    lay = planlib.swap(lay, st[1], st[2])
            # the shape the pair will see: after the head, not at entry
            pre = tuple(re.shape[:off]) + packed.local_shape(lay)
            ck, start = chunked_swap(pre, lay, head[-1])
            if ck is not None:
                re, im = _execute(re, im, in_layout, head[:-1], inverse=True,
                                  plan=packed, batch_ndim=off,
                                  overlap_chunks=overlap_chunks)
                return ov.pipelined_pair(overlap_chunks, ck, compute=c2r,
                                         swap_start=start, swap_first=True,
                                         arrays=(re, im))
        re, im = _execute(re, im, in_layout, head, inverse=True, plan=packed,
                          batch_ndim=off, overlap_chunks=overlap_chunks)
        return c2r(re, im)

    return inverse_ if inverse else forward


# ---------------------------------------------------------------------------
# Fused spectral operators
# ---------------------------------------------------------------------------

def splice_op(fwd: Callable, inv: Callable, pointwise: Callable, *, per_operand: int,
              core_rank: int, batch_ndims: Tuple[int, ...],
              baked_batch_ndims: Tuple[int, ...]) -> Callable:
    """The operator ``fn(*operands, *baked)``: each operand through
    ``fwd``, ``pointwise`` on the spectra, the result through ``inv``.

    ``fwd`` and ``inv`` take and return blocks with ONE leading batch
    axis, ``per_operand`` tensors an operand (1 real, 2 planar) and
    ``core_rank`` trailing dims. Operands may have different batch ranks
    (``batch_ndims``, e.g. a (B, d, n) signal and a (d, n) kernel): each
    chain runs on its own batch flattened to one axis, and ``pointwise``
    sees every spectrum with its own batch shape restored, so it
    broadcasts them numpy-style. ``baked`` are planar spectra already in
    the native form (``baked_batch_ndims`` leading dims each). The chains
    run one after another; eager PyTorch rounds every product on its own,
    so each chain gives the bits its standalone transform gives."""
    n_main = len(batch_ndims)

    def lead(t: torch.Tensor, nb: int, what: str) -> Tuple[int, ...]:
        if t.ndim != nb + core_rank:
            raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {nb} "
                             f"batch dims before {core_rank} transform dims")
        return tuple(t.shape[:nb])

    def run(chain, parts, batch):
        flat = [p.reshape((math.prod(batch),) + tuple(p.shape[len(batch):])) for p in parts]
        out = chain(*flat)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(o.reshape(batch + tuple(o.shape[1:])) for o in out)

    def fn(*args):
        if len(args) != per_operand * n_main + 2 * len(baked_batch_ndims):
            raise ValueError(f"operator takes {n_main} operands of {per_operand} tensors "
                             f"and {len(baked_batch_ndims)} baked pairs, got {len(args)} "
                             "tensors")
        specs = []
        for i, nb in enumerate(batch_ndims):
            parts = args[per_operand * i:per_operand * (i + 1)]
            specs.append(run(fwd, parts, lead(parts[0], nb, f"operand {i}")))
        baked = args[per_operand * n_main:]
        pairs = [(baked[2 * j], baked[2 * j + 1]) for j in range(len(baked) // 2)]
        for (br, _), nb in zip(pairs, baked_batch_ndims):
            lead(br, nb, "a baked spectrum")
        re, im = pointwise(*specs[0], *specs[1:], *pairs)
        y = run(inv, (re, im), tuple(re.shape[:re.ndim - core_rank]))
        return y[0] if len(y) == 1 else y

    return fn


def make_fused_op(plan: PencilPlan, pointwise: Callable, *,
                  batch_ndims: Tuple[int, ...] = (0,),
                  baked_batch_ndims: Tuple[int, ...] = (),
                  overlap_chunks: int = 1) -> Tuple[Callable, Layout, Layout]:
    """The per-rank fused spectral operator of a rank-2/3 plan: the
    forward schedule spliced to the reversed inverse schedule at the
    spectrum, ``pointwise`` applied to this rank's block of it in
    whatever layout the forward left it (the native one: for a real
    plan the padded half spectrum, so no boundary gather or scatter).

    ``pointwise(re, im, *extras)`` gets this rank's planar spectrum, then
    one planar pair an extra operand and a baked spectrum, and must be
    elementwise in the bins. Real plans: ``fn(x, *extras, *baked) -> y``
    (real blocks under the plan's layout); complex plans take a planar
    pair an operand, ``fn(re, im, *extra_pairs, *baked) -> (re, im)``.
    ``batch_ndims`` are the operands' batch ranks (the main one first),
    ``baked_batch_ndims`` those of the baked pairs (see
    :func:`splice_op`). The r2c/c2r ends run on the packed (padded) plan
    and ``overlap_chunks`` pipelines every (fft, swap) pair, as in the
    plan's own forward and inverse, so the operator gives the bits of
    forward -> pointwise -> inverse run one by one.

    Returns ``(fn, in_layout, spec_layout)``."""
    fwd, in_layout, spec_layout = make_fft(plan, overlap_chunks=overlap_chunks)
    inv, _, _ = make_fft(plan, inverse=True, overlap_chunks=overlap_chunks)
    fn = splice_op(fwd, inv, pointwise, per_operand=1 if plan.real else 2,
                   core_rank=len(plan.shape), batch_ndims=tuple(batch_ndims),
                   baked_batch_ndims=tuple(baked_batch_ndims))
    return fn, in_layout, spec_layout
