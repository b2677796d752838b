"""The redistribution strategies: their prices and their swaps.

Port of ``repro.comm.strategies``. Every strategy of the reference is
registered with its cost (``Strategy.cost``, the hook the ``comm='auto'``
selector ranks with) and its swap:

* ``'all_to_all'``: one ``dist.all_to_all_single`` on the axis group;
* ``'ppermute'``: a ring of p-1 point-to-point rounds
  (``dist.batch_isend_irecv``), round s sending each rank's block for
  its s-th successor; a tuple group runs one ring an axis, then one
  local reorder (:func:`_phased_swap_start`);
* ``'hierarchical'`` and ``'pod_tree:<spec>'``: one exchange a level of
  a factorization of each axis, an ``all_to_all`` where the level covers
  its whole axis and a digit ring (:func:`_digit_ring_start`) where it
  is a proper factor, then the same local digit reversal.

Every swap is pure data movement, so all of them give the same bits.

A swap runs on each rank's LOCAL block, with the semantics of
``lax.all_to_all(x, axis, split_axis=mem_pos, concat_axis=shard_pos,
tiled=True)``: split local axis ``mem_pos`` into one block per group
member, send block i to member i, and concatenate the received blocks
along ``shard_pos`` in member order. It comes in two halves, so that a
pipeline can queue compute while a swap is in flight:
``swap_start`` packs the blocks and starts the asynchronous exchange
(a phased swap finishes its earlier phases first), and the returned
:class:`PendingSwap`'s ``wait`` finishes it and unpacks; a synchronous
swap is the one followed by the other.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import plan as planlib
from repro_torch.core import wse_model as wm
from repro_torch.core.plan import WIRE_DTYPES, Layout, MeshAxis


def axis_tuple(mesh_axis: MeshAxis) -> Tuple[str, ...]:
    """Canonicalize a mesh-axis spec to a tuple of axis names."""
    if mesh_axis is None:
        return ()
    return mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)


def static_group_size(mesh_axis: MeshAxis, mesh_shape) -> int:
    """Group size from a name -> extent mapping."""
    p = 1
    for a in axis_tuple(mesh_axis):
        p *= mesh_shape[a]
    return p


def group_size(mesh, mesh_axis: MeshAxis) -> int:
    """The extent of a (tuple) mesh-axis group. The reference reads it
    from the ``shard_map`` context; here the mesh is passed."""
    return static_group_size(mesh_axis, mesh.shape)


def group_index(mesh, mesh_axis: MeshAxis) -> int:
    """This rank's row-major flat index within the (tuple) mesh-axis
    group, the member order of every swap: 0 on a one-rank mesh."""
    return mesh.group_index(mesh_axis)


def _group_bw(mesh_axis: MeshAxis,
              axis_bw: Optional[Mapping[str, float]]) -> float:
    """Bandwidth weight of a (tuple) axis group: its slowest link class."""
    axes = axis_tuple(mesh_axis)
    if not axis_bw or not axes:
        return 1.0
    return max(float(axis_bw.get(a, 1.0)) for a in axes)


def _scale_wire(cost: wm.SwapCost, bw: float) -> wm.SwapCost:
    if bw == 1.0:
        return cost
    return wm.SwapCost(cost.strategy, cost.p, cost.elems,
                       cost.wire_cycles * bw, cost.fixed_cycles)


# ---------------------------------------------------------------------------
# Wire formats: cast to 16 bits around the collective only
# ---------------------------------------------------------------------------

_WIRE_TORCH = {'fp16': torch.float16, 'bf16': torch.bfloat16}


def validate_wire_dtype(wire_dtype: str) -> str:
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}; known: {WIRE_DTYPES}")
    return wire_dtype


def wire_elem_bytes(wire_dtype: str, native_bytes: int) -> int:
    """Bytes one (planar float) element occupies on the wire."""
    if wire_dtype == 'native':
        return native_bytes
    return min(native_bytes, 2)


def wire_cast(x: torch.Tensor, wire_dtype: str):
    """``(wire_operand, restore_dtype)``; ``restore_dtype`` is None when
    no cast happened (native wire, or an operand already that narrow)."""
    if wire_dtype == 'native':
        return x, None
    wd = _WIRE_TORCH[validate_wire_dtype(wire_dtype)]
    if not x.is_floating_point() or x.element_size() <= torch.finfo(wd).bits // 8:
        return x, None
    return x.to(wd), x.dtype


def wire_restore(x: torch.Tensor, restore_dtype) -> torch.Tensor:
    if restore_dtype is None:
        return x
    return x.to(restore_dtype)


class PendingSwap:
    """A started swap. ``wait()`` finishes it (waits for the collective,
    unpacks the received blocks) and returns the swapped tensor. The
    closure holds the send and receive buffers until then."""

    def __init__(self, finish: Callable[[], torch.Tensor]):
        self._finish = finish

    def wait(self) -> torch.Tensor:
        return self._finish()


def swap_start_wire(strategy: 'Strategy', x: torch.Tensor, mesh, mesh_axis: MeshAxis,
                    *, shard_pos: int, mem_pos: int,
                    wire_dtype: str = 'native') -> PendingSwap:
    """Start one ownership swap with the operand cast to the wire format;
    the restore happens in ``wait``. A group of one rank runs no
    collective but still takes the cast and the restore, as the
    reference does, so a 16-bit wire rounds the same on one rank as on
    many.

    Every swap of a plan starts here, so this is where it becomes
    differentiable: when ``x`` requires grad, the swap runs on a detached
    operand and its result is handed to autograd by :class:`_Swapped`,
    whose backward is the reverse swap. Otherwise no node is added."""
    track = torch.is_grad_enabled() and x.requires_grad
    w, restore = wire_cast(x.detach() if track else x, wire_dtype)
    h = strategy.swap_start(w, mesh, mesh_axis, shard_pos=shard_pos, mem_pos=mem_pos)
    if not track:
        return PendingSwap(lambda: wire_restore(h.wait(), restore))

    def reverse(g: torch.Tensor) -> torch.Tensor:
        return swap_start_wire(strategy, g.contiguous(), mesh, mesh_axis, shard_pos=mem_pos,
                               mem_pos=shard_pos, wire_dtype=wire_dtype).wait()
    return PendingSwap(lambda: _Swapped.apply(x, wire_restore(h.wait(), restore), reverse))


class _Swapped(torch.autograd.Function):
    """A finished swap as autograd sees it: ``apply(x, y, reverse)``
    returns ``y``, the swap of ``x`` computed outside autograd, and the
    backward maps the cotangent of ``y`` to that of ``x`` by
    ``reverse``: the same strategy over the same group with ``shard_pos``
    and ``mem_pos`` exchanged (the adjoint of the tiled all-to-all), under
    the same wire format (the reference's cast transposes to a cast).
    The reverse swap blocks inside its own backward and starts nothing
    asynchronously, so a chunked plan's swaps run one node at a time, in
    the order autograd walks the graph, the same on every rank."""

    @staticmethod
    def forward(ctx, x, y, reverse):
        ctx.reverse = reverse
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.reverse(g), None, None


# ---------------------------------------------------------------------------
# Gather, sum and reduce-scatter over a group (the language models'
# tensor- and data-parallel collectives)
# ---------------------------------------------------------------------------
#
# Each collective's backward follows from how the ranks of the group use
# its result. A result every rank uses alike (the same computation on
# the same data) has the same, complete cotangent on every rank; a
# result the ranks use apart (each on its own batch block, or each with
# its own heads) has a partial cotangent on each rank, and the group's
# sum of them is the whole.

def _gather(x: torch.Tensor, mesh, mesh_axis: MeshAxis, dim: int) -> torch.Tensor:
    pg, members = mesh.group(mesh_axis)
    by_rank = dist.get_process_group_ranks(pg)
    got = [torch.empty_like(x) for _ in by_rank]
    dist.all_gather(got, x.contiguous(), group=pg)
    return torch.cat([got[by_rank.index(r)] for r in members], dim)


def _reduce_scatter(x: torch.Tensor, mesh, mesh_axis: MeshAxis, dim: int) -> torch.Tensor:
    pg, members = mesh.group(mesh_axis)
    by_rank = dist.get_process_group_ranks(pg)
    blocks = x.chunk(len(members), dim)
    # reduce_scatter_tensor hands group rank i the i-th block of dim 0
    send = torch.cat([blocks[members.index(r)].movedim(dim, 0) for r in by_rank]).contiguous()
    out = send.new_empty((send.shape[0] // len(members),) + tuple(send.shape[1:]))
    dist.reduce_scatter_tensor(out, send, group=pg)
    return out.movedim(0, dim)


class _Gathered(torch.autograd.Function):
    """An all-gather whose result the group uses alike: the cotangent of
    this rank's block is its own slice of the result's cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_axis, dim):
        ctx.block = (group_index(mesh, mesh_axis) * x.shape[dim], x.shape[dim], dim)
        return _gather(x, mesh, mesh_axis, dim)

    @staticmethod
    def backward(ctx, g):
        start, n, dim = ctx.block
        return g.narrow(dim, start, n), None, None, None


class _GatheredApart(torch.autograd.Function):
    """An all-gather whose result the ranks of the group use apart (an
    FSDP leaf gathered over 'data', each rank on its batch block; MQA's
    key and value weights, each rank with its heads): the cotangent of
    this rank's block is its slice of the group's sum of the result's
    cotangents (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_axis, dim):
        ctx.args = (mesh, mesh_axis, dim)
        return _gather(x, mesh, mesh_axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


def all_gather(x: torch.Tensor, mesh, mesh_axis: MeshAxis, dim: int, *,
               alike: bool = True) -> torch.Tensor:
    """Every group member's block of ``x`` concatenated along ``dim`` in
    the group's row-major member order (``lax.all_gather(..., tiled=True)``).
    A group of one returns ``x``. Differentiable: ``alike`` says how the
    group uses the result, alike on every rank (the backward takes this
    rank's slice, :class:`_Gathered`) or apart (the backward is a
    reduce-scatter, :class:`_GatheredApart`)."""
    if static_group_size(mesh_axis, mesh.shape) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return (_Gathered if alike else _GatheredApart).apply(x, mesh, mesh_axis, dim)
    return _gather(x, mesh, mesh_axis, dim)


def reduce_scatter(x: torch.Tensor, mesh, mesh_axis: MeshAxis, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the group
    (``lax.psum_scatter(..., tiled=True)``): ``dist.reduce_scatter_tensor``;
    the blocks in the group's row-major member order, as
    :func:`all_gather`'s. A group of one returns ``x``. Not
    differentiable (it is a backward)."""
    if static_group_size(mesh_axis, mesh.shape) == 1:
        return x
    if x.shape[dim] % static_group_size(mesh_axis, mesh.shape):
        raise ValueError(f'reduce_scatter: dim {dim} of {tuple(x.shape)} does not split '
                         f'over {static_group_size(mesh_axis, mesh.shape)} ranks')
    return _reduce_scatter(x, mesh, mesh_axis, dim)


class _Summed(torch.autograd.Function):
    """A sum over the group whose result every rank uses alike: the
    cotangent passes through (the row-parallel product's backward)."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_axis):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=mesh.group(mesh_axis)[0])
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce(x: torch.Tensor, mesh, mesh_axis: MeshAxis) -> torch.Tensor:
    """The sum of ``x`` over the group (``lax.psum``), IN PLACE where
    ``x`` needs no gradient; a group of one returns ``x``."""
    if static_group_size(mesh_axis, mesh.shape) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Summed.apply(x, mesh, mesh_axis)
    x = x.contiguous()
    dist.all_reduce(x, group=mesh.group(mesh_axis)[0])
    return x


class _Entered(torch.autograd.Function):
    """A value every rank of the group holds alike entering a computation
    the ranks split (a column-parallel product, a rank's heads or
    sequence block): the identity forward, and the sum of the ranks'
    partial cotangents backward (Megatron's ``f``, the conjugate of
    :class:`_Summed`)."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_axis):
        ctx.args = (mesh, mesh_axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.args[0].group(ctx.args[1])[0])
        return g, None, None


def enter(x: torch.Tensor, mesh, mesh_axis: MeshAxis) -> torch.Tensor:
    """``x``, whose cotangent is summed over the group in the backward
    (:class:`_Entered`); ``x`` itself where no gradient is wanted or the
    group has one rank."""
    if (static_group_size(mesh_axis, mesh.shape) == 1
            or not (torch.is_grad_enabled() and x.requires_grad)):
        return x
    return _Entered.apply(x, mesh, mesh_axis)


# ---------------------------------------------------------------------------
# Pod-tree specs: 'pod_tree:x.4*y.2*y.2' <-> {'x': (4,), 'y': (2, 2)}
# ---------------------------------------------------------------------------

POD_TREE_PREFIX = 'pod_tree:'

Tree = Dict[str, Tuple[int, ...]]


def parse_tree_spec(spec: str) -> Tree:
    """Parse a pod-tree spec: '*'-joined ``<axis>.<factor>`` levels,
    factors >= 2, per-axis order = digit significance (most significant
    first)."""
    tree: Dict[str, list] = {}
    if not spec:
        raise ValueError("empty pod_tree spec")
    for part in spec.split('*'):
        axis, sep, fac = part.rpartition('.')
        if not sep or not axis or not fac.isdigit() or int(fac) < 2:
            raise ValueError(
                f"bad pod_tree level {part!r} in spec {spec!r}; expected "
                f"'<axis>.<factor>' with an integer factor >= 2")
        tree.setdefault(axis, []).append(int(fac))
    return {a: tuple(fs) for a, fs in tree.items()}


def format_tree_spec(tree: Mapping[str, Tuple[int, ...]]) -> str:
    """Canonical spec string (axes sorted by name)."""
    return '*'.join(f'{a}.{f}' for a in sorted(tree) for f in tree[a])


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

class Strategy:
    """One registered redistribution schedule: ``swap_start`` moves the
    bytes (``swap_axes`` and ``swap`` are its blocking forms), ``cost``
    prices one swap in the paper's cycle model for the selector."""
    name: str = ''
    description: str = ''

    def swap_axes(self, x: torch.Tensor, mesh, mesh_axis: MeshAxis, *,
                  shard_pos: int, mem_pos: int) -> torch.Tensor:
        """Exchange ownership: split local axis ``mem_pos`` across the
        group, concatenate the received blocks (in group order) along
        ``shard_pos``. Blocking; differentiable, its adjoint the reverse
        swap (:class:`_Swapped`)."""
        return swap_start_wire(self, x, mesh, mesh_axis, shard_pos=shard_pos,
                               mem_pos=mem_pos).wait()

    def swap(self, x: torch.Tensor, layout: Layout, mesh, mesh_axis: MeshAxis,
             mem_pos: int) -> Tuple[torch.Tensor, Layout]:
        """:meth:`swap_axes` plus the layout bookkeeping the planners thread."""
        y = self.swap_axes(x, mesh, mesh_axis, shard_pos=planlib.owner_pos(layout, mesh_axis),
                           mem_pos=mem_pos)
        return y, planlib.swap(layout, mesh_axis, mem_pos)

    def swap_start(self, x: torch.Tensor, mesh, mesh_axis: MeshAxis, *,
                   shard_pos: int, mem_pos: int) -> PendingSwap:
        raise NotImplementedError

    def cost(self, mesh_axis: MeshAxis, mesh_shape, elems: float,
             precision: wm.Precision, *,
             axis_bw: Optional[Mapping[str, float]] = None) -> wm.SwapCost:
        """Predicted cycles for one swap of ``elems`` local complex
        elements over ``mesh_axis`` of a mesh with extents ``mesh_shape``
        (a name -> size mapping; no process group needed). ``axis_bw``
        maps axis name -> relative bandwidth weight."""
        raise NotImplementedError


def _done(x: torch.Tensor) -> PendingSwap:
    return PendingSwap(lambda: x)


def _blocks(x: torch.Tensor, mem_pos: int, p: int, what: str) -> int:
    """The block length of ``x``'s mem axis split p ways; raises where p
    does not divide it (a swap never truncates)."""
    m = x.shape[mem_pos]
    if m % p:
        raise ValueError(f"{what}: mem axis size {m} not divisible by group size {p}")
    return m // p


class AllToAllStrategy(Strategy):
    name = 'all_to_all'
    description = 'one dist.all_to_all_single on the mesh-axis group'

    def swap_start(self, x, mesh, mesh_axis, *, shard_pos, mem_pos):
        p = static_group_size(mesh_axis, mesh.shape)
        if p == 1:
            return _done(x)
        blk = _blocks(x, mem_pos, p, f"swap over {mesh_axis!r}")
        pg, members = mesh.group(mesh_axis)
        # the collective orders blocks by group rank; the swap orders
        # them by row-major position in the (tuple) axis group. The
        # reorder takes slices, not an index list: a list index is copied
        # to the card by a blocking copy, which stalls the host until the
        # card has drained its queue, twice a swap.
        by_rank = dist.get_process_group_ranks(pg)
        pos = [members.index(r) for r in by_rank]
        blocks = x.movedim(mem_pos, 0).reshape((p, blk) + _rest(x, mem_pos))
        send = torch.cat([blocks[i:i + 1] for i in pos])
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=pg, async_op=True)
        shape = list(x.shape)
        shape[mem_pos] = blk
        shape[shard_pos] *= p

        def finish(send=send) -> torch.Tensor:
            # ``send`` is bound here so it outlives the collective
            work.wait()
            got = torch.cat([recv[pos.index(j):pos.index(j) + 1] for j in range(p)])
            # got[j] = member j's block for us, laid out (m/p, *rest): put
            # the mem axis back, then concatenate the members at shard_pos
            y = got.movedim(1, mem_pos + 1).movedim(0, shard_pos)
            return y.reshape(shape).contiguous()
        return PendingSwap(finish)

    def cost(self, mesh_axis, mesh_shape, elems, precision, *, axis_bw=None):
        p = static_group_size(mesh_axis, mesh_shape)
        return _scale_wire(
            wm.swap_cost_a2a(p, elems, precision, strategy=self.name),
            _group_bw(mesh_axis, axis_bw))


def _rest(x: torch.Tensor, skip: int) -> Tuple[int, ...]:
    return tuple(s for i, s in enumerate(x.shape) if i != skip)


def _p2p_swap_start(x: torch.Tensor, pg, ranks: Sequence[int], me: int, *,
                    shard_pos: int, mem_pos: int, what: str) -> PendingSwap:
    """The tiled all-to-all among ``ranks`` (global ranks, in block
    order; this rank is ``ranks[me]``) as f-1 point-to-point rounds:
    round s sends the block for the s-th successor and receives the s-th
    predecessor's, one ``dist.batch_isend_irecv`` a round. Every round
    is started here; the own block keeps its slot."""
    f = len(ranks)
    blk = _blocks(x, mem_pos, f, what)
    got = [None] * f
    got[me] = x.narrow(mem_pos, me * blk, blk)
    sends, works = [], []
    for s in range(1, f):
        dst, src = (me + s) % f, (me - s) % f
        send = x.narrow(mem_pos, dst * blk, blk).contiguous()
        got[src] = torch.empty_like(send)
        works += dist.batch_isend_irecv([dist.P2POp(dist.isend, send, ranks[dst], pg),
                                         dist.P2POp(dist.irecv, got[src], ranks[src], pg)])
        sends.append(send)

    def finish(sends=sends) -> torch.Tensor:
        # ``sends`` is bound here so the buffers outlive their rounds
        for w in works:
            w.wait()
        return torch.cat(got, dim=shard_pos)
    return PendingSwap(finish)


def _digit_ring_start(x: torch.Tensor, mesh, axis: str, factor: int, stride: int, *,
                      shard_pos: int, mem_pos: int) -> PendingSwap:
    """One level of a phased swap as a ring: the swap within the
    ``factor`` members of ``axis`` that agree on every digit but the one
    of place value ``stride`` (axis index i has digit
    ``(i // stride) % factor``), as factor-1 point-to-point rounds; the
    round-s peer of index i is ``i + (((d_i + s) % factor) - d_i) * stride``.
    The received blocks land in digit order along ``shard_pos``. With
    ``factor`` the axis's extent (stride 1) it is the ring over the
    whole axis."""
    pg, members = mesh.group(axis)
    i = mesh.group_index(axis)
    d = (i // stride) % factor
    ranks = [members[i + (e - d) * stride] for e in range(factor)]
    return _p2p_swap_start(x, pg, ranks, d, shard_pos=shard_pos, mem_pos=mem_pos,
                           what=f"ring swap over factor {factor} of axis {axis!r}")


def _phased_swap_start(x: torch.Tensor, mesh, levels, *, shard_pos: int, mem_pos: int,
                       rings_only: bool) -> PendingSwap:
    """A swap over an axis group as one exchange a level.

    ``levels`` are ``(axis, factor, stride)`` phases in digit
    significance order, each factor > 1. A level that covers its whole
    axis is an ``all_to_all`` over it unless ``rings_only``; every other
    level is a ring (:func:`_digit_ring_start`). Earlier levels finish
    before the last starts. The flat group order is row-major, so the
    received shard order is (last level, ..., first level, seg); one
    local digit reversal restores it: the same bits as one exchange over
    the whole group."""
    if not levels:
        return _done(x)          # extent-1 group: nothing moves
    seg = x.shape[shard_pos]

    def start(t, a, f, stride):
        if f == mesh.shape[a] and not rings_only:
            return _A2A.swap_start(t, mesh, a, shard_pos=shard_pos, mem_pos=mem_pos)
        return _digit_ring_start(t, mesh, a, f, stride, shard_pos=shard_pos,
                                 mem_pos=mem_pos)
    for lv in levels[:-1]:
        x = start(x, *lv).wait()
    h = start(x, *levels[-1])
    if len(levels) == 1:
        return h
    fs = tuple(f for _, f, _ in levels)
    k = len(fs)

    def finish() -> torch.Tensor:
        y = h.wait()
        shp = y.shape
        y = y.reshape(shp[:shard_pos] + fs[::-1] + (seg,) + shp[shard_pos + 1:])
        perm = (tuple(range(shard_pos))
                + tuple(shard_pos + k - 1 - i for i in range(k))
                + tuple(range(shard_pos + k, y.ndim)))
        return y.permute(perm).reshape(shp).contiguous()
    return PendingSwap(finish)


class PpermuteStrategy(Strategy):
    name = 'ppermute'
    description = ('p-1 pairwise rounds per axis (ring schedule; '
                   'point-to-point only)')

    def swap_start(self, x, mesh, mesh_axis, *, shard_pos, mem_pos):
        # one ring an axis, outer axis first
        levels = [(a, mesh.shape[a], 1) for a in axis_tuple(mesh_axis) if mesh.shape[a] > 1]
        return _phased_swap_start(x, mesh, levels, shard_pos=shard_pos, mem_pos=mem_pos,
                                  rings_only=True)

    def cost(self, mesh_axis, mesh_shape, elems, precision, *, axis_bw=None):
        p = static_group_size(mesh_axis, mesh_shape)
        return _scale_wire(
            wm.swap_cost_ring(p, elems, precision, strategy=self.name),
            _group_bw(mesh_axis, axis_bw))


class PodTreeStrategy(Strategy):
    """Phased pod-tree exchange over a factorization.

    ``tree`` maps axis name -> factor sequence (most significant digit
    first); axes of the swap group it does not name get one full-extent
    level. The swap runs one exchange a level in digit-significance
    order (the group's axis order, then each axis's factors), then one
    local reorder restores the row-major group order
    (:func:`_phased_swap_start`). ``tree=None`` is the two-phase
    'hierarchical' split (one level per axis)."""

    def __init__(self, tree: Optional[Mapping[str, Tuple[int, ...]]] = None):
        self.tree: Optional[Tree] = (
            None if tree is None
            else {a: tuple(int(f) for f in fs) for a, fs in tree.items()})
        if self.tree is not None:
            spec = format_tree_spec(self.tree)
            self.name = POD_TREE_PREFIX + spec
            self.description = (f'phased pod-tree exchange over factorization {spec} '
                                 f'(grouped sub-swaps + one local reorder)')

    def _levels(self, mesh_axis, mesh_shape):
        """The tree as ``(axis, factor, stride)`` phases in digit
        significance order; ``stride`` is the digit's place value. Tree
        axes outside the swap group are ignored."""
        levels = []
        for a in axis_tuple(mesh_axis):
            extent = mesh_shape[a]
            factors = ((self.tree or {}).get(a) or (extent,))
            prod = 1
            for f in factors:
                prod *= f
            if prod != extent:
                raise ValueError(
                    f"pod_tree factors {factors} for axis {a!r} multiply "
                    f"to {prod}, not its extent {extent}")
            stride = extent
            for f in factors:
                stride //= f
                levels.append((a, int(f), stride))
        return levels

    def swap_start(self, x, mesh, mesh_axis, *, shard_pos, mem_pos):
        levels = [lv for lv in self._levels(mesh_axis, mesh.shape) if lv[1] > 1]
        return _phased_swap_start(x, mesh, levels, shard_pos=shard_pos, mem_pos=mem_pos,
                                  rings_only=False)

    def cost(self, mesh_axis, mesh_shape, elems, precision, *, axis_bw=None):
        wm_levels = []
        for a, f, stride in self._levels(mesh_axis, mesh_shape):
            kind = 'a2a' if f == mesh_shape[a] else 'ring'
            bw = 1.0 if not axis_bw else float(axis_bw.get(a, 1.0))
            if kind == 'ring':
                # a stride-v digit ring's messages travel v x the links
                bw *= max(int(stride), 1)
            wm_levels.append((f, kind, bw))
        return wm.swap_cost_tree(tuple(wm_levels), elems, precision,
                                 strategy=self.name)


class HierarchicalStrategy(PodTreeStrategy):
    name = 'hierarchical'
    description = ('two-phase pod-split exchange (outer-axis all_to_all, '
                   'inner-axis all_to_all, local reorder)')

    def __init__(self):
        super().__init__(None)


@functools.lru_cache(maxsize=256)
def _pod_tree_strategy(name: str) -> Strategy:
    return PodTreeStrategy(parse_tree_spec(name[len(POD_TREE_PREFIX):]))


_REGISTRY: Dict[str, Strategy] = {}


def register(strategy: Strategy) -> Strategy:
    """Add ``strategy`` to the registry under its name (a name already
    taken raises ``ValueError``); returns it."""
    if strategy.name in _REGISTRY:
        raise ValueError(f"comm strategy {strategy.name!r} already registered")
    _REGISTRY[strategy.name] = strategy
    return strategy


_A2A = register(AllToAllStrategy())
register(PpermuteStrategy())
register(HierarchicalStrategy())


def names() -> Tuple[str, ...]:
    """Registered strategy names (the selector's candidates; excludes
    the 'auto' alias and pod trees)."""
    return tuple(_REGISTRY)


def get(name: str) -> Strategy:
    if name.startswith(POD_TREE_PREFIX):
        return _pod_tree_strategy(name)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown comm strategy {name!r}; known: "
            f"{names() + ('auto', POD_TREE_PREFIX + '<spec>')}") from None


def validate(name: str) -> str:
    """'auto', a registered name or a well-formed pod-tree name; returns
    the canonical spelling."""
    if name == 'auto':
        return name
    return get(name).name


def check_runnable(name: str) -> str:
    """``name`` if its strategy has a swap, else NotImplementedError:
    a plan never runs a strategy that can only be priced."""
    if type(get(name)).swap_start is Strategy.swap_start:
        raise NotImplementedError(f"comm strategy {name!r} is priced but has no swap")
    return name


def resolve(name: str) -> Strategy:
    return get('all_to_all' if name == 'auto' else name)
