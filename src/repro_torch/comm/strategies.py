"""The redistribution strategies: prices for all, the all-to-all swap.

Port of ``repro.comm.strategies``. Every strategy of the reference is
registered with its cost (``Strategy.cost``, the hook the ``comm='auto'``
selector ranks with), so the port's selector sees the reference's
candidates and makes the reference's pick. Only ``'all_to_all'`` can
swap yet; ``'ppermute'``, ``'hierarchical'`` and ``'pod_tree:<spec>'``
price and raise (:func:`check_runnable`, ROADMAP queue 1, 'Other
strategies').

A swap runs on each rank's LOCAL block, with the semantics of
``lax.all_to_all(x, axis, split_axis=mem_pos, concat_axis=shard_pos,
tiled=True)``: split local axis ``mem_pos`` into one block per group
member, send block i to member i, and concatenate the received blocks
along ``shard_pos`` in member order. It comes in two halves, so that a
pipeline can queue compute while a swap is in flight:
``swap_start`` packs the blocks and starts an asynchronous collective,
and the returned :class:`PendingSwap`'s ``wait`` finishes it and
unpacks; a synchronous swap is the one followed by the other.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import wse_model as wm
from repro_torch.core.plan import WIRE_DTYPES, MeshAxis

#: what a plan whose strategy cannot swap yet raises with
NOT_PORTED = "ROADMAP queue 1, 'Other strategies'"


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
    many."""
    w, restore = wire_cast(x, wire_dtype)
    h = strategy.swap_start(w, mesh, mesh_axis, shard_pos=shard_pos, mem_pos=mem_pos)
    return PendingSwap(lambda: wire_restore(h.wait(), restore))


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
    bytes, ``cost`` prices one swap in the paper's cycle model for the
    selector. A strategy the port can run overrides ``swap_start``
    (:func:`check_runnable`)."""
    name: str = ''
    description: str = ''

    def swap_start(self, x: torch.Tensor, mesh, mesh_axis: MeshAxis, *,
                   shard_pos: int, mem_pos: int) -> PendingSwap:
        raise _not_ported(self.name)

    def cost(self, mesh_axis: MeshAxis, mesh_shape, elems: float,
             precision: wm.Precision, *,
             axis_bw: Optional[Mapping[str, float]] = None) -> wm.SwapCost:
        """Predicted cycles for one swap of ``elems`` local complex
        elements over ``mesh_axis`` of a mesh with extents ``mesh_shape``
        (a name -> size mapping; no process group needed). ``axis_bw``
        maps axis name -> relative bandwidth weight."""
        raise NotImplementedError


class AllToAllStrategy(Strategy):
    name = 'all_to_all'
    description = 'one dist.all_to_all_single on the mesh-axis group'

    def swap_start(self, x, mesh, mesh_axis, *, shard_pos, mem_pos):
        p = static_group_size(mesh_axis, mesh.shape)
        if p == 1:
            return PendingSwap(lambda: x)
        m = x.shape[mem_pos]
        if m % p:
            raise ValueError(
                f"swap: mem axis size {m} not divisible by group size {p} "
                f"of {mesh_axis!r}")
        pg, members = mesh.group(mesh_axis)
        # the collective orders blocks by group rank; the swap orders
        # them by row-major position in the (tuple) axis group. The
        # reorder takes slices, not an index list: a list index is copied
        # to the card by a blocking copy, which stalls the host until the
        # card has drained its queue, twice a swap.
        by_rank = dist.get_process_group_ranks(pg)
        pos = [members.index(r) for r in by_rank]
        blocks = x.movedim(mem_pos, 0).reshape((p, m // p) + _rest(x, mem_pos))
        send = torch.cat([blocks[i:i + 1] for i in pos])
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=pg, async_op=True)
        shape = list(x.shape)
        shape[mem_pos] = m // p
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


class PpermuteStrategy(Strategy):
    """Pairwise ring (p-1 rounds of point-to-point sends); priced only."""
    name = 'ppermute'
    description = 'p-1 pairwise rounds per axis (ring schedule); not ported'

    def cost(self, mesh_axis, mesh_shape, elems, precision, *, axis_bw=None):
        p = static_group_size(mesh_axis, mesh_shape)
        return _scale_wire(
            wm.swap_cost_ring(p, elems, precision, strategy=self.name),
            _group_bw(mesh_axis, axis_bw))


class PodTreeStrategy(Strategy):
    """Phased pod-tree exchange over a factorization; priced only.

    ``tree`` maps axis name -> factor sequence (most significant digit
    first); axes of the swap group it does not name get one full-extent
    level. ``tree=None`` is the two-phase 'hierarchical' split."""

    def __init__(self, tree: Optional[Mapping[str, Tuple[int, ...]]] = None):
        self.tree: Optional[Tree] = (
            None if tree is None
            else {a: tuple(int(f) for f in fs) for a, fs in tree.items()})
        if self.tree is not None:
            spec = format_tree_spec(self.tree)
            self.name = POD_TREE_PREFIX + spec
            self.description = f'phased pod-tree exchange over {spec}; not ported'

    def _levels(self, mesh_axis, mesh_shape):
        """The tree as ``(axis, factor, stride)`` phases in digit
        significance order; ``stride`` is the digit's place value."""
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
    description = 'two-phase pod split (outer, then inner all_to_all); not ported'

    def __init__(self):
        super().__init__(None)


@functools.lru_cache(maxsize=256)
def _pod_tree_strategy(name: str) -> Strategy:
    return PodTreeStrategy(parse_tree_spec(name[len(POD_TREE_PREFIX):]))


_REGISTRY: Dict[str, Strategy] = {
    s.name: s for s in (AllToAllStrategy(), PpermuteStrategy(), HierarchicalStrategy())}


def names() -> Tuple[str, ...]:
    """Registered strategy names, runnable or not (the selector's
    candidates; excludes the 'auto' alias and pod trees)."""
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
    """``name`` if the port can run its swap, else NotImplementedError
    naming the ROADMAP item."""
    if type(get(name)).swap_start is Strategy.swap_start:
        raise _not_ported(name)
    return name


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"comm strategy {name!r} is priced but cannot swap yet: {NOT_PORTED}")


def resolve(name: str) -> Strategy:
    return get('all_to_all' if name == 'auto' else name)
