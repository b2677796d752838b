"""The all-to-all ownership swap over ``torch.distributed``.

Port of ``repro.comm.strategies``: ``static_group_size``, the wire
formats (``wire_cast``/``wire_restore``/``swap_axes_wire``) and
``AllToAllStrategy``. The other strategies (ring, hierarchical, pod
trees) are a later slice.

A swap runs on each rank's LOCAL block, with the semantics of
``lax.all_to_all(x, axis, split_axis=mem_pos, concat_axis=shard_pos,
tiled=True)``: split local axis ``mem_pos`` into one block per group
member, send block i to member i, and concatenate the received blocks
along ``shard_pos`` in member order.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.plan import WIRE_DTYPES, MeshAxis


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


# ---------------------------------------------------------------------------
# Wire formats: cast to 16 bits around the collective only
# ---------------------------------------------------------------------------

_WIRE_TORCH = {'fp16': torch.float16, 'bf16': torch.bfloat16}


def validate_wire_dtype(wire_dtype: str) -> str:
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}; known: {WIRE_DTYPES}")
    return wire_dtype


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


def swap_axes_wire(strategy: 'Strategy', x: torch.Tensor, mesh, mesh_axis: MeshAxis,
                   *, shard_pos: int, mem_pos: int,
                   wire_dtype: str = 'native') -> torch.Tensor:
    """One ownership swap, the operand cast to the wire format around
    the collective only. A group of one rank runs no collective but
    still takes the cast and the restore, as the reference does, so a
    16-bit wire rounds the same on one rank as on many."""
    w, restore = wire_cast(x, wire_dtype)
    y = strategy.swap_axes(w, mesh, mesh_axis, shard_pos=shard_pos,
                           mem_pos=mem_pos)
    return wire_restore(y, restore)


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

class Strategy:
    """One registered redistribution schedule."""
    name: str = ''
    description: str = ''

    def swap_axes(self, x: torch.Tensor, mesh, mesh_axis: MeshAxis, *,
                  shard_pos: int, mem_pos: int) -> torch.Tensor:
        raise NotImplementedError


class AllToAllStrategy(Strategy):
    name = 'all_to_all'
    description = 'one dist.all_to_all_single on the mesh-axis group'

    def swap_axes(self, x, mesh, mesh_axis, *, shard_pos, mem_pos):
        p = static_group_size(mesh_axis, mesh.shape)
        if p == 1:
            return x
        m = x.shape[mem_pos]
        if m % p:
            raise ValueError(
                f"swap: mem axis size {m} not divisible by group size {p} "
                f"of {mesh_axis!r}")
        pg, members = mesh.group(mesh_axis)
        # the collective orders blocks by group rank; the swap orders
        # them by row-major position in the (tuple) axis group
        by_rank = dist.get_process_group_ranks(pg)
        pos = [members.index(r) for r in by_rank]
        blocks = x.movedim(mem_pos, 0).reshape((p, m // p) + _rest(x, mem_pos))
        send = blocks[pos].contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=pg)
        got = torch.empty_like(recv)
        got[pos] = recv
        # got[j] = member j's block for us, laid out (m/p, *rest): put
        # the mem axis back, then concatenate the members at shard_pos
        y = got.movedim(1, mem_pos + 1).movedim(0, shard_pos)
        shape = list(x.shape)
        shape[mem_pos] = m // p
        shape[shard_pos] *= p
        return y.reshape(shape).contiguous()


def _rest(x: torch.Tensor, skip: int) -> Tuple[int, ...]:
    return tuple(s for i, s in enumerate(x.shape) if i != skip)


_REGISTRY: Dict[str, Strategy] = {'all_to_all': AllToAllStrategy()}


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get(name: str) -> Strategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown comm strategy {name!r}; the port has {names()} "
            "(ppermute, hierarchical and pod_tree are ROADMAP queue 1, "
            "'Other strategies')") from None


def validate(name: str) -> str:
    if name == 'auto':
        return name
    return get(name).name


def resolve(name: str) -> Strategy:
    return get('all_to_all' if name == 'auto' else name)
