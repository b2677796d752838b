"""``repro_torch.comm`` — the ownership swap over ``torch.distributed``
(:mod:`.strategies`), the cost model and ``comm='auto'`` selector
(:mod:`.cost`), and compute/communication overlap (:mod:`.overlap`).

Port of ``repro.comm``. The module-level helpers below run on this
rank's local blocks, as the reference's run inside ``shard_map``; where
the reference reads the mesh from the ``shard_map`` context, they take
it as an argument. ``all_gather`` and ``all_reduce`` are the language
models' tensor-parallel collectives.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.comm import cost, overlap, strategies
from repro_torch.comm.strategies import (  # noqa: F401  (re-exported API)
    Strategy,
    all_gather,
    all_reduce,
    axis_tuple,
    get,
    group_index,
    group_size,
    names,
    register,
    resolve,
    validate,
)
from repro_torch.core import plan as planlib
from repro_torch.core.plan import Layout, MeshAxis

DEFAULT_STRATEGY = 'all_to_all'


def swap_axes(x: torch.Tensor, mesh, mesh_axis: MeshAxis, *, shard_pos: int, mem_pos: int,
              strategy: str = DEFAULT_STRATEGY) -> torch.Tensor:
    """In-place ownership swap: after this, local axis ``shard_pos``
    holds the full global axis previously sharded over ``mesh_axis``
    and local axis ``mem_pos`` holds only this rank's block of the
    previously full axis. ``strategy`` picks how the bytes move; every
    registered strategy gives the same bits."""
    return get(strategy).swap_axes(x, mesh, mesh_axis, shard_pos=shard_pos, mem_pos=mem_pos)


def apply_swap(x: torch.Tensor, layout: Layout, mesh, mesh_axis: MeshAxis, mem_pos: int, *,
               strategy: str = DEFAULT_STRATEGY) -> Tuple[torch.Tensor, Layout]:
    """swap + layout bookkeeping."""
    return get(strategy).swap(x, layout, mesh, mesh_axis, mem_pos)


def redistribute(x: torch.Tensor, src: Layout, dst: Layout, mesh, *,
                 strategy: str = DEFAULT_STRATEGY) -> torch.Tensor:
    """General layout change through the fewest swaps
    (``core.plan.plan_swaps``)."""
    st = get(strategy)
    for mesh_axis, mem_pos in planlib.plan_swaps(src, dst):
        x, src = st.swap(x, src, mesh, mesh_axis, mem_pos)
    if src != dst:
        raise AssertionError(f"redistribute ended at {src}, not {dst}")
    return x


def pod_fold(x: torch.Tensor, mesh, pod_axis: str, batch_pos: int = 0) -> torch.Tensor:
    """Gather a batch axis sharded over the pod axis (an FFT batch that
    spans pods while each instance stays within one pod)."""
    return all_gather(x, mesh, pod_axis, batch_pos)


__all__ = [
    'DEFAULT_STRATEGY', 'Strategy', 'all_gather', 'all_reduce', 'apply_swap', 'axis_tuple',
    'cost', 'get', 'group_index', 'group_size', 'names', 'overlap', 'pod_fold',
    'redistribute', 'register', 'resolve', 'strategies', 'swap_axes', 'validate',
]
