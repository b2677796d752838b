"""Logical-axis sharding rules over the port's meshes: DP / FSDP / TP /
EP / SP, and each rank's block of a tree.

Port of ``repro.parallel.sharding``. Every parameter and cache leaf is
annotated with a tuple of *logical* axis names ('embed', 'heads',
'expert', ...). A :class:`Rules` table maps each name to a mesh axis (or
None = replicate), and :func:`spec_for` applies it with the reference's
guards: a logical axis whose size the mesh extent does not divide, or
whose mesh axes an earlier dimension already took, is replicated. A
spec is the tuple of the reference's ``PartitionSpec`` entries.

JAX places a global array by its ``NamedSharding``; here every rank is
one process holding its own block as a plain tensor. :func:`shard_tree`
cuts a rank's blocks out of a whole tree and :func:`gather_tree` joins
them back (checks only: at full size no rank holds a whole tree).
:class:`Parallel` is what the model code asks while it runs on local
blocks: the tensor-parallel extent and the collectives over the mesh's
groups. ``constrain`` (``with_sharding_constraint``) has no counterpart:
the port places every activation explicitly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch import comm
from repro_torch.comm.strategies import axis_tuple

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis -> mesh axes mapping, bound to a mesh (anything with
    a name -> extent ``shape``)."""
    table: Dict[str, MeshAxes]
    mesh: object

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.table.get(logical)

    def axis_size(self, mesh_axes: MeshAxes) -> int:
        return math.prod(self.mesh.shape[a] for a in axis_tuple(mesh_axes))


def make_rules(mesh, *, mode: str = 'train', fsdp: bool = True) -> Rules:
    """The reference's rule table for ``mesh``.

    train: batch over ('pod', 'data'); parameters FSDP over ('pod',
    'data') on 'embed' and TP over 'model' on heads / mlp / vocab /
    expert. serve: parameters TP over 'model' only (replicated over
    'data', so every data row serves its own requests); batch over
    ('pod', 'data'). 'seq_sp' (Ulysses) maps to 'model' in both modes;
    'kv_seq' to 'model' when serving."""
    has_pod = 'pod' in mesh.shape
    batch: MeshAxes = ('pod', 'data') if has_pod else 'data'
    fsdp_axes: MeshAxes = (batch if (fsdp and mode == 'train') else None)
    table: Dict[str, MeshAxes] = {
        'batch': batch,
        'embed': fsdp_axes,
        'heads': 'model',
        'kv_heads': 'model',
        'mlp': 'model',
        'vocab': 'model',
        'expert': 'model',
        'seq': None,
        'seq_sp': 'model',
        'kv_seq': 'model' if mode == 'serve' else None,
        'state': None,
        'kv_lora': None,
        'pos': None,
    }
    return Rules(table=table, mesh=mesh)


def spec_for(rules: Rules, shape: Sequence[int], axes: Sequence[Optional[str]]) -> Spec:
    """The spec of an array of ``shape`` with logical ``axes``: each
    dimension's mesh axes, None where the extent does not divide the
    dimension or its mesh axes are taken; trailing Nones dropped."""
    if len(shape) != len(axes):
        raise ValueError(f'shape {tuple(shape)} and axes {tuple(axes)} differ in rank')
    parts = []
    used: set = set()
    for dim, name in zip(shape, axes):
        ma = rules.mesh_axes(name)
        flat = set(axis_tuple(ma))
        if ma is None or dim % rules.axis_size(ma) != 0 or used & flat:
            parts.append(None)
        else:
            parts.append(ma)
            used |= flat
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def named_sharding(rules: Rules, shape: Sequence[int], axes: Sequence[Optional[str]]):
    """``(mesh, spec)``: the counterpart of the reference's ``NamedSharding``."""
    return rules.mesh, spec_for(rules, shape, axes)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_specs(rules: Rules, shapes_tree, axes_tree):
    """Twin (shape, axes) trees -> a tree of ``named_sharding``s. A shapes
    leaf is anything with ``.shape`` (a ``meta`` tensor) or a shape."""
    return _tree_map(lambda s, a: named_sharding(rules, getattr(s, 'shape', s), a),
                     shapes_tree, axes_tree)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's block shape under ``spec``."""
    out = list(shape)
    for d, ma in enumerate(spec):
        out[d] //= math.prod(mesh.shape[a] for a in axis_tuple(ma))
    return tuple(out)


def shard_index(spec: Spec, mesh) -> int:
    """This rank's block number under ``spec``: its row-major index over
    the sharded dimensions' group indices (0 where nothing is sharded)."""
    idx = 0
    for ma in spec:
        if ma is not None:
            idx = idx * comm.group_size(mesh, ma) + comm.group_index(mesh, ma)
    return idx


def local_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole ``t`` under ``spec`` (a copy where
    anything is cut)."""
    for d, ma in enumerate(spec):
        p = 1 if ma is None else comm.group_size(mesh, ma)
        if p > 1:
            n = t.shape[d] // p
            t = t.narrow(d, comm.group_index(mesh, ma) * n, n).contiguous()
    return t


def gather_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (the
    inverse of :func:`local_block`; a collective over each sharded
    dimension's group)."""
    for d, ma in enumerate(spec):
        if ma is not None:
            t = comm.all_gather(t, mesh, ma, d)
    return t


def shard_tree(global_tree, axes_tree, rules: Rules, mesh):
    """This rank's block of every leaf of a whole tree: the reference's
    storage, ``spec_for`` of each leaf's shape and axes."""
    return _tree_map(lambda t, a: local_block(t, spec_for(rules, t.shape, a), mesh),
                     global_tree, axes_tree)


def gather_tree(local_tree, shapes_tree, axes_tree, rules: Rules, mesh):
    """The inverse of :func:`shard_tree` (for checks): each leaf whole on
    every rank, its spec from the global ``shapes_tree``."""
    return _tree_map(lambda t, s, a: gather_block(t, spec_for(rules, getattr(s, 'shape', s),
                                                               a), mesh),
                     local_tree, shapes_tree, axes_tree)


class Parallel:
    """What the model code asks while it runs on this rank's blocks of a
    ('data', 'model') mesh, ``rules.mesh``, whose 'model' group has
    several ranks: the tensor-parallel extent ``tp`` and this rank's
    index ``tp_index`` on 'model', the specs of leaves, and the
    collectives over the groups. :meth:`of` gives None where 'model' has
    one rank: the model code then runs its one-rank path."""

    def __init__(self, rules: Rules):
        self.rules, self.mesh = rules, rules.mesh
        self.tp = self.mesh.shape['model']
        self.tp_index = comm.group_index(self.mesh, 'model')

    @classmethod
    def of(cls, rules: Optional[Rules]) -> Optional['Parallel']:
        """The model code's view of a run under ``rules`` (None: no rules,
        or a 'model' group of one rank)."""
        if rules is None or rules.mesh.shape.get('model', 1) == 1:
            return None
        return cls(rules)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the 'model' group (``all_reduce``)."""
        return comm.all_reduce(x, self.mesh, 'model')

    def spec(self, shape: Sequence[int], axes: Sequence[Optional[str]]) -> Spec:
        return spec_for(self.rules, shape, axes)

    def whole(self, t: torch.Tensor, shape: Sequence[int],
              axes: Sequence[Optional[str]]) -> torch.Tensor:
        """A leaf gathered at use: whole from this rank's block ``t`` of a
        leaf of global ``shape``."""
        return gather_block(t, self.spec(shape, axes), self.mesh)

    def gather(self, x: torch.Tensor, dim: int, mesh_axis: MeshAxes = 'model') -> torch.Tensor:
        return comm.all_gather(x, self.mesh, mesh_axis, dim)

    def block(self, t: torch.Tensor, dim: int, mesh_axis: MeshAxes = 'model') -> torch.Tensor:
        """This rank's contiguous block of ``t`` along ``dim`` over
        ``mesh_axis`` (a view)."""
        p = comm.group_size(self.mesh, mesh_axis)
        if p == 1:
            return t
        n = t.shape[dim] // p
        return t.narrow(dim, comm.group_index(self.mesh, mesh_axis) * n, n)
