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
groups; :class:`DataParallel` is the training run's batch group.
``constrain`` (``with_sharding_constraint``) has no counterpart: the
port places every activation explicitly.

Training (the train rules, ``mode='train'``) stores every leaf's
'embed' dimension cut over 'data' (FSDP) on top of the serve rules'
tensor-parallel cut over 'model'. :func:`gather_fsdp` gathers one
layer's leaves over 'data' into their serve-rule blocks when the layer
runs (``Rules.at_use``); the model code then runs as the sharded
server does. Where XLA derives each collective's transpose, the port
picks each backward by how the ranks use the collective's result:

* a result every rank of the group uses alike (the same computation on
  the same data) has a complete cotangent on each rank: a gather's
  backward takes this rank's slice (the SSD's, RG-LRU's and FFT-conv
  mixer's leaves gathered over 'model'; the logits over the vocabulary),
  and a sum's (the row-parallel product, the vocab-parallel embedding)
  passes the cotangent through;
* a result the ranks use apart has a partial cotangent on each rank: a
  gather's backward is a reduce-scatter (every FSDP gather over 'data',
  where each rank runs its batch block; MQA's ``wk``/``wv`` and the
  Ulysses path's weights over 'model', where each rank uses its heads or
  its sequence block), and a value every rank holds alike that enters
  a split computation goes through ``enter`` (the identity, its
  cotangent summed over 'model') before every column-parallel product,
  the vocab-parallel head, MLA's up-projections, and the expert-parallel
  dispatch's sequence block. Without ``enter`` every gradient upstream
  of the split would be one rank's part, silently.

A leaf that 'data' does not cut gets a gradient from each rank's batch
block: :func:`reduce_data_parallel` sums them over 'data' (each rank's
loss is its share of the global token mean, ``model.loss_fn``). The
clip norm (:func:`global_norm`) adds every distinct block's squares once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

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
    mode: str = 'train'

    @property
    def fsdp_axes(self) -> MeshAxes:
        """The mesh axes that cut every leaf's 'embed' dimension (FSDP;
        None under the serve rules)."""
        return self.table.get('embed')

    def at_use(self) -> 'Rules':
        """The rules of a leaf's block after its FSDP gather: 'embed'
        whole, every other axis as here (the serve rules' parameter
        specs)."""
        if self.fsdp_axes is None:
            return self
        return dataclasses.replace(self, table={**self.table, 'embed': None})

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
    return Rules(table=table, mesh=mesh, mode=mode)


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


def gather_block(t: torch.Tensor, spec: Spec, mesh, *, alike: bool = True) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (the
    inverse of :func:`local_block`; a collective over each sharded
    dimension's group, differentiable as ``comm.all_gather(alike=)``)."""
    for d, ma in enumerate(spec):
        if ma is not None:
            t = comm.all_gather(t, mesh, ma, d, alike=alike)
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
    index ``tp_index`` on 'model', the specs of leaves as the model code
    holds them (``rules.at_use()``: under the train rules a layer's
    leaves arrive gathered over 'data'), and the collectives over the
    groups. :meth:`of` gives None where 'model' has one rank: the model
    code then runs its one-rank path."""

    def __init__(self, rules: Rules):
        self.rules, self.mesh = rules.at_use(), rules.mesh
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

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over the 'model' group, in place
        (no gradient)."""
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.mesh.group('model')[0])
        return x

    def spec(self, shape: Sequence[int], axes: Sequence[Optional[str]]) -> Spec:
        return spec_for(self.rules, shape, axes)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, held alike on every 'model' rank, entering a computation
        the ranks split: its cotangent summed over 'model' in the
        backward (``comm.enter``)."""
        return comm.enter(x, self.mesh, 'model')

    def whole(self, t: torch.Tensor, shape: Sequence[int],
              axes: Sequence[Optional[str]], *, alike: bool = True) -> torch.Tensor:
        """A leaf gathered at use: whole from this rank's block ``t`` of a
        leaf of global ``shape``. ``alike``: every rank computes with it
        alike (the backward takes this rank's slice), else each rank uses
        it apart, with its heads or sequence block (the backward is a
        reduce-scatter)."""
        return gather_block(t, self.spec(shape, axes), self.mesh, alike=alike)

    def gather(self, x: torch.Tensor, dim: int, mesh_axis: MeshAxes = 'model', *,
               alike: bool = True) -> torch.Tensor:
        return comm.all_gather(x, self.mesh, mesh_axis, dim, alike=alike)

    def block(self, t: torch.Tensor, dim: int, mesh_axis: MeshAxes = 'model') -> torch.Tensor:
        """This rank's contiguous block of ``t`` along ``dim`` over
        ``mesh_axis`` (a view)."""
        p = comm.group_size(self.mesh, mesh_axis)
        if p == 1:
            return t
        n = t.shape[dim] // p
        return t.narrow(dim, comm.group_index(self.mesh, mesh_axis) * n, n)


class DataParallel:
    """A training run's batch group: the train rules' 'batch' mesh axes
    ('data', or ('pod', 'data')) when they hold several ranks, each with
    its own batch block. :meth:`of` gives None otherwise (and under the
    serve rules, whose data rows serve requests apart)."""

    def __init__(self, rules: Rules):
        self.mesh = rules.mesh
        self.axes = rules.table['batch']
        self.size = comm.group_size(self.mesh, self.axes)

    @classmethod
    def of(cls, rules: Optional[Rules]) -> Optional['DataParallel']:
        if (rules is None or rules.mode != 'train'
                or math.prod(rules.mesh.shape[a] for a in axis_tuple(rules.table['batch'])) == 1):
            return None
        return cls(rules)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the batch group; its cotangent passes
        through (each rank differentiates its own share)."""
        return comm.all_reduce(x, self.mesh, self.axes)


def gather_fsdp(tree, plan, rules: Rules):
    """Every leaf of ``tree`` (this rank's blocks under the train rules;
    ``plan`` the twin tree of whole leaves, anything with ``.shape`` and
    ``.axes``) gathered over the FSDP axes into its block under
    ``rules.at_use()``. The ranks of 'data' run their own batch blocks,
    so each gather's backward is a reduce-scatter. ``tree`` itself where
    the rules have no FSDP axes or their group has one rank."""
    fs = rules.fsdp_axes
    if fs is None or math.prod(rules.mesh.shape[a] for a in axis_tuple(fs)) == 1:
        return tree

    def one(t, p):
        for d, ma in enumerate(spec_for(rules, p.shape, p.axes)):
            if ma == fs:
                t = comm.all_gather(t, rules.mesh, fs, d, alike=False)
        return t
    return _tree_map(one, tree, plan)


def _shares_axes(spec: Spec, mesh_axes: MeshAxes) -> bool:
    return bool(set(axis_tuple(mesh_axes)) & {a for ma in spec for a in axis_tuple(ma)})


@torch.no_grad()
def reduce_data_parallel(grads, plan, rules: Rules):
    """IN PLACE: every gradient of a leaf that the batch group does not
    cut (``spec_for`` under ``rules``, ``plan`` the whole leaves) summed
    over the batch group; the others arrive reduce-scattered by their
    FSDP gathers' backward. Returns ``grads``."""
    dp = DataParallel.of(rules)
    if dp is None:
        return grads
    for g, p in zip(_leaves(grads), _leaves(plan)):
        if not _shares_axes(spec_for(rules, p.shape, p.axes), dp.axes):
            r = comm.all_reduce(g, dp.mesh, dp.axes)
            if r is not g:
                g.copy_(r)
    return grads


@torch.no_grad()
def global_norm(grads, plan, rules: Rules) -> torch.Tensor:
    """sqrt(sum of squares + 1e-12) in fp32 of the whole gradient tree
    from this rank's blocks: each leaf's squares scaled by the share of
    the mesh that holds the same block (1 / its replicas, a power of two
    on the port's meshes) and summed over every rank, so each distinct
    block counts once."""
    mesh = rules.mesh
    total = None
    for g, p in zip(_leaves(grads), _leaves(plan)):
        spec = spec_for(rules, p.shape, p.axes)
        blocks = math.prod(rules.axis_size(ma) for ma in spec if ma is not None)
        s = torch.sum(torch.square(g.float())) * (blocks / mesh.size)
        total = s if total is None else total + s
    total = comm.all_reduce(total, mesh, tuple(mesh.shape))
    return torch.sqrt(total + 1e-12)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]
