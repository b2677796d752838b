"""The port's operands and model parameters from the reference's numpy data.

The FFT system has no weights: its state is the planar operand and the
host-baked tables, which each module builds itself. What the two
packages must share is the operand, so tests and scripts make it once
with numpy from a seed and hand it to both sides through here
(:func:`from_numpy`).

The language models' parameters are nested dicts laid out as the
reference's parameter tree: layer-stacked along axis 0, linear weights
``(d_in, d_out)`` used as ``x @ w``. :func:`params_from_reference` and
:func:`params_to_reference` carry a tree across, leaf for leaf, in its
own dtype (bfloat16 as ``ml_dtypes.bfloat16`` on the reference's side).
:func:`opt_from_reference` and :func:`opt_to_reference` carry the
optimizer state ``{'step', 'master', 'm', 'v'}``; the port keeps its
``step`` on the host (``repro_torch.train.optim``).

On a ('data', 'model') mesh each rank holds its block of every leaf
(:func:`shard_params`): the reference's storage under the rules given
(serve: tensor-parallel over 'model'; train: also FSDP over 'data' on
the 'embed' dimension), except that a gated MLP's packed ``wi``
(d, 2 d_ff) is stored as this rank's [gate block ‖ up block], the
columns its tensor-parallel product needs (a contiguous slice would
give one rank all of the gate); under the train rules its first
dimension is cut over 'data' as any leaf's. :func:`unshard_params` is
the inverse (a collective; checks only). :func:`draw_params` draws a
rank's blocks alone, so no rank ever holds a whole tree at full size:
each leaf is a grid of cells seeded by (leaf, cell), the same on every
mesh, and its values differ from
:func:`repro_torch.models.model.init_params`'s. :func:`param_cuts`
names each leaf's cut for the sharded checkpoint.
"""
from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch


def host_operand(x):
    """numpy operand -> the port's types on the host: complex64 for a
    complex array, float32 for a real one, a pair of float32 for a
    planar ``(re, im)``; each C-contiguous. An array that already is one
    is returned itself, not copied."""
    if isinstance(x, (tuple, list)):
        return tuple(np.asarray(a).astype(np.float32, order='C', copy=False) for a in x)
    a = np.asarray(x)
    return a.astype(np.complex64 if np.iscomplexobj(a) else np.float32, order='C',
                    copy=False)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A :func:`host_operand` array on ``device``. Off the CPU the
    transfer is its only copy (a 128 MiB request copied on the host
    first costs about 60 ms); on the CPU the tensor is a copy, so it
    never aliases the caller's array."""
    if torch.device(device).type == 'cpu':
        return torch.tensor(a)
    with warnings.catch_warnings():
        # a received request is a read-only view; the tensor only feeds the transfer
        warnings.filterwarnings('ignore', message='The given NumPy array is not writable')
        return torch.from_numpy(a).to(device)


def from_numpy(x, device='cuda'):
    """numpy operand -> the port's tensors on ``device``, in the types
    of :func:`host_operand`: one complex64 or float32 tensor, or a pair
    of float32 tensors for a planar ``(re, im)``. No copy is made on the
    host where the operand already has its type."""
    a = host_operand(x)
    if isinstance(a, tuple):
        return tuple(_tensor(p, device) for p in a)
    return _tensor(a, device)


def params_from_reference(tree, device='cuda', rules=None, mesh=None, cfg=None):
    """The reference's parameter (or cache) tree, numpy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's tensors on
    ``device``; with ``rules`` (and ``mesh``, ``cfg``) this rank's blocks
    of a parameter tree (:func:`shard_params`)."""
    if rules is not None:
        if cfg is None:
            raise ValueError('sharding a parameter tree needs its cfg (the leaves\' axes)')
        return shard_params(params_from_reference(tree, device), cfg, rules, mesh)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == 'bfloat16':          # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)          # a copy: the port updates in place


def _gated_wi(node: dict, wi_shape) -> bool:
    """Whether a 'wi' of ``wi_shape`` beside ``node['wo']`` (a tensor or a
    plan leaf) packs [gate ‖ up]."""
    wo = node.get('wo')
    return hasattr(wo, 'shape') and wi_shape[-1] == 2 * wo.shape[-2]


def _gated_cut(name: str, node: dict, shape, spec) -> bool:
    """Whether a leaf is a gated ``wi`` whose packed last dimension the
    spec cuts: stored as [gate block ‖ up block]."""
    return (name == 'wi' and _gated_wi(node, shape) and len(spec) == len(shape)
            and spec[-1] is not None)


def _wi_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A gated ``wi``'s block: the other dimensions as the spec cuts them,
    the last as [gate block r ‖ up block r] of the group's p blocks."""
    from repro_torch import comm
    from repro_torch.parallel.sharding import local_block
    t = local_block(t, spec[:-1], mesh)
    p, r = comm.group_size(mesh, spec[-1]), comm.group_index(mesh, spec[-1])
    f = t.shape[-1] // 2
    if f % p:
        raise ValueError(f'a gated MLP of d_ff {f} does not split over {p} ranks')
    n = f // p
    return torch.cat([t[..., r * n:(r + 1) * n], t[..., f + r * n:f + (r + 1) * n]], -1)


def shard_params(global_tree, cfg, rules, mesh):
    """This rank's block of every leaf of the port's whole parameter tree
    (``spec_for`` of the leaf's shape and ``param_axes``), a gated MLP's
    ``wi`` re-cut as [gate block ‖ up block]."""
    from repro_torch.models import model as M
    return _shard(global_tree, M.param_axes(cfg), rules, mesh)


def _shard(node, axes, rules, mesh):
    """:func:`shard_params` of a subtree, given its axes."""
    from repro_torch.parallel.sharding import local_block, spec_for
    out = {}
    for k in sorted(node):
        t, a = node[k], axes[k]
        if isinstance(t, dict):
            out[k] = _shard(t, a, rules, mesh)
            continue
        spec = spec_for(rules, t.shape, a)
        if _gated_cut(k, node, t.shape, spec):
            out[k] = _wi_block(t, spec, mesh)
        else:
            out[k] = local_block(t, spec, mesh)
    return out


#: the logical axes some rule cuts: a leaf is drawn in cells along them
_CUT_AXES = frozenset(('embed', 'heads', 'kv_heads', 'mlp', 'vocab', 'expert'))
#: the most cells a dimension is drawn in
DRAW_CELLS = 4


def _cells(dim: int, group: int) -> int:
    """Cells along a dimension of ``dim`` (a gated ``wi``'s last: of each
    half): the most of ``DRAW_CELLS``, 2, 1 that divides it, or the
    group's size where the group cutting it does not divide that count."""
    n = next(c for c in (DRAW_CELLS, 2, 1) if dim % c == 0)
    return n if n % group == 0 else group


def draw_params(seed: int, cfg, dtype, rules, mesh):
    """This rank's blocks of a random parameter tree, drawn on
    ``mesh.device`` without the whole tree, with each whole leaf's
    distribution (the 'lin' fan-in its whole input width).

    Leaf i is a grid of cells: up to ``DRAW_CELLS`` along each dimension
    some rule may cut ('embed' and the axes of 'model'; a gated ``wi``'s
    last dimension as gate cells, then up cells), one along the others;
    cell c is drawn from a generator seeded by (``seed``, i, c). A rank
    draws the cells of its block, so every mesh whose groups have 1, 2
    or 4 ranks, under either rules, holds the same whole tree (a group of
    another size draws a cell a rank). Replicated leaves are the same on
    every rank."""
    from repro_torch import comm
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import spec_for
    order = iter(range(1 << 30))           # leaf i: tree_map's sorted-key order

    def draw(p, gated: bool):
        i = next(order)
        spec = spec_for(rules, p.shape, p.axes)
        spec = tuple(spec) + (None,) * (len(p.shape) - len(spec))
        size = [1 if ma is None else comm.group_size(mesh, ma) for ma in spec]
        index = [0 if ma is None else comm.group_index(mesh, ma) for ma in spec]
        local = tuple(n // g for n, g in zip(p.shape, size))
        if p.init in ('zeros', 'ones', 'neg1'):
            fill = {'zeros': 0, 'ones': 1, 'neg1': -1}[p.init]
            return torch.full(local, fill, dtype=p.dtype or dtype, device=mesh.device)
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        last = len(p.shape) - 1
        grid, mine = [], []
        for d, (n, g, r, ax) in enumerate(zip(p.shape, size, index, p.axes)):
            half = gated and d == last
            c = _cells(n // 2 if half else n, g) if ax in _CUT_AXES else 1
            k = c // g
            grid.append(2 * c if half else c)
            mine.append(list(range(r * k, (r + 1) * k))
                        + (list(range(c + r * k, c + (r + 1) * k)) if half else []))
        cell = tuple(n // c for n, c in zip(p.shape, grid))
        out = torch.empty(local, dtype=p.dtype or dtype, device=mesh.device)
        gen = torch.Generator(device=mesh.device)
        for pos in itertools.product(*(range(len(m)) for m in mine)):
            flat = 0
            for c, m, j in zip(grid, mine, pos):
                flat = flat * c + m[j]
            gen.manual_seed((seed * 1_000_003 + i) * 65_537 + flat)
            where = tuple(slice(j * w, (j + 1) * w) for j, w in zip(pos, cell))
            out[where] = L._init_leaf(gen, dataclasses.replace(p, shape=cell), dtype,
                                      fan_in=fan_in)
        return out

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else draw(v, _gated_wi(node, v.shape)
                                                            and k == 'wi')
                for k, v in sorted(node.items())}
    return walk(M.model_plan(cfg))


def unshard_params(local_tree, cfg, rules, mesh):
    """The whole parameter tree on every rank from its blocks under
    ``rules`` (the inverse of :func:`shard_params`, a gated ``wi``'s
    [gate ‖ up] blocks put back in place; a collective, for checks)."""
    from repro_torch.models import model as M
    return _unshard(local_tree, M.model_plan(cfg), rules, mesh)


def _unshard(node, plan, rules, mesh):
    from repro_torch import comm
    from repro_torch.parallel.sharding import gather_block, spec_for
    out = {}
    for k in sorted(node):
        t, p = node[k], plan[k]
        if isinstance(t, dict):
            out[k] = _unshard(t, p, rules, mesh)
            continue
        spec = spec_for(rules, p.shape, p.axes)
        with torch.no_grad():
            whole = gather_block(t, spec, mesh)
        if _gated_cut(k, plan, p.shape, spec):
            g, f = comm.group_size(mesh, spec[-1]), p.shape[-1] // 2
            blocks = whole.reshape(*whole.shape[:-1], g, 2, f // g)
            whole = blocks.transpose(-3, -2).reshape(whole.shape)
        out[k] = whole
    return out


class Cut(NamedTuple):
    """How a leaf is stored on a mesh: its whole shape, its spec, and
    whether it is a gated ``wi`` stored as [gate block ‖ up block]."""
    shape: Tuple[int, ...]
    spec: tuple
    gated: bool


def param_cuts(cfg, rules):
    """Each parameter leaf's :class:`Cut` under ``rules``."""
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import spec_for

    def walk(node):
        out = {}
        for k, p in sorted(node.items()):
            if isinstance(p, dict):
                out[k] = walk(p)
            else:
                spec = spec_for(rules, p.shape, p.axes)
                out[k] = Cut(tuple(p.shape), spec, _gated_cut(k, node, p.shape, spec))
        return out
    return walk(M.model_plan(cfg))


def opt_cuts(cfg, rules):
    """The optimizer state's cuts: master, m and v as the parameters,
    ``step`` whole."""
    pc = param_cuts(cfg, rules)
    return {'step': Cut((), (), False), 'master': pc, 'm': pc, 'v': pc}


def block_of(whole: torch.Tensor, cut: Cut, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf under its cut."""
    from repro_torch.parallel.sharding import local_block
    if cut.gated:
        return _wi_block(whole, cut.spec, mesh)
    return local_block(whole, cut.spec, mesh)


def params_to_reference(params, rules=None, mesh=None, cfg=None):
    """The port's parameter (or cache) tree as numpy leaves, the layout
    the reference's functions take (``jax.tree.map(jnp.asarray, ...)``);
    with ``rules`` (and ``mesh``, ``cfg``) the whole tree from this
    rank's blocks of a parameter tree (:func:`unshard_params`). A
    bfloat16 leaf needs ``ml_dtypes`` (which JAX brings)."""
    if rules is not None:
        if cfg is None:
            raise ValueError("gathering a parameter tree needs its cfg (the leaves' axes)")
        return params_to_reference(unshard_params(params, cfg, rules, mesh))
    if isinstance(params, dict):
        return {k: params_to_reference(v) for k, v in params.items()}
    t = params.detach().to('cpu', copy=True)       # a copy: the port updates in place
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def opt_from_reference(opt, device='cuda', rules=None, mesh=None, cfg=None):
    """The reference's AdamW state (numpy leaves) as the port's: master,
    m and v on ``device`` (with ``rules``: this rank's blocks, as
    :func:`params_from_reference`'s), step a host int32 tensor."""
    out = {k: params_from_reference(opt[k], device, rules, mesh, cfg)
           for k in ('master', 'm', 'v')}
    out['step'] = torch.tensor(int(np.asarray(opt['step'])), dtype=torch.int32)
    return out


def opt_to_reference(opt, rules=None, mesh=None, cfg=None):
    """The port's AdamW state as the reference's numpy leaves (with
    ``rules``: whole, from this rank's blocks, a collective)."""
    out = {k: params_to_reference(opt[k], rules, mesh, cfg) for k in ('master', 'm', 'v')}
    out['step'] = params_to_reference(opt['step'])
    return out
