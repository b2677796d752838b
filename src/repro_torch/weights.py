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
(:func:`shard_params`): the reference's storage under the serve rules,
except that a gated MLP's packed ``wi`` (d, 2 d_ff) is stored as this
rank's [gate block ‖ up block], the columns its tensor-parallel product
needs (a contiguous slice would give one rank all of the gate).
:func:`draw_params` draws a rank's blocks alone, each seeded by (leaf,
block index), so no rank ever holds a whole tree at full size; its
values differ from :func:`repro_torch.models.model.init_params`'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def from_numpy(x, device='cuda'):
    """numpy operand -> the port's tensors on ``device``.

    A complex array becomes one complex64 tensor; a planar ``(re, im)``
    pair becomes a pair of float32 tensors; a real array becomes one
    float32 tensor."""
    if isinstance(x, (tuple, list)):
        re, im = x
        return (torch.as_tensor(np.asarray(re, dtype=np.float32), device=device),
                torch.as_tensor(np.asarray(im, dtype=np.float32), device=device))
    a = np.asarray(x)
    dtype = np.complex64 if np.iscomplexobj(a) else np.float32
    return torch.as_tensor(a.astype(dtype), device=device)


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
    wo = node.get('wo')
    return isinstance(wo, torch.Tensor) and wi_shape[-1] == 2 * wo.shape[-2]


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
        if (k == 'wi' and _gated_wi(node, t.shape) and len(spec) == t.dim()
                and spec[-1] is not None):
            out[k] = _wi_block(t, spec, mesh)
        else:
            out[k] = local_block(t, spec, mesh)
    return out


def draw_params(seed: int, cfg, dtype, rules, mesh):
    """This rank's blocks of a random parameter tree, drawn on
    ``mesh.device`` without the whole tree: leaf i's block b from a
    generator seeded by (``seed``, i, b), with the whole leaf's
    distribution (the 'lin' fan-in its whole input width). Replicated
    leaves are the same on every rank."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import local_shape, shard_index, spec_for
    order = iter(range(1 << 30))           # leaf i: tree_map's sorted-key order

    def draw(p):
        spec = spec_for(rules, p.shape, p.axes)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed((seed * 1_000_003 + next(order)) * 65_537 + shard_index(spec, mesh))
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        local = dataclasses.replace(p, shape=local_shape(p.shape, spec, mesh))
        return L._init_leaf(gen, local, dtype, fan_in=fan_in)
    return L.tree_map(draw, M.model_plan(cfg))


def params_to_reference(params):
    """The port's parameter (or cache) tree as numpy leaves, the layout
    the reference's functions take (``jax.tree.map(jnp.asarray, ...)``).
    A bfloat16 leaf needs ``ml_dtypes`` (which JAX brings)."""
    if isinstance(params, dict):
        return {k: params_to_reference(v) for k, v in params.items()}
    t = params.detach().to('cpu', copy=True)       # a copy: the port updates in place
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def opt_from_reference(opt, device='cuda'):
    """The reference's AdamW state (numpy leaves) as the port's: master,
    m and v on ``device``, step a host int32 tensor."""
    out = {k: params_from_reference(opt[k], device) for k in ('master', 'm', 'v')}
    out['step'] = torch.tensor(int(np.asarray(opt['step'])), dtype=torch.int32)
    return out


def opt_to_reference(opt):
    """The port's AdamW state as the reference's numpy leaves."""
    return {k: params_to_reference(v) for k, v in opt.items()}
