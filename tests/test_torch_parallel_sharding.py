"""The port's sharding rules (``repro_torch.parallel``) against the JAX
package's (``repro.parallel.sharding``), in pure Python: no ranks.

For every leaf of ``param_axes`` and ``cache_axes`` of all ten configs at
their published sizes, on ('data', 'model') meshes of 1 x 1, 2 x 2,
1 x 4 and 2 x 4, the production meshes (16 x 16, 2 x 16 x 16 with 'pod')
and in both modes, ``spec_for`` gives the reference's ``PartitionSpec``
entries (the divisibility and collision guards included). The port's
own ``cache_axes`` is the reference's layout with 'kv_seq' and 'heads'
unsharded (a deliberate difference: caches by heads, gathered-at-use
mixers' states whole). ``shard_tree`` cuts every rank's block so that
the blocks tile the whole leaf, and ``gather_tree`` on one rank is the
identity; ``input_specs`` matches the reference's.
"""
import itertools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import input_specs as ref_input_specs
from repro.configs import list_archs
from repro.models import model as RM
from repro.parallel import sharding as RS
from repro_torch.configs import SHAPES, get_config, input_specs, smoke_config
from repro_torch.launch.mesh import FFTMesh, make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.parallel import gather_tree, make_rules, named_sharding, shard_tree, spec_for
from repro_torch.parallel import tree_specs
from repro_torch.weights import draw_params, shard_params

MESHES = {'1x1': {'data': 1, 'model': 1}, '2x2': {'data': 2, 'model': 2},
          '1x4': {'data': 1, 'model': 4}, '2x4': {'data': 2, 'model': 4},
          '16x16': {'data': 16, 'model': 16},
          '2x16x16': {'pod': 2, 'data': 16, 'model': 16}}
ARCHS = list_archs()
B, CAP = 8, 2112


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _ref_leaves(shapes, axes):
    """{path: (shape, axes)} of the reference's twin trees."""
    flat_axes = {tuple(k.key for k in path): a for path, a in
                 jax.tree_util.tree_flatten_with_path(axes, is_leaf=_is_axes)[0]}
    flat_shapes = {tuple(k.key for k in path): s.shape for path, s in
                   jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert flat_axes.keys() == flat_shapes.keys()
    return {k: (flat_shapes[k], flat_axes[k]) for k in flat_axes}


@pytest.mark.parametrize('mode', ['serve', 'train'])
@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('arch', ARCHS)
def test_spec_for_matches_the_reference_on_every_leaf(arch, mesh, mode):
    cfg, rcfg = get_config(arch), ref_config(arch)
    rules = make_rules(_mesh(MESHES[mesh]), mode=mode)
    rrules = RS.make_rules(_mesh(MESHES[mesh]), mode=mode)
    assert rules.table == rrules.table
    trees = [(RM.abstract_params(rcfg), RM.param_axes(rcfg))]
    if cfg.causal:
        trees.append((RM.abstract_cache(rcfg, B, CAP), RM.cache_axes(rcfg, B, CAP)))
    n = 0
    for shapes, axes in trees:
        for path, (shape, ax) in _ref_leaves(shapes, axes).items():
            assert spec_for(rules, shape, ax) == tuple(RS.spec_for(rrules, shape, ax)), path
            n += 1
    # the port's own parameter tree: the reference's shapes and axes
    port = _flat(M.abstract_params(cfg))
    port_axes = _flat(M.param_axes(cfg))
    ref = _ref_leaves(*trees[0])
    assert {k: (tuple(v.shape), port_axes[k]) for k, v in port.items()} == \
        {k: (tuple(s), a) for k, (s, a) in ref.items()}
    assert n > 0


@pytest.mark.parametrize('arch', [a for a in ARCHS if ref_config(a).causal])
def test_cache_axes_are_the_heads_layout(arch):
    """The port's caches: the reference's axes with 'kv_seq' and 'heads'
    unsharded; on 1 x 4 an attention cache's spec never cuts the
    sequence, and cuts the kv heads where 4 divides them."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    got = _flat(M.cache_axes(cfg, B, CAP))
    ref = {k: a for k, (_, a) in _ref_leaves(RM.abstract_cache(rcfg, B, CAP),
                                              RM.cache_axes(rcfg, B, CAP)).items()}
    assert got == {k: tuple(None if a in ('kv_seq', 'heads') else a for a in v)
                   for k, v in ref.items()}
    rules = make_rules(_mesh(MESHES['1x4']), mode='serve')
    shapes = _flat(tree_map(lambda t: tuple(t.shape), M.abstract_cache(cfg, B, CAP)))
    for k, shape in shapes.items():
        spec = spec_for(rules, shape, got[k]) + (None,) * len(shape)
        assert 'model' not in spec[:len(shape) - 2], k
        if k[-1] in ('k', 'v'):
            assert spec[len(shape) - 2] == ('model' if cfg.num_kv_heads % 4 == 0 else None)


def test_named_sharding_and_tree_specs():
    mesh = _mesh(MESHES['2x4'])
    rules = make_rules(mesh, mode='serve')
    assert named_sharding(rules, (16, 8), ('batch', 'vocab')) == (mesh, ('data', 'model'))
    assert named_sharding(rules, (3, 8), ('batch', 'vocab')) == (mesh, (None, 'model'))
    cfg = smoke_config(get_config('internlm2-1.8b'))
    specs = tree_specs(rules, M.abstract_params(cfg), M.param_axes(cfg))
    assert specs['embed']['table'] == (mesh, ('model',))
    assert specs['final_norm']['scale'] == (mesh, ())
    pod = make_rules(_mesh(MESHES['2x16x16']), mode='train')
    assert spec_for(pod, (64, 32), ('batch', 'embed')) == (('pod', 'data'),)
    assert spec_for(pod, (64, 32), ('embed', 'mlp')) == (('pod', 'data'), 'model')


@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
@pytest.mark.parametrize('arch', ['internlm2-1.8b', 'dbrx-132b', 'recurrentgemma-9b'])
def test_shard_tree_blocks_tile_the_whole_tree(arch, mesh):
    """Every rank's ``shard_tree`` blocks (ranks emulated by their mesh
    coordinates), put back at their offsets, give each whole leaf;
    ``shard_params`` differs from it only in a gated ``wi``'s columns."""
    shape = MESHES[mesh]
    cfg = smoke_config(get_config(arch))
    params = M.init_params(torch.Generator().manual_seed(2), cfg, torch.float32)
    axes = M.param_axes(cfg)
    rules = make_rules(_mesh(shape), mode='serve')
    flat, flat_axes = _flat(params), _flat(axes)
    rebuilt = {k: torch.full_like(v, float('nan')) for k, v in flat.items()}
    for coord in itertools.product(*(range(n) for n in shape.values())):
        rank = FFTMesh(shape, torch.device('cpu'))
        rank._coord = coord
        blocks = _flat(shard_tree(params, axes, rules, rank))
        recut = _flat(shard_params(params, cfg, rules, rank))
        for k, blk in blocks.items():
            spec = spec_for(rules, flat[k].shape, flat_axes[k])
            idx = [slice(None)] * blk.dim()
            for d, ma in enumerate(spec):
                if ma is not None:
                    i = rank.group_index(ma)
                    idx[d] = slice(i * blk.shape[d], (i + 1) * blk.shape[d])
            rebuilt[k][tuple(idx)] = blk
            if k[-1] == 'wi' and len(spec) == blk.dim() and spec[-1] is not None:
                f, p, r = flat[k].shape[-1] // 2, rank.shape['model'], rank.group_index('model')
                n = f // p
                want = torch.cat([flat[k][..., r * n:(r + 1) * n],
                                  flat[k][..., f + r * n:f + (r + 1) * n]], -1)
                assert torch.equal(recut[k], want), k
            else:
                assert torch.equal(recut[k], blk), k
    for k, v in flat.items():
        assert torch.equal(rebuilt[k], v), k
    one = make_host_mesh(1, 1, device='cpu')
    r1 = make_rules(one, mode='serve')
    back = gather_tree(shard_tree(params, axes, r1, one), M.abstract_params(cfg), axes, r1, one)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))


@pytest.mark.parametrize('mode', ['serve', 'train'])
def test_draw_params_fills_every_block_on_a_group_of_three(monkeypatch, mode):
    """On a 1 x 3 mesh 'model' cuts the smoke qwen1.5-32b's MLP width of
    96 (4 cells, and 4 a half of the packed ``wi``) in three: each rank
    draws one cell of its own, so every element of its blocks is drawn
    (``torch.empty`` filled with NaN here shows one left undrawn)."""
    empty = torch.empty
    monkeypatch.setattr(torch, 'empty', lambda *a, **kw: empty(*a, **kw).fill_(float('nan')))
    cfg = smoke_config(get_config('qwen1.5-32b'))
    shape = {'data': 1, 'model': 3}
    rules = make_rules(_mesh(shape), mode=mode)
    whole = M.abstract_params(cfg, torch.float32)
    for r in range(3):
        rank = FFTMesh(shape, torch.device('cpu'))
        rank._coord = (0, r)
        tree = draw_params(0, cfg, torch.float32, rules, rank)
        cut = [k for k, (a, b) in enumerate(zip(tree_leaves(tree), tree_leaves(whole)))
               if tuple(a.shape) != tuple(b.shape)]
        assert cut, 'no leaf is cut over the group of three'
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


@pytest.mark.parametrize('shape', list(SHAPES))
@pytest.mark.parametrize('arch', ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    got, got_axes = input_specs(get_config(arch), SHAPES[shape])
    want, want_axes = ref_input_specs(ref_config(arch), REF_SHAPES[shape])
    assert got_axes == want_axes
    assert {k: (tuple(v.shape), str(v.dtype).replace('torch.', '')) for k, v in got.items()} \
        == {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in want.items()}
    assert all(v.device.type == 'meta' for v in got.values())
