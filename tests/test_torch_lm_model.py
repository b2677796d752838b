"""The port's language models (``repro_torch.models.model``) against the
reference's (``repro.models.model``), for internlm2-1.8b (GQA + RoPE +
gated MLP) and mamba2-1.3b (SSD) at smoke size.

The port's parameters, drawn from a seeded ``torch.Generator``, go to the
reference through ``repro_torch.weights``; tokens are numpy from a seed.
``forward``, ``prefill`` (last logits and every cache leaf) and
``decode_step`` are held against the reference's: logits max abs <= 1e-5
(they are under 1; measured about 1e-6) and relative L2 <= 1e-5 (fp32;
XLA contracts FMAs); cache leaves, whose values reach thousands (the
SSD state), relative L2 <= 1e-5 and max abs <= 1e-5 of their largest
magnitude.
Every cache leaf has the reference prefill's shape and dtype (float32
for fp32 parameters, not ``cfg.cache_dtype``). The port also keeps the
reference's serve contract (``tests/test_serve.py``): prefill + decode
reproduce the full forward. Unported kinds raise ``NotImplementedError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.models import model as RM
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.weights import params_from_reference, params_to_reference

ARCH_IDS = ['internlm2-1.8b', 'mamba2-1.3b']
ATOL, REL = 1e-5, 1e-5


def _close(got, want, atol=ATOL, rel=REL):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    rl2 = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= atol and rl2 <= rel, f'max abs {err:.3e}, rel L2 {rl2:.3e}'


@pytest.fixture(scope='module', params=ARCH_IDS)
def setup(request):
    arch = request.param
    cfg = smoke_config(get_config(arch))
    rcfg = ref_smoke(ref_config(arch))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    rparams = tree_map(jnp.asarray, params_to_reference(params))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 28)).astype(np.int32)
    return cfg, rcfg, params, rparams, tokens


def _close_cache(got, want):
    _close(got, want, atol=ATOL * np.abs(np.asarray(want)).max())


def _ref_caches(rcaches):
    return jax.tree.map(np.asarray, rcaches)


def test_param_tree_is_the_reference_layout(setup):
    cfg, rcfg, params, rparams, _ = setup
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)), params) == tree_map(
        lambda a: (tuple(a.shape), 'torch.' + str(a.dtype)), rparams)
    back = params_from_reference(params_to_reference(params), device='cpu')
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))
    plan = tree_map(lambda s: (s.shape, s.axes, s.init), M.model_plan(cfg))
    rplan = jax.tree.map(lambda s: (s.shape, s.axes, s.init), RM.model_plan(rcfg),
                         is_leaf=lambda x: hasattr(x, 'init'))
    assert plan == rplan
    assert M.param_axes(cfg) == RM.param_axes(rcfg)
    assert M.split_layers(cfg) == RM.split_layers(rcfg)


def test_forward(setup):
    cfg, rcfg, params, rparams, tokens = setup
    logits, aux = M.forward(params, cfg, {'tokens': torch.as_tensor(tokens)})
    rlogits, raux = RM.forward(rparams, rcfg, {'tokens': jnp.asarray(tokens)})
    assert logits.dtype == torch.float32
    _close(logits, rlogits)
    assert float(aux) == float(raux) == 0.0


def test_loss_fn(setup):
    cfg, rcfg, params, rparams, tokens = setup
    labels = np.roll(tokens, -1, axis=1)
    total, parts = M.loss_fn(params, cfg, {'tokens': torch.as_tensor(tokens),
                                           'labels': torch.as_tensor(labels)})
    rtotal, rparts = RM.loss_fn(rparams, rcfg, {'tokens': jnp.asarray(tokens),
                                                'labels': jnp.asarray(labels)})
    _close(total, rtotal, atol=1e-5)
    _close(parts['loss'], rparts['loss'], atol=1e-5)


def test_prefill_and_decode_match_the_reference(setup):
    """Last logits, every cache leaf (values, shape, dtype), then four
    decode steps with their caches."""
    cfg, rcfg, params, rparams, tokens = setup
    S, cap = 24, 32
    logits, caches = M.prefill(params, cfg, {'tokens': torch.as_tensor(tokens[:, :S])},
                               cache_cap=cap)
    rlogits, rcaches = RM.prefill(rparams, rcfg, {'tokens': jnp.asarray(tokens[:, :S])},
                                  cache_cap=cap)
    _close(logits, rlogits)
    shapes = tree_map(lambda t: (tuple(t.shape), str(t.dtype)), caches)
    assert shapes == tree_map(lambda a: (tuple(a.shape), 'torch.' + str(a.dtype)),
                              _ref_caches(rcaches))
    assert all(t.dtype == torch.float32 for t in tree_leaves(caches))
    assert all(d != str(cfg.cache_dtype) for _, d in tree_leaves(shapes))
    plan = tree_map(lambda p: p.shape, M.cache_plan(cfg, 2, cap))
    assert plan == tree_map(lambda s: s[0], shapes)
    assert plan == jax.tree.map(lambda p: p.shape, RM.cache_plan(rcfg, 2, cap),
                                is_leaf=lambda x: hasattr(x, 'init'))
    for got, want in zip(tree_leaves(caches), tree_leaves(_ref_caches(rcaches))):
        _close_cache(got, want)
    for t in range(4):
        tok = tokens[:, S + t:S + t + 1]
        held = tree_leaves(caches)
        logits, caches = M.decode_step(params, cfg, caches, torch.as_tensor(tok), S + t)
        rlogits, rcaches = RM.decode_step(rparams, rcfg, rcaches, jnp.asarray(tok),
                                          jnp.int32(S + t))
        assert all(a is b for a, b in zip(tree_leaves(caches), held))   # in place
        _close(logits, rlogits)
        for got, want in zip(tree_leaves(caches), tree_leaves(_ref_caches(rcaches))):
            _close_cache(got, want)


def test_prefill_decode_matches_forward(setup):
    """The reference's serve contract (tests/test_serve.py), in the port."""
    cfg, _, params, _, tokens = setup
    S, extra, cap = 24, 4, 32
    full = torch.as_tensor(tokens[:, :S + extra])
    logits_full, _ = M.forward(params, cfg, {'tokens': full})
    logits_pre, caches = M.prefill(params, cfg, {'tokens': full[:, :S]}, cache_cap=cap)
    np.testing.assert_allclose(logits_pre[:, 0], logits_full[:, S - 1], atol=2e-3, rtol=2e-3)
    for t in range(extra):
        logits_dec, caches = M.decode_step(params, cfg, caches, full[:, S + t:S + t + 1],
                                           S + t)
        np.testing.assert_allclose(logits_dec[:, 0], logits_full[:, S + t],
                                   atol=3e-3, rtol=3e-3)


def test_param_count_of_the_published_configs():
    for arch, n in (('internlm2-1.8b', 1_699_579_904), ('mamba2-1.3b', 1_343_532_032)):
        assert M.param_count(get_config(arch)) == RM.param_count(ref_config(arch)) == n
        cfg = smoke_config(get_config(arch))
        assert M.param_count(cfg) == RM.param_count(ref_smoke(ref_config(arch)))
        assert M.param_count(cfg) == sum(t.numel() for t in tree_leaves(
            M.abstract_params(cfg)))


@pytest.mark.parametrize('arch, item', [
    ('recurrentgemma-9b', '11b'), ('dbrx-132b', '11d'), ('deepseek-v2-236b', '11e')])
def test_unported_block_kinds_raise(arch, item):
    cfg = smoke_config(get_config(arch))
    with pytest.raises(NotImplementedError, match=f'item {item}'):
        M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    with pytest.raises(NotImplementedError, match=f'item {item}'):
        M.param_count(cfg)


@pytest.mark.parametrize('kind, item', [('local_attn', '11b'), ('rglru', '11b'),
                                        ('mla', '11e'), ('fftconv', '11f')])
def test_each_unported_kind_names_its_item(kind, item):
    """Item 11f (training) ported the FFT-conv mixer: its case now holds
    that the kind plans, has no decode cache (as the reference's) and
    refuses decode with the reference's ValueError."""
    cfg = smoke_config(get_config('internlm2-1.8b'))
    if item == '11f':
        assert kind not in M.UNPORTED
        assert set(M.layer_plan(cfg, kind)[kind]) == {'wi', 'kernel', 'decay', 'wo'}
        assert M._layer_cache_plan(cfg, kind, 1, 4) is None
        with pytest.raises(ValueError, match=kind):
            M._decode_block({'norm1': {'scale': torch.ones(cfg.d_model)}}, cfg, kind,
                            torch.zeros((1, 1, cfg.d_model)), None, 0)
        return
    with pytest.raises(NotImplementedError, match=f'item {item}'):
        M.layer_plan(cfg, kind)
    with pytest.raises(NotImplementedError, match=f'item {item}'):
        M._apply_block({'norm1': {'scale': torch.ones(cfg.d_model)}}, cfg, kind,
                       torch.zeros((1, 2, cfg.d_model)), None)
    with pytest.raises(NotImplementedError, match=f'item {item}'):
        M._layer_cache_plan(cfg, kind, 1, 4)
    with pytest.raises(ValueError, match='unknown block kind'):
        M.layer_plan(cfg, 'conv')


def test_embeds_input_is_not_ported():
    cfg = smoke_config(get_config('qwen2-vl-2b'))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    batch = {'embeds': torch.zeros((1, 4, cfg.d_model))}
    with pytest.raises(NotImplementedError, match='item 11c'):
        M.forward(params, cfg, batch)


def test_every_causal_token_config_with_ported_kinds_serves():
    """The registry's other dense GQA configs run the same path."""
    for arch in ('codeqwen1.5-7b', 'granite-3-8b', 'qwen1.5-32b'):
        cfg = smoke_config(get_config(arch))
        assert ARCHS[arch].block_pattern == ('attn',)
        params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
        toks = torch.randint(0, cfg.vocab_size, (1, 10), generator=torch.Generator())
        logits, caches = M.prefill(params, cfg, {'tokens': toks[:, :8]}, cache_cap=10)
        full, _ = M.forward(params, cfg, {'tokens': toks})
        np.testing.assert_allclose(logits[:, 0], full[:, 7], atol=2e-3, rtol=2e-3)
        logits, _ = M.decode_step(params, cfg, caches, toks[:, 8:9], 8)
        np.testing.assert_allclose(logits[:, 0], full[:, 8], atol=3e-3, rtol=3e-3)
