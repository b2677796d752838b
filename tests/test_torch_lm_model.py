"""The port's language models (``repro_torch.models.model``) against the
reference's (``repro.models.model``), for internlm2-1.8b (GQA + RoPE +
gated MLP), mamba2-1.3b (SSD), recurrentgemma-9b (RG-LRU + local
attention with its ring cache), qwen2-vl-2b (embeds input, M-RoPE,
untied head) and hubert-xlarge (embeds input, encoder-only, LayerNorm,
no positions) at smoke size.

The port's parameters, drawn from a seeded ``torch.Generator``, go to the
reference through ``repro_torch.weights``; tokens and embeddings are
numpy from a seed. qwen2-vl-2b's three position streams are distinct: a
4 x 4 patch grid (t fixed, h the row, w the column), then text, whose
positions continue from the grid's largest plus one in all three.
recurrentgemma-9b's 24-token prompt is longer than its smoke window of
16, so prefill folds the ring and decode writes across it.
``forward``, ``prefill`` (last logits and every cache leaf) and
``decode_step`` are held against the reference's: logits max abs <= 1e-5
(they are under 1; measured about 1e-6) and relative L2 <= 1e-5 (fp32;
XLA contracts FMAs); cache leaves, whose values reach thousands (the
SSD state), relative L2 <= 1e-5 and max abs <= 1e-5 of their largest
magnitude.
Every cache leaf has the reference prefill's shape and dtype (float32
for fp32 parameters, not ``cfg.cache_dtype``). The port also keeps the
reference's serve contract (``tests/test_serve.py``): prefill + decode
reproduce the full forward (hubert-xlarge, encoder-only, has no
decode). ``moe`` and ``mla`` raise ``NotImplementedError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.models import model as RM
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.weights import params_from_reference, params_to_reference

ARCH_IDS = ['internlm2-1.8b', 'mamba2-1.3b', 'recurrentgemma-9b', 'qwen2-vl-2b',
            'hubert-xlarge']
#: the configs with a decode step (hubert-xlarge is encoder-only)
DECODE_IDS = [a for a in ARCH_IDS if a != 'hubert-xlarge']
ATOL, REL = 1e-5, 1e-5


def _close(got, want, atol=ATOL, rel=REL):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    rl2 = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= atol and rl2 <= rel, f'max abs {err:.3e}, rel L2 {rl2:.3e}'


def mrope_positions(B: int, S: int, grid: int) -> np.ndarray:
    """(3, B, S) int32: a grid x grid patch grid (t 0, h the row, w the
    column), then text at grid, grid + 1, ... in all three streams."""
    n = grid * grid
    r, c = np.divmod(np.arange(n), grid)
    img = np.stack([np.zeros(n, np.int64), r, c])
    text = np.broadcast_to(grid + np.arange(S - n), (3, S - n))
    return np.ascontiguousarray(np.broadcast_to(
        np.concatenate([img, text], axis=1)[:, None], (3, B, S))).astype(np.int32)


def _inputs(cfg, B=2, S=28, seed=1):
    """numpy inputs: tokens (the decode steps' in embeds mode too), the
    embeddings of an embeds-mode config, M-RoPE's distinct streams."""
    rng = np.random.default_rng(seed)
    out = {'tokens': rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.input_mode == 'embeds':
        out['embeds'] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if cfg.pos_kind == 'mrope':
        out['positions'] = mrope_positions(B, S, 4)
    return out


def _batch(inputs, stop, to=torch.as_tensor):
    """The prompt's batch of the first ``stop`` positions: embeds (and
    positions) where the inputs have them, else tokens."""
    keys = ('embeds', 'positions') if 'embeds' in inputs else ('tokens',)
    return {k: to(inputs[k][:, :stop] if k != 'positions' else inputs[k][:, :, :stop])
            for k in keys if k in inputs}


def _jbatch(inputs, stop):
    return _batch(inputs, stop, jnp.asarray)


def _setup(arch):
    cfg = smoke_config(get_config(arch))
    rcfg = ref_smoke(ref_config(arch))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    rparams = tree_map(jnp.asarray, params_to_reference(params))
    return cfg, rcfg, params, rparams, _inputs(cfg)


@pytest.fixture(scope='module', params=ARCH_IDS)
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope='module', params=DECODE_IDS)
def served(request):
    return _setup(request.param)


def _close_cache(got, want):
    if not got.is_floating_point():              # the ring's slot positions
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
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
    cfg, rcfg, params, rparams, inputs = setup
    logits, aux = M.forward(params, cfg, _batch(inputs, 28))
    rlogits, raux = RM.forward(rparams, rcfg, _jbatch(inputs, 28))
    assert logits.dtype == torch.float32
    _close(logits, rlogits)
    assert float(aux) == float(raux) == 0.0


def test_loss_fn(setup):
    cfg, rcfg, params, rparams, inputs = setup
    labels = np.roll(inputs['tokens'], -1, axis=1)
    total, parts = M.loss_fn(params, cfg, dict(_batch(inputs, 28),
                                               labels=torch.as_tensor(labels)))
    rtotal, rparts = RM.loss_fn(rparams, rcfg, dict(_jbatch(inputs, 28),
                                                    labels=jnp.asarray(labels)))
    _close(total, rtotal, atol=1e-5)
    _close(parts['loss'], rparts['loss'], atol=1e-5)


def test_prefill_and_decode_match_the_reference(served):
    """Last logits, every cache leaf (values, shape, dtype), then four
    decode steps with their caches."""
    cfg, rcfg, params, rparams, inputs = served
    tokens = inputs['tokens']
    S, cap = 24, 32
    logits, caches = M.prefill(params, cfg, _batch(inputs, S), cache_cap=cap)
    rlogits, rcaches = RM.prefill(rparams, rcfg, _jbatch(inputs, S), cache_cap=cap)
    _close(logits, rlogits)
    shapes = tree_map(lambda t: (tuple(t.shape), str(t.dtype)), caches)
    assert shapes == tree_map(lambda a: (tuple(a.shape), 'torch.' + str(a.dtype)),
                              _ref_caches(rcaches))
    floats = [t for t in tree_leaves(caches) if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    assert all(t.dtype == torch.int32 for t in tree_leaves(caches)
               if not t.is_floating_point())
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


def _continued(params, cfg, inputs, S, extra):
    """The full forward's batch over a prompt of S and ``extra`` decoded
    tokens: in embeds mode the tokens' table rows, text positions."""
    if 'embeds' not in inputs:
        return {'tokens': torch.as_tensor(inputs['tokens'][:, :S + extra])}
    rows = L.embed_lookup(params['embed'], torch.as_tensor(inputs['tokens'][:, S:S + extra]))
    out = {'embeds': torch.cat([torch.as_tensor(inputs['embeds'][:, :S]), rows], dim=1)}
    if 'positions' in inputs:
        B = rows.shape[0]
        text = torch.arange(S, S + extra, dtype=torch.int32)[None, None].expand(3, B, extra)
        out['positions'] = torch.cat([torch.as_tensor(inputs['positions'][:, :, :S]), text],
                                     dim=2)
    return out


def test_prefill_decode_matches_forward(served):
    """The reference's serve contract (tests/test_serve.py), in the port."""
    cfg, _, params, _, inputs = served
    S, extra, cap = 24, 4, 32
    full = torch.as_tensor(inputs['tokens'][:, :S + extra])
    logits_full, _ = M.forward(params, cfg, _continued(params, cfg, inputs, S, extra))
    logits_pre, caches = M.prefill(params, cfg, _batch(inputs, S), cache_cap=cap)
    np.testing.assert_allclose(logits_pre[:, 0], logits_full[:, S - 1], atol=2e-3, rtol=2e-3)
    for t in range(extra):
        logits_dec, caches = M.decode_step(params, cfg, caches, full[:, S + t:S + t + 1],
                                           S + t)
        np.testing.assert_allclose(logits_dec[:, 0], logits_full[:, S + t],
                                   atol=3e-3, rtol=3e-3)


def test_param_count_of_the_published_configs():
    for arch, n in (('internlm2-1.8b', 1_699_579_904), ('mamba2-1.3b', 1_343_532_032),
                    ('recurrentgemma-9b', 9_396_301_824), ('qwen2-vl-2b', 1_777_088_000),
                    ('hubert-xlarge', 1_259_829_760)):
        assert M.param_count(get_config(arch)) == RM.param_count(ref_config(arch)) == n
        cfg = smoke_config(get_config(arch))
        assert M.param_count(cfg) == RM.param_count(ref_smoke(ref_config(arch)))
        assert M.param_count(cfg) == sum(t.numel() for t in tree_leaves(
            M.abstract_params(cfg)))


@pytest.mark.parametrize('arch, item', [
    ('recurrentgemma-9b', '11b'), ('dbrx-132b', '11d'), ('deepseek-v2-236b', '11e')])
def test_unported_block_kinds_raise(arch, item):
    """Item 11b (recurrentgemma-9b) is ported: its case holds that the
    config plans and counts as the reference's; 11d and 11e still raise."""
    cfg = smoke_config(get_config(arch))
    if item == '11b':
        params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
        assert M.param_count(cfg) == RM.param_count(ref_smoke(ref_config(arch))) == sum(
            t.numel() for t in tree_leaves(params))
        return
    with pytest.raises(NotImplementedError, match=f'item {item}'):
        M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    with pytest.raises(NotImplementedError, match=f'item {item}'):
        M.param_count(cfg)


@pytest.mark.parametrize('kind, item', [('local_attn', '11b'), ('rglru', '11b'),
                                        ('mla', '11e'), ('fftconv', '11f')])
def test_each_unported_kind_names_its_item(kind, item):
    """Items 11f (training: the FFT-conv mixer) and 11b (local attention,
    the RG-LRU) are ported. The FFT-conv case holds that the kind plans,
    has no decode cache (as the reference's) and refuses decode with the
    reference's ValueError; the 11b cases that the kind plans, caches
    and runs a block (prefill with its cache, then a decode step) as the
    reference's does."""
    cfg = smoke_config(get_config('internlm2-1.8b'))
    if item == '11f':
        assert kind not in M.UNPORTED
        assert set(M.layer_plan(cfg, kind)[kind]) == {'wi', 'kernel', 'decay', 'wo'}
        assert M._layer_cache_plan(cfg, kind, 1, 4) is None
        with pytest.raises(ValueError, match=kind):
            M._decode_block({'norm1': {'scale': torch.ones(cfg.d_model)}}, cfg, kind,
                            torch.zeros((1, 1, cfg.d_model)), None, 0)
        return
    if item == '11b':
        assert kind not in M.UNPORTED
        cfg = smoke_config(get_config('recurrentgemma-9b'))
        rcfg = ref_smoke(ref_config('recurrentgemma-9b'))
        assert tree_map(lambda s: (s.shape, s.axes, s.init, str(s.dtype)[6:]),
                        M._layer_cache_plan(cfg, kind, 2, 20)) == jax.tree.map(
            lambda s: (s.shape, s.axes, s.init, np.dtype(s.dtype).name),
            RM._layer_cache_plan(rcfg, kind, 2, 20), is_leaf=lambda x: hasattr(x, 'init'))
        p = L.init_from_plan(torch.Generator().manual_seed(1), M.layer_plan(cfg, kind),
                             torch.float32)
        rp = tree_map(jnp.asarray, params_to_reference(p))
        x = np.random.default_rng(2).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(20), (2, 20)).astype(np.int32)
        y, cache = M._apply_block(p, cfg, kind, torch.as_tensor(x), torch.as_tensor(pos),
                                  cache_cap=22, want_cache=True)
        ry, _, rcache = RM._apply_block(rp, rcfg, kind, jnp.asarray(x), jnp.asarray(pos),
                                        cache_cap=22, want_cache=True)
        _close(y, ry)
        for got, want in zip(tree_leaves(cache), tree_leaves(_ref_caches(rcache))):
            _close_cache(got, want)
        xt = np.random.default_rng(3).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y = M._decode_block(p, cfg, kind, torch.as_tensor(xt), cache, 20)
        ry, rcache = RM._decode_block(rp, rcfg, kind, jnp.asarray(xt), rcache, jnp.int32(20))
        _close(y, ry)
        for got, want in zip(tree_leaves(cache), tree_leaves(_ref_caches(rcache))):
            _close_cache(got, want)
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
    """Item 11c ported the embeds input: qwen2-vl-2b's forward takes
    embeddings and its three position streams (by default ``arange`` in
    each, as the reference's), embed_scale scales embeddings too, and a
    decode step continues in text through the table, each as the
    reference's. ``UNPORTED`` keeps only items 11d and 11e."""
    assert set(M.UNPORTED) == {'moe', 'mla'}
    cfg = smoke_config(get_config('qwen2-vl-2b'))
    rcfg = ref_smoke(ref_config('qwen2-vl-2b'))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    rparams = tree_map(jnp.asarray, params_to_reference(params))
    emb = np.random.default_rng(4).standard_normal((1, 6, cfg.d_model)).astype(np.float32)
    for scale in (False, True):
        c, rc = (dataclasses.replace(k, embed_scale=scale) for k in (cfg, rcfg))
        logits, _ = M.forward(params, c, {'embeds': torch.as_tensor(emb)})
        rlogits, _ = RM.forward(rparams, rc, {'embeds': jnp.asarray(emb)})
        _close(logits, rlogits)
        pos = torch.arange(6, dtype=torch.int32)[None, None].expand(3, 1, 6)
        same, _ = M.forward(params, c, {'embeds': torch.as_tensor(emb), 'positions': pos})
        assert torch.equal(same, logits)
        _, caches = M.prefill(params, c, {'embeds': torch.as_tensor(emb)}, cache_cap=7)
        _, rcaches = RM.prefill(rparams, rc, {'embeds': jnp.asarray(emb)}, cache_cap=7)
        tok = np.array([[5]], np.int32)
        logits, _ = M.decode_step(params, c, caches, torch.as_tensor(tok), 6)
        rlogits, _ = RM.decode_step(rparams, rc, rcaches, jnp.asarray(tok), jnp.int32(6))
        _close(logits, rlogits)
    assert M._positions(smoke_config(get_config('hubert-xlarge')), {}, 1, 6, 'cpu') is None


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
