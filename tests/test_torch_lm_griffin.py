"""The port's RG-LRU block (``repro_torch.models.griffin``) against the
reference's (``repro.models.griffin``), recurrentgemma-9b at smoke size.

Inputs are numpy from seeds; parameters are drawn by the port (the
biases and ``lam`` redrawn so the gates are exercised) and carried to
the reference by ``repro_torch.weights``. Tolerances (fp32):

* against the reference, relative L2 <= 1e-5: the gates are the same
  operations; the scan inside a chunk is a Hillis-Steele doubling scan
  where the reference runs ``jax.lax.associative_scan`` (another tree,
  so other roundings; ROADMAP queue 3);
* the chunked scan against a float64 sequential loop, max abs and
  relative <= 1e-4 (the reference's own bound, ``tests/test_models.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.models import griffin as RG
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import griffin as G
from repro_torch.models.layers import init_from_plan, tree_map
from repro_torch.weights import params_to_reference

REL = 1e-5
SEQ_TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope='module')
def block():
    cfg = smoke_config(get_config('recurrentgemma-9b'))
    rcfg = ref_smoke(ref_config('recurrentgemma-9b'))
    gen = torch.Generator().manual_seed(0)
    p = init_from_plan(gen, G.rglru_plan(cfg), torch.float32)
    for name in ('ba', 'bi', 'lam'):          # off their constant inits
        p[name] = torch.randn(p[name].shape, generator=gen)
    return cfg, rcfg, p, tree_map(jnp.asarray, params_to_reference(p))


def test_plan_is_the_references(block):
    cfg, rcfg, *_ = block
    plan = tree_map(lambda s: (s.shape, s.axes, s.init), G.rglru_plan(cfg))
    rplan = {k: ({n: (s.shape, s.axes, s.init) for n, s in v.items()} if isinstance(v, dict)
                 else (v.shape, v.axes, v.init)) for k, v in RG.rglru_plan(rcfg).items()}
    assert plan == rplan
    assert G.C_FACTOR == RG.C_FACTOR == 8.0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
def test_gates(block, dtype):
    cfg, _, p, rp = block
    x = np.random.default_rng(1).standard_normal((2, 7, cfg.lru_width)).astype(np.float32)
    xt = torch.as_tensor(x).to(dtype)
    a, b = G._gates(p, xt)
    ra, rb = RG._gates(rp, jnp.asarray(np.asarray(xt.float())).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    assert a.dtype == b.dtype == torch.float32       # fp32 whatever x's dtype
    assert _rel(a, ra) <= REL and _rel(b, rb) <= REL
    assert float(a.max()) < 1.0 and float(a.min()) > 0.0


def _sequential(a, b, h0):
    h = np.asarray(h0, np.float64)
    hs = []
    for t in range(a.shape[1]):
        h = np.asarray(a[:, t], np.float64) * h + np.asarray(b[:, t], np.float64)
        hs.append(h)
    return np.stack(hs, axis=1), h


# (S, chunk): whole chunks; a padded tail; one chunk; another padded
# tail; a sequence shorter than the chunk
SCANS = [(24, 8), (30, 16), (16, 16), (20, 8), (5, 8)]


@pytest.mark.parametrize('s, chunk', SCANS, ids=lambda v: str(v))
def test_lru_scan_chunked(s, chunk):
    rng = np.random.default_rng(s * 100 + chunk)
    B, W = 2, 8
    a = (1 / (1 + np.exp(-rng.standard_normal((B, s, W))))).astype(np.float32)
    b = rng.standard_normal((B, s, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    hs, hf = G._lru_scan_chunked(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(h0),
                                 chunk)
    rhs, rhf = RG._lru_scan_chunked(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk)
    assert hs.shape == (B, s, W) and hf.shape == (B, W)
    assert _rel(hs, rhs) <= REL and _rel(hf, rhf) <= REL
    want, want_f = _sequential(a, b, h0)
    np.testing.assert_allclose(hs.numpy(), want, atol=SEQ_TOL, rtol=SEQ_TOL)
    np.testing.assert_allclose(hf.numpy(), want_f, atol=SEQ_TOL, rtol=SEQ_TOL)
    np.testing.assert_array_equal(hf.numpy(), hs[:, -1].numpy())   # the true final state


def test_rglru_apply_and_its_cache(block):
    cfg, rcfg, p, rp = block
    x = np.random.default_rng(2).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    out, cache = G.rglru_apply(p, cfg, torch.as_tensor(x), return_cache=True)
    rout, rcache = RG.rglru_apply(rp, rcfg, jnp.asarray(x), return_cache=True)
    assert _rel(out, rout) <= REL
    assert set(cache) == set(rcache) == {'h', 'conv'}
    for k in cache:
        assert cache[k].dtype == torch.float32 and cache[k].shape == rcache[k].shape
        assert _rel(cache[k], rcache[k]) <= REL, k
    assert torch.equal(G.rglru_apply(p, cfg, torch.as_tensor(x)), out)


def test_rglru_decode_matches_prefill_and_the_reference(block):
    """Decode steps from a zero cache reproduce the full sequence (the
    reference's ``test_rglru_decode_matches_prefill``), each step equals
    the reference's decode, and the cache is written in place."""
    cfg, rcfg, p, rp = block
    B, S = 2, 10
    x = (np.random.default_rng(3).standard_normal((B, S, cfg.d_model)) * 0.5).astype(
        np.float32)
    full, cache = G.rglru_apply(p, cfg, torch.as_tensor(x), return_cache=True)
    dec = {'h': torch.zeros((B, cfg.lru_width)),
           'conv': torch.zeros((B, cfg.conv_width - 1, cfg.lru_width))}
    rdec = tree_map(jnp.asarray, params_to_reference(dec))
    held = dict(dec)
    outs = []
    for t in range(S):
        o, dec = G.rglru_decode(p, cfg, torch.as_tensor(x[:, t:t + 1]), dec)
        ro, rdec = RG.rglru_decode(rp, rcfg, jnp.asarray(x[:, t:t + 1]), rdec)
        assert all(dec[k] is held[k] for k in dec)            # in place
        assert _rel(o, ro) <= REL and _rel(dec['h'], rdec['h']) <= REL
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(dec['h'].numpy(), cache['h'].numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(dec['conv'].numpy(), cache['conv'].numpy(), atol=1e-6)
