"""The port's Mamba2 SSD mixer (``repro_torch.models.ssd``) against the
reference's (``repro.models.ssd``).

``_ssd_chunk_scan`` on lengths that the chunk divides and that it does
not (identity padding with dt = 0), one and two B/C groups; the causal
conv with and without a prefix; ``ssd_apply`` with its cache and
``ssd_decode``. Tolerances: max abs <= 1e-5, relative L2 <= 1e-5 (fp32;
the port takes the state's input as one two-operand product where XLA
contracts three operands in its own order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.models import ssd as RS
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import ssd as S
from repro_torch.models.layers import init_from_plan, tree_map
from repro_torch.weights import params_to_reference

ATOL, REL = 1e-5, 1e-5


def _close(got, want, atol=ATOL, rel=REL):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    rl2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= atol and rl2 <= rel, f'max abs {err:.3e}, rel L2 {rl2:.3e}'


@pytest.mark.parametrize('S_len, chunk, G', [(32, 8, 1), (29, 8, 1), (5, 8, 1), (29, 8, 2)],
                         ids=['divides', 'padded', 'shorter_than_chunk', 'two_groups'])
def test_ssd_chunk_scan(S_len, chunk, G):
    B, H, P, N = 2, 4, 8, 16
    rng = np.random.default_rng(S_len + G)
    xh = rng.standard_normal((B, S_len, H, P)).astype(np.float32)
    b = rng.standard_normal((B, S_len, G, N)).astype(np.float32)
    c = rng.standard_normal((B, S_len, G, N)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.5, (B, S_len, H)).astype(np.float32)
    a_log = rng.uniform(0, np.log(16), (H,)).astype(np.float32)
    y, h = S._ssd_chunk_scan(*(torch.as_tensor(a) for a in (xh, b, c, dt, a_log)), chunk)
    ry, rh = RS._ssd_chunk_scan(*(jnp.asarray(a) for a in (xh, b, c, dt, a_log)), chunk)
    assert y.dtype == h.dtype == torch.float32
    _close(y, ry)
    _close(h, rh)


@pytest.mark.parametrize('prefix', [False, True])
def test_causal_conv(prefix):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if prefix else None
    y, s = S._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                          None if st is None else torch.as_tensor(st))
    ry, rs = RS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    _close(y, ry, atol=1e-6)
    _close(s, rs, atol=0, rel=0)


def _setup(seed=0):
    cfg = smoke_config(get_config('mamba2-1.3b'))
    rcfg = ref_smoke(ref_config('mamba2-1.3b'))
    p = init_from_plan(torch.Generator().manual_seed(seed), S.ssd_plan(cfg), torch.float32)
    rp = tree_map(jnp.asarray, params_to_reference(p))
    return cfg, rcfg, p, rp


@pytest.mark.parametrize('S_len', [24, 13])
def test_ssd_apply_and_its_cache(S_len):
    cfg, rcfg, p, rp = _setup()
    x = np.random.default_rng(1).standard_normal((2, S_len, cfg.d_model)).astype(np.float32)
    out, cache = S.ssd_apply(p, cfg, torch.as_tensor(x), return_cache=True)
    rout, rcache = RS.ssd_apply(rp, rcfg, jnp.asarray(x), return_cache=True)
    _close(out, rout)
    assert set(cache) == set(rcache)
    for name in cache:
        assert str(cache[name].dtype) == 'torch.' + str(rcache[name].dtype)
        _close(cache[name], rcache[name])
    _close(S.ssd_apply(p, cfg, torch.as_tensor(x)), rout)


def test_ssd_decode_updates_the_cache_in_place():
    cfg, rcfg, p, rp = _setup(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    _, cache = S.ssd_apply(p, cfg, torch.as_tensor(x), return_cache=True)
    _, rcache = RS.ssd_apply(rp, rcfg, jnp.asarray(x), return_cache=True)
    held = {k: v for k, v in cache.items()}
    for t in range(3):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        out, cache2 = S.ssd_decode(p, cfg, torch.as_tensor(x1), cache)
        rout, rcache = RS.ssd_decode(rp, rcfg, jnp.asarray(x1), rcache)
        assert cache2 is cache and all(cache[k] is held[k] for k in held)
        _close(out, rout)
        for name in cache:
            _close(cache[name], rcache[name])


def test_ssd_dims_and_plan():
    for arch in ('mamba2-1.3b',):
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert S.ssd_dims(cfg) == RS.ssd_dims(rcfg) == (4096, 64, 64, 128)
        small = dataclasses.replace(cfg, ssm_groups=2)
        plan = S.ssd_plan(small)
        rplan = RS.ssd_plan(dataclasses.replace(rcfg, ssm_groups=2))
        assert tree_map(lambda s: (s.shape, s.axes, s.init), plan) == {
            k: ({n: (s.shape, s.axes, s.init) for n, s in v.items()} if isinstance(v, dict)
                else (v.shape, v.axes, v.init)) for k, v in rplan.items()}
