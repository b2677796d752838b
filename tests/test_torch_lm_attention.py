"""The port's flash attention and GQA block (``repro_torch.models.attention``)
against the reference's (``repro.models.attention``).

``flash_attention`` over its three blockings (one pass, KV chunks, query
blocks over KV chunks; a length that no chunk divides runs one pass),
GQA groups of 1, 2 and 4, and its masks (``causal``, ``window``,
``q_offset``, ``kv_len``, ``kv_positions``); the GQA block's prefill
(output and caches) and decode; recurrentgemma-9b's local attention:
windowed prefill with its ring cache for a prompt shorter than, equal
to and longer than the window and a cache shorter than the window, and
ring decode across two wraps; qwen2-vl-2b's M-RoPE decode;
deepseek-v2-236b's MLA: prefill with its compressed cache (latent and
shared roped key) and decode that writes it in place; a dense cache
shorter than the prompt raises, as the reference's. Tolerances: max abs
<= 2e-6 and relative L2 <= 1e-6 (fp32; the exp and the sums are taken
in another order by XLA); a block's output and caches max abs 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.models import attention as RA
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention as A
from repro_torch.models.layers import init_from_plan
from repro_torch.weights import params_to_reference

ATOL, REL = 2e-6, 1e-6


def _close(got, want, atol=ATOL, rel=REL):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    rl2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= atol and rl2 <= rel, f'max abs {err:.3e}, rel L2 {rl2:.3e}'


def _qkv(seed, B, Sq, Skv, H, KH, D=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))


# (Sq, Skv, chunk, q_chunk): one pass; KV chunks; query blocks over KV
# chunks; a length no chunk divides (one pass); a query length no block
# divides over KV chunks
BLOCKINGS = [(24, 24, 32, 32), (64, 64, 16, 64), (64, 64, 16, 16), (40, 40, 16, 16),
             (24, 64, 16, 16)]


@pytest.mark.parametrize('blocking', BLOCKINGS, ids=lambda b: 'x'.join(map(str, b)))
@pytest.mark.parametrize('group', [1, 2, 4])
def test_flash_attention_blockings_and_groups(blocking, group):
    Sq, Skv, chunk, q_chunk = blocking
    q, k, v = _qkv(0, 2, Sq, Skv, 4, 4 // group)
    off = Skv - Sq
    got = A.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                            q_offset=off, chunk=chunk, q_chunk=q_chunk)
    want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=off,
                              chunk=chunk, q_chunk=q_chunk)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize('case', [
    dict(causal=False), dict(causal=True, window=8), dict(causal=False, window=5),
    dict(causal=True, q_offset=7), dict(causal=True, kv_len=37, q_offset=36),
    dict(causal=False, kv_len=20)], ids=lambda c: ','.join(f'{k}={v}' for k, v in c.items()))
def test_flash_attention_masks(case):
    Sq = 1 if 'kv_len' in case and case.get('causal') else 32
    q, k, v = _qkv(1, 2, Sq, 48, 4, 2)
    kw = dict(chunk=16, q_chunk=16, **case)
    got = A.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw)
    want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    _close(got, want)


def test_flash_attention_output_has_qs_dtype():
    q, k, v = _qkv(2, 1, 8, 8, 2, 1)
    got = A.flash_attention(torch.as_tensor(q).bfloat16(), torch.as_tensor(k),
                            torch.as_tensor(v))
    want = RA.flash_attention(jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(k),
                              jnp.asarray(v))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2 ** -7, rtol=2 ** -7)


def _cfg(bias=False):
    cfg = smoke_config(get_config('internlm2-1.8b'))
    return dataclasses.replace(cfg, qkv_bias=bias)


def _params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = init_from_plan(gen, A.gqa_plan(cfg), torch.float32)
    if cfg.qkv_bias:                        # non-zero biases, so they are exercised
        for name in ('wq', 'wk', 'wv'):
            p[name]['b'] = torch.randn(p[name]['b'].shape, generator=gen)
    return p, {k: {n: jnp.asarray(a) for n, a in d.items()}
               for k, d in params_to_reference(p).items()}


def _ref_cfg(cfg):
    return dataclasses.replace(ref_smoke(ref_config(cfg.name)), qkv_bias=cfg.qkv_bias)


@pytest.mark.parametrize('bias', [False, True], ids=['nobias', 'qkv_bias'])
def test_gqa_prefill_output_and_caches(bias):
    cfg = _cfg(bias)
    p, rp = _params(cfg)
    x = np.random.default_rng(3).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    out, cache = A.gqa_prefill(p, cfg, torch.as_tensor(x), torch.as_tensor(pos), cache_cap=32)
    rout, rcache = RA.gqa_prefill(rp, _ref_cfg(cfg), jnp.asarray(x), jnp.asarray(pos),
                                  cache_cap=32)
    _close(out, rout, atol=1e-5)
    for name in ('k', 'v'):
        assert cache[name].dtype == torch.float32 and rcache[name].dtype == jnp.float32
        _close(cache[name], rcache[name], atol=1e-5)
    _close(A.gqa_apply(p, cfg, torch.as_tensor(x), torch.as_tensor(pos)), rout, atol=1e-5)


def test_gqa_decode_writes_the_cache_in_place():
    cfg = _cfg()
    p, rp = _params(cfg, 1)
    rng = np.random.default_rng(4)
    ck, cv = (rng.standard_normal((2, 32, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    rout, rk, rv = RA.gqa_decode(rp, _ref_cfg(cfg), jnp.asarray(x), jnp.asarray(ck),
                                 jnp.asarray(cv), jnp.int32(20))
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    out, k2, v2 = A.gqa_decode(p, cfg, torch.as_tensor(x), tk, tv, 20)
    assert k2 is tk and v2 is tv
    _close(out, rout, atol=1e-5)
    _close(tk, rk, atol=1e-5)
    _close(tv, rv, atol=1e-5)


def test_sequence_parallel_attention_is_not_ported():
    cfg = _cfg()
    p, _ = _params(cfg)
    x = torch.zeros((1, 4, cfg.d_model))
    pos = torch.arange(4)[None]
    for fn in (A.gqa_apply, A.gqa_prefill):
        with pytest.raises(NotImplementedError, match='item 10'):
            fn(p, cfg, x, pos, sp=True)


# ---------------------------------------------------------------------------
# Sliding window: explicit key positions, the ring cache, M-RoPE decode
# ---------------------------------------------------------------------------

def test_flash_attention_kv_positions():
    """Explicit key positions in ring order with empty (-1) slots, under
    a window, in one pass and in KV chunks."""
    q, k, v = _qkv(5, 2, 1, 32, 4, 2)
    kpos = np.roll(np.arange(40, 72, dtype=np.int32), 40 % 32)
    kpos[[3, 17]] = -1
    for chunk in (32, 8):
        kw = dict(causal=True, window=24, q_offset=71, chunk=chunk)
        got = A.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                kv_positions=torch.as_tensor(kpos), **kw)
        want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  kv_positions=jnp.asarray(kpos), **kw)
        _close(got, want)
    q, k, v = _qkv(6, 2, 16, 16, 4, 4)
    kpos = np.arange(16, dtype=np.int32)
    got = A.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                            kv_positions=torch.as_tensor(kpos), chunk=8, q_chunk=8)
    _close(got, A.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                  chunk=8, q_chunk=8), atol=0, rel=0)


def _local_cfg():
    return smoke_config(get_config('recurrentgemma-9b'))


def _local_params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = init_from_plan(gen, A.gqa_plan(cfg), torch.float32)
    return p, {k: {n: jnp.asarray(a) for n, a in d.items()}
               for k, d in params_to_reference(p).items()}


# (S, cache_cap): shorter than the window (16: the pad branch); equal;
# longer (the ring, rolled); a cap under the window (W = 12), S < W and
# S > W
WINDOWED = [(10, 24), (16, 24), (27, 32), (8, 12), (12, 12)]


@pytest.mark.parametrize('S, cap', WINDOWED, ids=lambda v: str(v))
def test_windowed_prefill_output_and_ring_cache(S, cap):
    cfg = _local_cfg()
    p, rp = _local_params(cfg)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    out, cache = A.gqa_prefill(p, cfg, torch.as_tensor(x), torch.as_tensor(pos),
                               window=cfg.window, cache_cap=cap)
    rout, rcache = RA.gqa_prefill(rp, _ref_cfg(cfg), jnp.asarray(x), jnp.asarray(pos),
                                  window=cfg.window, cache_cap=cap)
    _close(out, rout, atol=1e-5)
    W = min(cfg.window, cap)
    assert set(cache) == {'k', 'v', 'kpos'}
    assert cache['kpos'].dtype == torch.int32 and cache['kpos'].shape == (W,)
    np.testing.assert_array_equal(cache['kpos'].numpy(), np.asarray(rcache['kpos']))
    for name in ('k', 'v'):
        assert cache[name].shape == (2, W, cfg.num_kv_heads, cfg.head_dim)
        _close(cache[name], rcache[name], atol=1e-5)
    _close(A.gqa_apply(p, cfg, torch.as_tensor(x), torch.as_tensor(pos), window=cfg.window),
           rout, atol=1e-5)


def test_ring_decode_across_a_wrap():
    """Prefill 20 tokens into a 16-slot ring, then 20 decode steps: the
    slots wrap past 16 and 32; each step's output and the whole cache
    against the reference's, the cache written in place."""
    cfg = _local_cfg()
    p, rp = _local_params(cfg, 2)
    rcfg = _ref_cfg(cfg)
    S, steps = 20, 20
    x = np.random.default_rng(7).standard_normal((2, S + steps, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    _, cache = A.gqa_prefill(p, cfg, torch.as_tensor(x[:, :S]), torch.as_tensor(pos),
                             window=cfg.window, cache_cap=S + steps)
    _, rcache = RA.gqa_prefill(rp, rcfg, jnp.asarray(x[:, :S]), jnp.asarray(pos),
                               window=cfg.window, cache_cap=S + steps)
    held = dict(cache)
    for t in range(steps):
        xt = x[:, S + t:S + t + 1]
        out, cache = A.gqa_decode_ring(p, cfg, torch.as_tensor(xt), cache, S + t,
                                       window=cfg.window)
        rout, rcache = RA.gqa_decode_ring(rp, rcfg, jnp.asarray(xt), rcache, jnp.int32(S + t),
                                          window=cfg.window)
        assert all(cache[k] is held[k] for k in cache)
        _close(out, rout, atol=1e-5)
        np.testing.assert_array_equal(cache['kpos'].numpy(), np.asarray(rcache['kpos']))
        for name in ('k', 'v'):
            _close(cache[name], rcache[name], atol=1e-5)
    assert sorted(cache['kpos'].tolist()) == list(range(S + steps - 16, S + steps))


def test_mrope_decode_advances_all_three_streams():
    """qwen2-vl-2b's decode: positions (3, B, 1), every stream at the
    cache length; the new k/v written in place."""
    cfg = smoke_config(get_config('qwen2-vl-2b'))
    gen = torch.Generator().manual_seed(3)
    p = init_from_plan(gen, A.gqa_plan(cfg), torch.float32)
    for name in ('wq', 'wk', 'wv'):
        p[name]['b'] = torch.randn(p[name]['b'].shape, generator=gen)
    rp = {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params_to_reference(p).items()}
    rcfg = ref_smoke(ref_config('qwen2-vl-2b'))
    rng = np.random.default_rng(8)
    ck, cv = (rng.standard_normal((2, 24, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    rout, rk, rv = RA.gqa_decode(rp, rcfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                 jnp.int32(13))
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    out, k2, v2 = A.gqa_decode(p, cfg, torch.as_tensor(x), tk, tv, 13)
    assert k2 is tk and v2 is tv
    _close(out, rout, atol=1e-5)
    _close(tk, rk, atol=1e-5)
    _close(tv, rv, atol=1e-5)
    # the three streams at the cache length are RoPE at it: the sections
    # select among equal angles
    q3 = A.gqa_qkv(p, cfg, torch.as_tensor(x), torch.full((3, 2, 1), 13))[0]
    import dataclasses as dc
    q1 = A.gqa_qkv(p, dc.replace(cfg, pos_kind='rope'), torch.as_tensor(x),
                   torch.full((2, 1), 13))[0]
    _close(q3, q1.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2-236b): apply, prefill with the compressed cache, decode
# ---------------------------------------------------------------------------

def _mla_setup(seed=0):
    cfg = smoke_config(get_config('deepseek-v2-236b'))
    gen = torch.Generator().manual_seed(seed)
    p = init_from_plan(gen, A.mla_plan(cfg), torch.float32)
    for norm in ('q_norm', 'kv_norm'):       # non-trivial norm scales
        p[norm]['scale'] = 1 + 0.1 * torch.randn(p[norm]['scale'].shape, generator=gen)
    rp = {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params_to_reference(p).items()}
    return cfg, ref_smoke(ref_config('deepseek-v2-236b')), p, rp


def test_mla_plan_is_the_references():
    cfg, rcfg, p, _ = _mla_setup()
    plan = {k: {n: (s.shape, s.axes, s.init) for n, s in d.items()}
            for k, d in A.mla_plan(cfg).items()}
    assert plan == {k: {n: (s.shape, s.axes, s.init) for n, s in d.items()}
                    for k, d in RA.mla_plan(rcfg).items()}


@pytest.mark.parametrize('S, cap', [(24, 32), (40, 40), (64, 70)], ids=lambda v: str(v))
def test_mla_prefill_output_and_compressed_cache(S, cap):
    """One pass (24), one pass at the cap (40: no chunk divides it) and KV
    chunks with query blocks (64 over the smoke chunk of 32)."""
    cfg, rcfg, p, rp = _mla_setup()
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    out, cache = A.mla_prefill(p, cfg, torch.as_tensor(x), torch.as_tensor(pos), cache_cap=cap)
    rout, rcache = RA.mla_prefill(rp, rcfg, jnp.asarray(x), jnp.asarray(pos), cache_cap=cap)
    _close(out, rout, atol=1e-5)
    assert set(cache) == {'latent', 'krope'}
    assert cache['latent'].shape == (2, cap, cfg.kv_lora_rank)
    assert cache['krope'].shape == (2, cap, cfg.rope_head_dim)
    for name in cache:
        assert cache[name].dtype == torch.float32
        _close(cache[name], rcache[name], atol=1e-5)
    _close(A.mla_apply(p, cfg, torch.as_tensor(x), torch.as_tensor(pos)),
           RA.mla_apply(rp, rcfg, jnp.asarray(x), jnp.asarray(pos)), atol=1e-5)


def test_mla_decode_writes_the_compressed_cache_in_place():
    """Prefill 20 tokens into a cache of 28, then 6 decode steps: each
    step's output and both cache leaves against the reference's, the
    leaves written in place."""
    cfg, rcfg, p, rp = _mla_setup(1)
    S, steps = 20, 6
    x = np.random.default_rng(9).standard_normal((2, S + steps, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    _, cache = A.mla_prefill(p, cfg, torch.as_tensor(x[:, :S]), torch.as_tensor(pos),
                             cache_cap=S + steps + 2)
    _, rcache = RA.mla_prefill(rp, rcfg, jnp.asarray(x[:, :S]), jnp.asarray(pos),
                               cache_cap=S + steps + 2)
    lat, kr = cache['latent'], cache['krope']
    rlat, rkr = rcache['latent'], rcache['krope']
    for t in range(steps):
        xt = x[:, S + t:S + t + 1]
        out, lat2, kr2 = A.mla_decode(p, cfg, torch.as_tensor(xt), lat, kr, S + t)
        rout, rlat, rkr = RA.mla_decode(rp, rcfg, jnp.asarray(xt), rlat, rkr, jnp.int32(S + t))
        assert lat2 is lat and kr2 is kr
        _close(out, rout, atol=1e-5)
        _close(lat, rlat, atol=1e-5)
        _close(kr, rkr, atol=1e-5)
    assert float(lat[:, S + steps:].abs().max()) == 0.0


@pytest.mark.parametrize('kind', ['attn', 'mla'])
def test_a_cache_shorter_than_the_prompt_raises(kind):
    """A dense cache (GQA, MLA) of fewer positions than the prompt raises
    ``ValueError``, as the reference's ``jnp.pad`` does; ``F.pad`` would
    crop it without a word."""
    if kind == 'mla':
        cfg, rcfg, p, rp = _mla_setup()
        fn, rfn = A.mla_prefill, RA.mla_prefill
    else:
        cfg, rcfg = _cfg(), _ref_cfg(_cfg())
        p, rp = _params(cfg)
        fn, rfn = A.gqa_prefill, RA.gqa_prefill
    x = np.random.default_rng(5).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    with pytest.raises(ValueError):
        rfn(rp, rcfg, jnp.asarray(x), jnp.asarray(pos), cache_cap=12)
    with pytest.raises(ValueError, match='cache_cap 12 is shorter than the prompt'):
        fn(p, cfg, torch.as_tensor(x), torch.as_tensor(pos), cache_cap=12)
    _, cache = fn(p, cfg, torch.as_tensor(x), torch.as_tensor(pos), cache_cap=16)
    assert all(t.shape[1] == 16 for t in cache.values())
