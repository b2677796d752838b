"""The port's MoE feed-forward (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) at smoke size: dbrx-132b (8 experts
top-2, no shared expert) and deepseek-v2-236b (8 experts top-2 and one
shared expert).

Parameters come from the port's seeded ``init_from_plan`` and go to the
reference through ``repro_torch.weights``; inputs are numpy from a seed.
``capacity`` and ``_dispatch_indices`` (on the same ``idx``) are held
bitwise. ``route``'s probabilities and gates within max abs 1e-6 and its
expert ids equal: each test first checks that the inputs leave a gap of
at least 1e-4 between every token's k-th and (k+1)-th probability, so a
near-tie cannot flip the top-k on one side only. ``moe_apply`` (output
and aux loss) within max abs 1e-5 and relative L2 1e-5 (fp32; XLA
contracts FMAs, and the port sums a token's K outputs in top-k order
where the reference's scatter-add sums them in expert order), with and
without the shared expert, at capacity factor 8 (no pair drops) and at
1.0 (pairs drop; the test checks that some do).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.models import moe as RMoE
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import moe
from repro_torch.models.layers import init_from_plan, tree_map
from repro_torch.weights import params_to_reference

ATOL, REL = 1e-5, 1e-5
#: the least gap between a token's k-th and (k+1)-th router probability
#: for which the two packages must pick the same experts
TIE_GAP = 1e-4
ARCHS = ['dbrx-132b', 'deepseek-v2-236b']


def _close(got, want, atol=ATOL, rel=REL):
    got, want = got.detach().numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    rl2 = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= atol and rl2 <= rel, f'max abs {err:.3e}, rel L2 {rl2:.3e}'


def _cfgs(arch, **kw):
    return (dataclasses.replace(smoke_config(get_config(arch)), **kw),
            dataclasses.replace(ref_smoke(ref_config(arch)), **kw))


def _params(cfg, seed=0):
    p = init_from_plan(torch.Generator().manual_seed(seed), moe.moe_plan(cfg), torch.float32)
    return p, tree_map(jnp.asarray, params_to_reference(p))


def _x(cfg, B=2, S=16, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _assert_no_near_tie(probs, K):
    top = np.sort(np.asarray(probs, np.float64), axis=-1)[..., ::-1]
    assert (top[..., K - 1] - top[..., K]).min() > TIE_GAP


@pytest.mark.parametrize('arch', ARCHS)
def test_plan_matches_the_reference(arch):
    cfg, rcfg = _cfgs(arch)
    plan = tree_map(lambda s: (s.shape, s.axes, s.init), moe.moe_plan(cfg))
    rplan = {k: (v.shape, v.axes, v.init) if hasattr(v, 'init')
             else {n: (s.shape, s.axes, s.init) for n, s in v.items()}
             for k, v in RMoE.moe_plan(rcfg).items()}
    assert plan == rplan
    assert ('shared' in plan) == bool(cfg.num_shared_experts)


@pytest.mark.parametrize('tokens, cf', [(1, 1.25), (16, 1.25), (16, 1.0), (37, 8.0),
                                        (2048, 1.25), (2112, 1.7)])
@pytest.mark.parametrize('arch', ARCHS)
def test_capacity(arch, tokens, cf):
    cfg, rcfg = _cfgs(arch, capacity_factor=cf)
    assert moe.capacity(tokens, cfg) == RMoE.capacity(tokens, rcfg)
    full, rfull = get_config(arch), ref_config(arch)
    full, rfull = (dataclasses.replace(c, capacity_factor=cf) for c in (full, rfull))
    assert moe.capacity(tokens, full) == RMoE.capacity(tokens, rfull)


@pytest.mark.parametrize('arch', ARCHS)
def test_route(arch):
    cfg, rcfg = _cfgs(arch)
    p, rp = _params(cfg)
    x = _x(cfg)
    gates, idx, probs = moe.route(p['router'], torch.as_tensor(x), cfg)
    rgates, ridx, rprobs = RMoE.route(rp['router'], jnp.asarray(x), rcfg)
    _assert_no_near_tie(rprobs, cfg.top_k)
    assert gates.dtype == probs.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _close(probs, rprobs, atol=1e-6)
    _close(gates, rgates, atol=1e-6)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


# (T, K, E, C): no drop; drops; every pair on one expert; one slot each
DISPATCH = [(32, 2, 4, 16), (32, 2, 4, 8), (12, 3, 5, 3), (9, 1, 1, 4), (40, 6, 16, 1)]


@pytest.mark.parametrize('T, K, E, C', DISPATCH, ids=lambda v: str(v))
def test_dispatch_indices_are_the_references(T, K, E, C):
    """Bitwise on the same idx (distinct experts within a token, as
    top-k gives, where E >= K), per row and batched over rows."""
    rng = np.random.default_rng(T * 7 + E)
    idx = np.stack([np.stack([rng.permutation(E)[:K] if E >= K else rng.integers(0, E, K)
                              for _ in range(T)]) for _ in range(3)]).astype(np.int32)
    got = [moe._dispatch_indices(torch.as_tensor(idx), E, C)]
    for b in range(3):
        want = RMoE._dispatch_indices(jnp.asarray(idx[b]), E, C)
        row = moe._dispatch_indices(torch.as_tensor(idx[b]), E, C)
        for a, w, g in zip(row, want, got[0]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    order, dest, keep = (t.numpy() for t in got[0][:3])
    counts = np.stack([np.bincount(idx[b].reshape(-1), minlength=E) for b in range(3)])
    assert (keep.sum(-1) == np.minimum(counts, C).sum(-1)).all()
    assert (dest[~keep] == E * C).all()


@pytest.mark.parametrize('shared', [False, True], ids=['routed', 'shared'])
@pytest.mark.parametrize('cf', [8.0, 1.0], ids=['no_drop', 'drop'])
@pytest.mark.parametrize('arch', ARCHS)
def test_moe_apply(arch, cf, shared):
    """Output and aux loss against the reference's; at cf 1.0 some pairs
    drop (counted), at cf 8 none."""
    cfg, rcfg = _cfgs(arch, capacity_factor=cf,
                      num_shared_experts=1 if shared else 0)
    p, rp = _params(cfg)
    assert ('shared' in p) == shared
    x = _x(cfg, S=32)
    y, aux = moe.moe_apply(p, cfg, torch.as_tensor(x))
    ry, raux = RMoE.moe_apply(rp, rcfg, jnp.asarray(x))
    _, ridx, rprobs = RMoE.route(rp['router'], jnp.asarray(x), rcfg)
    _assert_no_near_tie(rprobs, cfg.top_k)
    C = moe.capacity(32, cfg)
    keep = moe._dispatch_indices(torch.as_tensor(np.array(ridx)), cfg.num_experts, C)[2]
    dropped = int((~keep).sum())
    assert (dropped > 0) == (cf == 1.0)
    assert y.shape == x.shape and y.dtype == torch.float32
    _close(y, ry)
    _close(aux, raux)
    assert float(aux) > 0.5                  # the load-balance loss is O(1)


def test_no_drop_equals_the_dense_mixture():
    """With capacity for every pair, the scatter dispatch equals the
    gate-weighted mixture of every expert's output (the reference's
    ``test_moe_no_drop_equals_dense``, in the port)."""
    cfg, _ = _cfgs('dbrx-132b', capacity_factor=8.0)
    p, _ = _params(cfg)
    x = torch.as_tensor(_x(cfg))
    y, _ = moe.moe_apply(p, cfg, x)
    gates, idx, _ = moe.route(p['router'], x, cfg)
    dense = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        g, u = torch.chunk(x @ p['wi'][e], 2, dim=-1)
        w_e = torch.where(idx == e, gates, 0.0).sum(-1)
        dense += ((torch.nn.functional.silu(g) * u) @ p['wo'][e]) * w_e[..., None]
    _close(y, dense.numpy(), atol=1e-5)


def test_dropped_pairs_contribute_nothing():
    """At capacity 1 slot an expert only each expert's first pair in
    token order counts: the output is the mixture over the kept pairs."""
    cfg, _ = _cfgs('dbrx-132b', capacity_factor=0.01)
    p, _ = _params(cfg)
    x = torch.as_tensor(_x(cfg, B=1, S=16))
    assert moe.capacity(16, cfg) == cfg.top_k
    y, _ = moe.moe_apply(p, cfg, x)
    gates, idx, _ = moe.route(p['router'], x, cfg)
    seen = {}
    want = torch.zeros_like(x)
    for t in range(16):
        for k in range(cfg.top_k):
            e = int(idx[0, t, k])
            if seen.get(e, 0) >= cfg.top_k:
                continue
            seen[e] = seen.get(e, 0) + 1
            g, u = torch.chunk(x[0, t] @ p['wi'][e], 2, dim=-1)
            want[0, t] += ((torch.nn.functional.silu(g) * u) @ p['wo'][e]) * gates[0, t, k]
    assert sum(seen.values()) < 16 * cfg.top_k
    _close(y, want.numpy(), atol=1e-5)


def test_aux_loss_of_a_given_routing():
    """E * sum_e frac_e * mean_prob_e on hand-made routing: uniform
    probabilities give exactly 1 whatever the assignment."""
    cfg, rcfg = _cfgs('deepseek-v2-236b')
    E, K = cfg.num_experts, cfg.top_k
    idx = np.random.default_rng(3).integers(0, E, (2, 5, K)).astype(np.int32)
    probs = np.random.default_rng(4).dirichlet(np.ones(E), (2, 5)).astype(np.float32)
    got = moe.aux_loss(torch.as_tensor(idx), torch.as_tensor(probs), cfg)
    onehot = np.eye(E, dtype=np.float32)[idx]
    frac = onehot.sum(2).mean((0, 1)) / K
    _close(got, E * np.sum(frac * probs.mean((0, 1))), atol=1e-6)
    flat = torch.full((2, 5, E), 1.0 / E)
    assert abs(float(moe.aux_loss(torch.as_tensor(idx), flat, cfg)) - 1.0) < 1e-6


def test_bf16_products_keep_bf16():
    """bf16 parameters and activations: the output is bf16, within bf16
    rounding of the fp32 computation on the same (rounded) values."""
    cfg, _ = _cfgs('deepseek-v2-236b', capacity_factor=8.0)
    p, _ = _params(cfg)
    p16 = tree_map(lambda t: t.bfloat16(), p)
    x16 = torch.as_tensor(_x(cfg)).bfloat16()
    y16, aux16 = moe.moe_apply(p16, cfg, x16)
    y32, aux32 = moe.moe_apply(tree_map(lambda t: t.float(), p16), cfg, x16.float())
    assert y16.dtype == torch.bfloat16 and aux16.dtype == torch.float32
    rl2 = float(torch.linalg.vector_norm(y16.float() - y32) / torch.linalg.vector_norm(y32))
    assert rl2 < 2e-2
