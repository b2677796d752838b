"""The port's model layers (``repro_torch.models.layers``) against the
reference's (``repro.models.layers``).

The same numpy inputs, drawn from a seed, go through the JAX function and
its port. Tolerances: max abs <= 1e-5 and relative L2 <= 1e-6 for fp32
(XLA contracts products into FMAs and orders its sums otherwise; eager
PyTorch rounds each product); bf16 results within one bf16 ulp of the
larger magnitude. Initializers: the port draws from a ``torch.Generator``,
the reference from ``jax.random``, so each init kind is held to its
distribution's statistics, not to the reference's values; a layer-stacked
linear weight takes the fan-in of its unstacked leaf (the reference takes
the layer count).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as L

RNG = np.random.default_rng(0)


def _np(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, *, atol=1e-5, rel=1e-6):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    rl2 = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= atol and rl2 <= rel, f'max abs {err:.3e}, rel L2 {rl2:.3e}'


T = torch.as_tensor
J = jnp.asarray


def test_rms_and_layer_norm():
    x, scale, bias = _np((3, 5, 64)), _np((64,)), _np((64,))
    _close(L.rms_norm(T(x), T(scale), 1e-6), RL.rms_norm(J(x), J(scale), 1e-6))
    _close(L.layer_norm(T(x), T(scale), T(bias), 1e-5),
           RL.layer_norm(J(x), J(scale), J(bias), 1e-5))
    p = {'scale': scale, 'bias': bias}
    _close(L.apply_norm({k: T(v) for k, v in p.items()}, T(x)),
           RL.apply_norm({k: J(v) for k, v in p.items()}, J(x)))


def test_norm_casts_before_the_scale_in_bf16():
    """(x * rsqrt).astype(dt) * scale.astype(dt): the product in bf16."""
    x, scale = _np((4, 32)), _np((32,))
    got = L.rms_norm(T(x).bfloat16(), T(scale), 1e-6)
    want = RL.rms_norm(J(x).astype(jnp.bfloat16), J(scale), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize('bias', [False, True])
def test_linear(bias):
    x, w, b = _np((2, 7, 48)), _np((48, 40), 0.1), _np((40,))
    got = L.linear(T(x), T(w), T(b) if bias else None)
    want = RL.linear(J(x), J(w), J(b) if bias else None)
    _close(got, want)
    p = {'w': T(w), 'b': T(b)} if bias else {'w': T(w)}
    _close(L.apply_linear(p, T(x)), want)


def test_linear_in_bf16_returns_bf16():
    x, w = _np((3, 64)), _np((64, 16), 0.1)
    got = L.linear(T(x).bfloat16(), T(w))
    want = RL.linear(J(x).astype(jnp.bfloat16), J(w))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, np.asarray(want, np.float32), atol=2 ** -7 * 4, rel=2 ** -7)


def test_embed_lookup_and_unembed():
    table = _np((256, 32))
    ids = RNG.integers(0, 256, (2, 9)).astype(np.int32)
    for dt in (torch.int32, torch.int64):
        _close(L.embed_lookup({'table': T(table)}, T(ids).to(dt)),
               RL.embed_lookup({'table': J(table)}, J(ids)), atol=0, rel=0)
    x = _np((2, 9, 32))
    got = L.unembed({'table': T(table)}, T(x))
    assert got.dtype == torch.float32
    _close(got, RL.unembed({'table': J(table)}, J(x)))


@pytest.mark.parametrize('theta', [1e4, 1e6])
def test_apply_rope(theta):
    x = _np((2, 11, 4, 16))
    pos = np.broadcast_to(np.arange(11) + 5, (2, 11)).astype(np.int32)
    _close(L.apply_rope(T(x), T(pos), theta=theta), RL.apply_rope(J(x), J(pos), theta=theta))
    np.testing.assert_array_equal(L.rope_freqs(16, theta), RL.rope_freqs(16, theta))


def test_apply_mrope():
    x = _np((2, 7, 3, 16))
    pos = RNG.integers(0, 50, (3, 2, 7)).astype(np.int32)
    _close(L.apply_mrope(T(x), T(pos), theta=1e6, sections=(2, 3, 3)),
           RL.apply_mrope(J(x), J(pos), theta=1e6, sections=(2, 3, 3)))
    with pytest.raises(ValueError, match='sections'):
        L.apply_mrope(T(x), T(pos), sections=(2, 3, 4))


@pytest.mark.parametrize('act', ['silu', 'gelu'])
@pytest.mark.parametrize('gated', [True, False])
def test_apply_mlp(act, gated):
    d, f = 32, 48
    p = {'wi': _np((d, 2 * f if gated else f), 0.2), 'wo': _np((f, d), 0.2)}
    x = _np((2, 5, d))
    _close(L.apply_mlp({k: T(v) for k, v in p.items()}, T(x), act=act),
           RL.apply_mlp({k: J(v) for k, v in p.items()}, J(x), act=act))
    with pytest.raises(ValueError):
        L._act(T(x), 'relu')


@pytest.mark.parametrize('masked', [False, True])
def test_softmax_xent(masked):
    logits = _np((3, 6, 50), 3.0)
    labels = RNG.integers(0, 50, (3, 6)).astype(np.int32)
    mask = (RNG.random((3, 6)) > 0.4).astype(np.float32) if masked else None
    got = L.softmax_xent(T(logits), T(labels), mask=None if mask is None else T(mask))
    want = RL.softmax_xent(J(logits), J(labels), mask=None if mask is None else J(mask))
    _close(got, want)


def test_plans_match_the_reference():
    """norm, linear, embed and MLP plans, and their stacking."""
    pairs = [(L.norm_plan(8, 'rms'), RL.norm_plan(8, 'rms')),
             (L.norm_plan(8, 'ln'), RL.norm_plan(8, 'ln')),
             (L.linear_plan(8, 4, ('embed', 'heads'), bias=True),
              RL.linear_plan(8, 4, ('embed', 'heads'), bias=True)),
             (L.embed_plan(10, 8), RL.embed_plan(10, 8)),
             (L.mlp_plan(8, 6), RL.mlp_plan(8, 6)),
             (L.mlp_plan(8, 6, gated=False), RL.mlp_plan(8, 6, gated=False))]
    pairs.append((L.stack_plans([pairs[-1][0]] * 3), RL.stack_plans([pairs[-1][1]] * 3)))
    for got, want in pairs:
        assert L.axes_from_plan(got) == RL.axes_from_plan(want)
        want = jax.tree.map(lambda p: (p.shape, p.axes, p.init), want, is_leaf=RL.is_pspec)
        assert L.tree_map(lambda p: (p.shape, p.axes, p.init), got) == want
        meta = L.abstract_from_plan(got, torch.float32)
        assert all(t.device.type == 'meta' for t in L.tree_leaves(meta))
    with pytest.raises(ValueError, match='stack'):
        L.stack_plans([L.norm_plan(8), L.norm_plan(9)])


N_INIT = 200_000


@pytest.mark.parametrize('kind', ['zeros', 'neg1', 'ones', 'emb', 'lin', 'lin1d', 'ssm_a',
                                  'ssm_dt'])
def test_init_kinds_have_the_reference_statistics(kind):
    """Each init kind against its distribution, and against the
    reference's draw of the same leaf (mean and spread within 2%)."""
    shape = {'lin': (50, N_INIT // 50), 'lin1d': (N_INIT,)}.get(kind, (N_INIT,))
    init = 'lin' if kind == 'lin1d' else kind
    gen = torch.Generator().manual_seed(1)
    got = L._init_leaf(gen, L.PSpec(shape, (None,) * len(shape), init), torch.float32)
    ref = np.asarray(RL._init_leaf(jax.random.PRNGKey(1),
                                   RL.PSpec(shape, (None,) * len(shape), init), jnp.float32))
    got = got.numpy().astype(np.float64)
    assert got.shape == shape and got.dtype == np.float64
    if init in ('zeros', 'neg1', 'ones'):
        np.testing.assert_array_equal(got, ref)
        return
    want = {'emb': (0.0, 0.02), 'lin': (0.0, 1 / math.sqrt(shape[0])),
            'ssm_a': ((math.log(16.0)) / 2, math.log(16.0) / math.sqrt(12))}.get(init)
    if want is not None:
        assert abs(got.mean() - want[0]) < 0.01 * want[1] + 1e-12
        assert abs(got.std() / want[1] - 1) < 0.01
    if init == 'ssm_a':
        assert got.min() >= 0 and got.max() <= math.log(16.0)
    if init == 'ssm_dt':             # softplus(bias) is log-uniform on [1e-3, 1e-1]
        dt = np.log1p(np.exp(got))
        assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
        lg = np.log(dt)
        assert abs(lg.mean() - (math.log(1e-3) + math.log(1e-1)) / 2) < 0.01
    assert abs(got.mean() - ref.mean()) <= 0.02 * max(ref.std(), 1e-3)
    assert abs(got.std() / ref.std() - 1) < 0.02


def test_init_from_plan_is_seeded_and_on_the_generators_device():
    plan = {'a': L.PSpec((4, 3), (None, None)), 'b': {'c': L.PSpec((5,), (None,), 'emb')}}
    p1 = L.init_from_plan(torch.Generator().manual_seed(3), plan, torch.float32)
    p2 = L.init_from_plan(torch.Generator().manual_seed(3), plan, torch.float32)
    for a, b in zip(L.tree_leaves(p1), L.tree_leaves(p2)):
        assert torch.equal(a, b) and a.device.type == 'cpu' and a.dtype == torch.float32
    p3 = L.init_from_plan(torch.Generator().manual_seed(3), plan, torch.bfloat16)
    assert p3['a'].dtype == torch.bfloat16


def test_stacked_linear_init_scales_by_the_input_width():
    """A layer-stacked (L, d_in, d_out) linear weight is drawn with scale
    1/sqrt(d_in), as its unstacked leaf is. The reference scales it by
    1/sqrt(L) (its fan-in is shape[0], the layer count): a deliberate
    difference, so the random full-width models stay conditioned."""
    L_, d_in, d_out = 4, 512, 100
    stacked = L.stack_plans([{'w': L.PSpec((d_in, d_out), (None, None))}] * L_)['w']
    got = L._init_leaf(torch.Generator().manual_seed(2), stacked, torch.float32)
    ref = np.asarray(RL._init_leaf(
        jax.random.PRNGKey(2), RL.stack_plans([{'w': RL.PSpec((d_in, d_out), (None, None))}]
                                              * L_)['w'], jnp.float32))
    assert got.shape == ref.shape == (L_, d_in, d_out)
    assert abs(float(got.std()) * math.sqrt(d_in) - 1) < 0.01
    assert abs(float(ref.std()) * math.sqrt(L_) - 1) < 0.01
