"""The port's schedule, AdamW and synthetic data against the reference's
(``repro.train``, ``repro.data``) on the CPU.

* ``warmup_cosine``: equal to the reference's float32 value at every
  step checked (both are the same float32 operations).
* ``adamw_update``: from the same state and gradients (numpy, seeded),
  three steps with clipping on and off, fp32 and bf16 parameters. The
  master, moments and grad norm within relative L2 1e-6 and max abs
  1e-6 of their largest magnitude (fp32; the order of a few products
  and the sum of squares' tree differ); bf16 parameters equal the
  reference's cast of the master up to one bf16 ulp (a master within
  fp32 rounding of the reference's can round to the neighbouring bf16).
  The step counter and leaf order are the reference's exactly.
* ``SyntheticLM.batch_at``: bitwise, in tokens, embeds and mrope modes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as RefSyntheticLM
from repro.train import optim as RO
from repro.train.schedule import warmup_cosine as ref_warmup_cosine
from repro_torch.data import SyntheticLM, shard_batch
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import optim as O
from repro_torch.train.schedule import warmup_cosine
from repro_torch.weights import opt_from_reference, opt_to_reference, params_from_reference

REL = 1e-6


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    rl2 = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rel * scale and rl2 <= rel, f'max abs {err:.3e}, rel L2 {rl2:.3e}'


@pytest.mark.parametrize('warmup, total', [(5, 100), (0, 10), (100, 10_000)])
def test_warmup_cosine_matches_reference(warmup, total):
    for step in (0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total,
                 total + 7):
        if step < 0:
            continue
        want = float(ref_warmup_cosine(jnp.int32(step), peak_lr=3e-4, warmup_steps=warmup,
                                       total_steps=total))
        assert warmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup,
                             total_steps=total) == want


def _tree(rng, scale=1.0):
    return {'blocks': {'0_attn': {'wq': {'w': rng.standard_normal((2, 8, 12)) * scale}},
                       'norm': {'scale': rng.standard_normal((2, 8)) * scale}},
            'embed': {'table': rng.standard_normal((16, 8)) * scale},
            'head': {'w': rng.standard_normal((8, 16)) * scale}}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('clip', [1.0, None])
def test_adamw_update_matches_reference(dtype, clip):
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'float32' else torch.bfloat16
    rparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(rng))
    ropt = RO.adamw_init(rparams)
    opt = opt_from_reference(jax.tree.map(np.asarray, ropt), device='cpu')
    params = params_from_reference(jax.tree.map(np.asarray, rparams), device='cpu')
    assert tree_map(lambda t: t.dtype, params) == tree_map(lambda _: tdt, params)
    assert opt['step'].device.type == 'cpu' and opt['step'].dtype == torch.int32
    for i in range(3):
        # gradients large enough (x3) that clipping at 1.0 engages
        g = jax.tree.map(lambda a: np.asarray(a, np.float32).astype(
            np.float32 if dtype == 'float32' else jnp.bfloat16), _tree(rng, 3.0))
        lr = warmup_cosine(i, peak_lr=1e-2, warmup_steps=2, total_steps=10)
        rparams, ropt, rn = RO.adamw_update(jax.tree.map(jnp.asarray, g), ropt, lr=lr,
                                            grad_clip=clip, param_dtype=jdt)
        params, opt, gn = O.adamw_update(params_from_reference(g, device='cpu'), opt,
                                         lr=lr, grad_clip=clip, param_dtype=tdt,
                                         params=params)
        _close(gn.numpy(), np.asarray(rn))
        if clip is not None:
            assert float(rn) > clip          # the clip engaged
    want = jax.tree.map(np.asarray, ropt)
    got = opt_to_reference(opt)
    assert int(got['step']) == int(want['step']) == 3
    for k in ('master', 'm', 'v'):
        for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
            _close(a, b)
    for a, b in zip(tree_leaves(params), jax.tree.leaves(rparams)):
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        ulp = np.abs(b) * (2.0 ** -7 if dtype == 'bfloat16' else 2.0 ** -22)
        assert np.all(np.abs(a - b) <= ulp + 1e-30), np.abs(a - b).max()


def test_adamw_leaves_the_gradients_and_returns_fresh_params_without_params():
    params = {'a': torch.ones(3), 'b': {'c': torch.full((2,), 2.0)}}
    opt = O.adamw_init(params)
    assert opt['master']['a'] is not params['a']
    assert opt['master']['a'].data_ptr() != params['a'].data_ptr()
    grads = {'a': torch.full((3,), 0.5), 'b': {'c': torch.ones(2)}}
    g0 = tree_map(torch.clone, grads)
    new, opt, _ = O.adamw_update(grads, opt, lr=0.1, param_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(g0)))
    assert torch.equal(params['a'], torch.ones(3))         # not written
    assert new['a'].data_ptr() != opt['master']['a'].data_ptr()
    assert torch.equal(new['a'], opt['master']['a'])
    abstract = O.abstract_opt(tree_map(lambda t: t.to('meta'), params))
    assert [t.shape for t in tree_leaves(abstract)] == [t.shape for t in tree_leaves(opt)]
    assert O.opt_axes({'a': ('x',)}) == RO.opt_axes({'a': ('x',)})


@pytest.mark.parametrize('mode', ['tokens', 'embeds', 'mrope'])
def test_synthetic_lm_is_the_reference_bitwise(mode):
    kw = dict(vocab_size=97, seq_len=24, global_batch=3, seed=5)
    if mode == 'embeds':
        kw.update(input_mode='embeds', d_model=8)
    if mode == 'mrope':
        kw.update(mrope=True)
    ours, ref = SyntheticLM(**kw), RefSyntheticLM(**kw)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (mode, step, k)
    placed = shard_batch(ours.batch_at(0), torch.device('cpu'),
                         dtype_map={'labels': torch.int64})
    assert placed['labels'].dtype == torch.int64
    it = iter(ours)
    assert next(it)['labels'].tobytes() == ref.batch_at(0)['labels'].tobytes()
