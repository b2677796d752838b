"""Gradients of the port's ``loss_fn`` against ``jax.value_and_grad`` of
the reference's (``repro.models.model.loss_fn``), and the FFT-conv
mixer's adjoint (``repro_torch.models.ssd._FFTConv``), on the CPU.

Models at smoke size: internlm2-1.8b (GQA attention + gated MLP),
mamba2-1.3b (SSD) and the FFT-conv LM (mamba2-1.3b with
``block_pattern=('fftconv',)``, ``examples/fftconv_lm.py``'s model), each
with remat off and on. The port's parameters (a seeded
``torch.Generator``) go to the reference through ``weights``; tokens
and labels are numpy from a seed. The reference runs with
``mesh=None`` (its fftconv mesh path cannot run on jax 0.9: ``plan_op``
reaches ``jax.core.trace_state_clean``); the port's fftconv model also
runs on a CPU 1 x 1 mesh, through its ``plan_op`` plans.

Tolerances (fp32): the loss within 1e-5 absolute; each gradient leaf
within relative L2 1e-5 (measured about 4e-7). ``_FFTConv`` against
jax's gradient and against autograd through the plain tier: relative
L2 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fft as rfft
from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.fft import methods as rfftm
from repro.models import model as RM
from repro_torch import fft
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import ssd
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.weights import params_to_reference

REL = 1e-5
CASES = ['internlm2-1.8b', 'mamba2-1.3b', 'fftconv', 'fftconv-mesh']


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Smoke-size steps are launch-bound; two threads a test worker keep
    the parallel suite from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _configs(case: str, remat: bool):
    arch = 'mamba2-1.3b' if case.startswith('fftconv') else case
    cfg, rcfg = smoke_config(get_config(arch)), ref_smoke(ref_config(arch))
    kw = dict(remat=remat)
    if case.startswith('fftconv'):
        kw.update(block_pattern=('fftconv',))
    return dataclasses.replace(cfg, **kw), dataclasses.replace(rcfg, **kw)


def _batch(cfg, seed=1, B=2, S=32):
    rng = np.random.default_rng(seed)
    return {'tokens': rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            'labels': rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def port_grads(params, cfg, batch, mesh=None):
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = M.loss_fn(live, cfg, {k: torch.as_tensor(v) for k, v in batch.items()},
                        mesh=mesh)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss.detach()), [g.numpy() for g in grads]


def ref_grads(params, rcfg, batch):
    rp = tree_map(jnp.asarray, params_to_reference(params))
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b), has_aux=True))
    (loss, _), g = fn(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(g)]


@pytest.mark.parametrize('remat', [False, True], ids=['plain', 'remat'])
@pytest.mark.parametrize('case', CASES)
def test_loss_gradients_match_reference(case, remat):
    cfg, rcfg = _configs(case, remat)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    batch = _batch(cfg)
    mesh = make_host_mesh(1, 1, device='cpu') if case.endswith('-mesh') else None
    loss, grads = port_grads(params, cfg, batch, mesh)
    rloss, rgrads = ref_grads(params, rcfg, batch)
    assert abs(loss - rloss) <= 1e-5, (loss, rloss)
    assert len(grads) == len(rgrads)
    for i, (g, r) in enumerate(zip(grads, rgrads)):
        assert np.abs(r).max() > 0, i
        assert _rel(g, r) <= REL, (i, g.shape, _rel(g, r))


@pytest.mark.parametrize('remat', [False, True], ids=['plain', 'remat'])
def test_remat_recomputes_each_period_and_not_the_tail(monkeypatch, remat):
    """With remat each stacked layer's mixer runs twice a step (forward
    and the recompute in the backward), the unrolled tail's once."""
    cfg, _ = _configs('fftconv', remat)
    cfg = dataclasses.replace(cfg, block_pattern=('fftconv', 'fftconv'), num_layers=5)
    calls = []
    real = ssd.fftconv_apply
    monkeypatch.setattr(ssd, 'fftconv_apply', lambda *a, **k: calls.append(1) or real(*a, **k))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    port_grads(params, cfg, _batch(cfg, S=16))
    n_periods, n_tail = M.split_layers(cfg)
    assert (n_periods, n_tail) == (2, 1)
    assert len(calls) == (2 if remat else 1) * 2 * n_periods + n_tail


def _ref_conv(hr, kr):
    hre, him = rfftm.apply_real(hr, method='four_step')
    kre, kim = rfftm.apply_real(kr, method='four_step')
    yre, yim = rfft.spectral_mul(hre, him, (kre, kim))
    return rfftm.apply_real(yre, yim, inverse=True, method='four_step')


@pytest.mark.parametrize('n', [64, 256])
def test_fftconv_adjoint_through_plan_op(n):
    """``_FFTConv`` on the runtime plans of a CPU 1 x 1 mesh: its forward
    equals the plan's apply bit for bit, and its gradients of hr and kr
    match jax.grad of the reference's local conv and autograd through
    the plan itself (the plain tier differentiates)."""
    rng = np.random.default_rng(n)
    hr = rng.standard_normal((3, 4, n)).astype(np.float32)
    kr = rng.standard_normal((4, n)).astype(np.float32)
    w = rng.standard_normal((3, 4, n)).astype(np.float32)
    mesh = make_host_mesh(1, 1, device='cpu')
    axes = ssd._pick_axes(mesh, n)
    conv = ssd._fftconv_runtime_plan(n, mesh, axes, False)
    adj = ssd._fftconv_runtime_plan(n, mesh, axes, True)
    assert ssd._fftconv_runtime_plan(n, mesh, axes, True) is adj
    th, tk = (torch.tensor(a, requires_grad=True) for a in (hr, kr))
    y = ssd._FFTConv.apply(th, tk, conv.apply, adj.apply)
    with torch.no_grad():
        assert torch.equal(y, conv.apply(th, tk))
    gh, gk = torch.autograd.grad((y * torch.as_tensor(w)).sum(), (th, tk))
    rh, rk = jax.grad(lambda a, b: jnp.sum(jnp.asarray(w) * _ref_conv(a, b)),
                      argnums=(0, 1))(jnp.asarray(hr), jnp.asarray(kr))
    assert _rel(gh.numpy(), rh) <= REL and _rel(gk.numpy(), rk) <= REL
    ph, pk = (torch.tensor(a, requires_grad=True) for a in (hr, kr))
    plain = fft.plan_op((n,), mesh, op=fft.spectral_mul, real=True, n_spectra=1,
                        mesh_axes=axes, kernel='reference')
    ah, ak = torch.autograd.grad((plain.apply(ph, pk) * torch.as_tensor(w)).sum(), (ph, pk))
    assert _rel(gh.numpy(), ah.numpy()) <= REL and _rel(gk.numpy(), ak.numpy()) <= REL


def test_baked_spectrum_rebakes_after_an_in_place_update():
    """Eval forwards bake each layer's kernel spectrum once; an in-place
    parameter update (what AdamW does) re-bakes, and the result is the
    runtime plan's on the updated kernel."""
    cfg, _ = _configs('fftconv', False)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    mesh = make_host_mesh(1, 1, device='cpu')
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)),
                        dtype=torch.float32)
    p = M._layer(params['blocks'], 0)['0_fftconv']['fftconv']
    ssd._fftconv_plans.clear()
    with torch.no_grad():
        y0 = ssd.fftconv_apply(p, cfg, x, mesh=mesh)
        (pl,) = [e[2] for k, e in ssd._fftconv_plans.items() if k[0] == 'baked']
        assert pl.bake_count == 1
        p2 = M._layer(params['blocks'], 0)['0_fftconv']['fftconv']   # fresh views
        assert torch.equal(ssd.fftconv_apply(p2, cfg, x, mesh=mesh), y0)
        assert pl.bake_count == 1
        params['blocks']['0_fftconv']['fftconv']['kernel'].mul_(0.5)
        y1 = ssd.fftconv_apply(p2, cfg, x, mesh=mesh)
    (pl2,) = [e[2] for k, e in ssd._fftconv_plans.items() if k[0] == 'baked']
    assert pl2 is not pl and pl2.bake_count == 1
    live = tree_map(lambda t: t.detach().requires_grad_(), p2)
    want = ssd.fftconv_apply(live, cfg, x, mesh=mesh)     # the runtime (traced) plan
    assert not torch.equal(y1, y0)
    assert _rel(y1.numpy(), want.detach().numpy()) <= REL
    del params, p, p2, live, pl, pl2
    import gc
    gc.collect()
    with torch.no_grad():            # a freed model's entry goes at the next bake
        fresh = M.init_params(torch.Generator().manual_seed(1), cfg, torch.float32)
        ssd.fftconv_apply(M._layer(fresh['blocks'], 0)['0_fftconv']['fftconv'], cfg, x,
                          mesh=mesh)
    assert len([k for k in ssd._fftconv_plans if k[0] == 'baked']) == 1


def test_fftconv_forward_and_prefill_match_reference():
    """The FFT-conv LM without grad: forward logits and prefill's last
    logits against the reference's (``mesh=None``), within 1e-5 relative
    L2; prefill keeps no cache for the mixer, as the reference's, and
    the cache plan has none either."""
    cfg, rcfg = _configs('fftconv', False)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    rp = tree_map(jnp.asarray, params_to_reference(params))
    tokens = _batch(cfg)['tokens']
    with torch.no_grad():
        logits, _ = M.forward(params, cfg, {'tokens': torch.as_tensor(tokens)},
                              mesh=make_host_mesh(1, 1, device='cpu'))
        last, caches = M.prefill(params, cfg, {'tokens': torch.as_tensor(tokens)})
    rlogits, _ = RM.forward(rp, rcfg, {'tokens': jnp.asarray(tokens)})
    rlast, rcaches = RM.prefill(rp, rcfg, {'tokens': jnp.asarray(tokens)})
    assert _rel(logits.numpy(), rlogits) <= REL and _rel(last.numpy(), rlast) <= REL
    assert caches == {'blocks': {}} and jax.tree.leaves(rcaches) == []
    assert M.cache_plan(cfg, 2, 32) == {'blocks': {}}
