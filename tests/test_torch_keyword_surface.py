"""The keyword surface of ported functions against the reference's, on
one rank (the CPU's plain versions):

* ``make_fft1d_large(natural_order=False)``, the reference's default: the
  factor-transposed D (n1/p, n2), for both ``fused`` values, forward and
  inverse, within 1e-6 relative L2 of the reference (the tolerance of
  ``tests/test_torch_large1d.py``) and against numpy; the cost model
  prices the swaps the plan runs (two, or three with ``natural_order``);
* ``fft_four_step(factors=)`` and ``fft_matmul_plain(factors=)`` /
  ``fft_matmul(factors=)`` at n = 256 with (64, 4) and (4, 64), within
  1e-5 max abs of the reference's, ``ValueError`` on (3, 64);
* ``rfft_pencil(dtype=torch.float16)`` against the reference's with
  ``jnp.float16``: both cast the input and pack in fp16, around the same
  float64 DFT, so they agree to fp16 rounding (1e-3 relative);
* ``gqa_decode(window=)`` against the reference's at window 0 and at a
  window shorter than ``cache_len``, at ``tests/test_torch_lm_attention.py``'s
  block tolerance (max abs 1e-5, relative L2 1e-6).

The multi-rank cases (gloo 2 x 2 and 1 x 4) are the ``unfused`` suite of
``tests/_torch_multirank_worker.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.core import fft1d as rfft1d
from repro.fft import large1d as rlarge1d
from repro.kernels import fft_matmul as rmatmul
from repro.models import attention as RA
from repro_torch.comm import cost as tcost
from repro_torch.comm import strategies
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import fft1d as tfft1d
from repro_torch.fft import large1d as tlarge1d
from repro_torch.kernels import fft_matmul as tmatmul
from repro_torch.launch.mesh import make_fft_mesh
from repro_torch.models import attention as A
from repro_torch.models.layers import init_from_plan
from repro_torch.weights import params_to_reference

RTOL = 1e-6
RNG = np.random.default_rng(31)


@pytest.fixture(scope='module')
def meshes():
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('x', 'y'))
    return jmesh, make_fft_mesh(1, 1, device='cpu')


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# make_fft1d_large(natural_order=False)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'unfused'])
@pytest.mark.parametrize('method', ['stockham', 'four_step'])
def test_make_fft1d_large_factor_order(meshes, method, fused):
    """The default returns D[j1, j2] = y[j1 + n1*j2] on the (n1, n2)
    view; its inverse maps D back. n = 64 x 32 (not square)."""
    jmesh, tmesh = meshes
    n1, n2 = 64, 32
    x = (RNG.standard_normal((n1, n2)) + 1j * RNG.standard_normal((n1, n2))).astype(np.complex64)
    kw = dict(method=method, kernel='reference', fused=fused)
    jr, ji = jax.jit(rlarge1d.make_fft1d_large(n1, n2, jmesh, ('x', 'y'), **kw))(
        jnp.asarray(x.real), jnp.asarray(x.imag))
    tr, ti = tlarge1d.make_fft1d_large(n1, n2, tmesh, ('x', 'y'), **kw)(
        torch.as_tensor(x.real[None]), torch.as_tensor(x.imag[None]))
    got = tr[0].numpy() + 1j * ti[0].numpy()
    assert got.shape == (n1, n2)
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) <= RTOL
    want = np.fft.fft(x.reshape(-1).astype(np.complex128)).reshape(n2, n1).T
    assert _rel(got, want) <= RTOL
    # the inverse on the same view: D read as A, its inverse in D-form
    ir, ii = tlarge1d.make_fft1d_large(n1, n2, tmesh, ('x', 'y'), inverse=True, **kw)(tr, ti)
    jir, jii = jax.jit(rlarge1d.make_fft1d_large(n1, n2, jmesh, ('x', 'y'), inverse=True,
                                                 **kw))(jr, ji)
    back = ir[0].numpy() + 1j * ii[0].numpy()
    assert _rel(back, np.asarray(jir) + 1j * np.asarray(jii)) <= RTOL
    want_back = np.fft.ifft(got.reshape(-1).astype(np.complex128)).reshape(n2, n1).T
    assert _rel(back, want_back) <= RTOL


@pytest.mark.parametrize('natural_order', [False, True])
@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'unfused'])
def test_cost_prices_the_swaps_the_plan_runs(meshes, monkeypatch, natural_order, fused):
    _, tmesh = meshes
    started = []
    real_start = strategies.swap_start_wire
    monkeypatch.setattr(strategies, 'swap_start_wire',
                        lambda *a, **k: started.append(1) or real_start(*a, **k))
    x = torch.as_tensor(RNG.standard_normal((1, 32, 16)).astype(np.float32))
    tlarge1d.make_fft1d_large(32, 16, tmesh, ('x', 'y'), natural_order=natural_order,
                              fused=fused, kernel='reference')(x, x)
    cost = tcost.large1d_plan_cost(32, 16, ('x', 'y'), {'x': 1, 'y': 1},
                                   natural_order=natural_order, measured=None)
    swaps = sum(s.kind == 'swap' for s in cost.steps)
    assert swaps == (3 if natural_order else 2)
    assert len(started) == 2 * swaps            # a planar pair: two arrays a swap


# ---------------------------------------------------------------------------
# factors= of the four-step and of fft_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('factors', [(64, 4), (4, 64)], ids=['64x4', '4x64'])
def test_four_step_factors(factors):
    re, im = (RNG.standard_normal((3, 256)).astype(np.float32) for _ in range(2))
    want = rfft1d.fft_four_step(jnp.asarray(re), jnp.asarray(im), factors=factors)
    want_k = rmatmul.fft_matmul(jnp.asarray(re), jnp.asarray(im), factors=factors)
    t = (torch.as_tensor(re), torch.as_tensor(im))
    for got, ref in ((tfft1d.fft_four_step(*t, factors=factors), want),
                     (tmatmul.fft_matmul_plain(*t, factors=factors), want_k),
                     (tmatmul.fft_matmul(*t, factors=factors), want_k)):
        for g, w in zip(got, ref):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5
    exact = np.fft.fft(re.astype(np.float64) + 1j * im)
    got = tmatmul.fft_matmul(*t, factors=factors)
    assert np.abs(got[0].numpy() + 1j * got[1].numpy() - exact).max() <= 1e-4


def test_foreign_factors_raise():
    t = torch.zeros(2, 256), torch.zeros(2, 256)
    for fn in (tfft1d.fft_four_step, tmatmul.fft_matmul_plain, tmatmul.fft_matmul):
        with pytest.raises(ValueError):
            fn(*t, factors=(3, 64))
    with pytest.raises(ValueError):
        rfft1d.fft_four_step(jnp.zeros((2, 256)), jnp.zeros((2, 256)), factors=(3, 64))


# ---------------------------------------------------------------------------
# rfft_pencil(dtype=)
# ---------------------------------------------------------------------------

def _cfft_np(to_arr, dtype_of):
    """A forward complex FFT in float64 through numpy, its result in the
    operand's dtype: the same DFT under both packages' pack."""
    def cfft(r, i):
        z = np.fft.fft(np.asarray(r, np.float64) + 1j * np.asarray(i, np.float64), axis=-1)
        return to_arr(z.real, dtype_of(r)), to_arr(z.imag, dtype_of(r))
    return cfft


def test_rfft_pencil_dtype():
    x = RNG.standard_normal((4, 128)).astype(np.float32)
    jr, ji = rfft1d.rfft_pencil(jnp.asarray(x), dtype=jnp.float16,
                                cfft=_cfft_np(jnp.asarray, lambda a: a.dtype))
    tr, ti = tfft1d.rfft_pencil(torch.as_tensor(x), dtype=torch.float16,
                                cfft=_cfft_np(lambda a, dt: torch.as_tensor(a).to(dt),
                                              lambda a: a.dtype))
    assert jr.dtype == jnp.float16 and tr.dtype == torch.float16 and ti.dtype == torch.float16
    got = tr.float().numpy() + 1j * ti.float().numpy()
    want = np.asarray(jr, np.float32) + 1j * np.asarray(ji, np.float32)
    assert _rel(got, want) <= 1e-3
    assert _rel(got, np.fft.rfft(x.astype(np.float16).astype(np.float64))) <= 2e-3


# ---------------------------------------------------------------------------
# gqa_decode(window=)
# ---------------------------------------------------------------------------

def _close(got, want, atol=1e-5, rel=1e-6):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    rl2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= atol and rl2 <= rel, f'max abs {err:.3e}, rel L2 {rl2:.3e}'


@pytest.mark.parametrize('window', [0, 6])
def test_gqa_decode_window(window):
    """Decode at ``cache_len`` 20 over a dense cache of 32: window 0 sees
    all 21 keys, window 6 the last 6; the cache is written in place."""
    cfg = smoke_config(get_config('internlm2-1.8b'))
    rcfg = ref_smoke(ref_config(cfg.name))
    gen = torch.Generator().manual_seed(7)
    p = init_from_plan(gen, A.gqa_plan(cfg), torch.float32)
    rp = {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params_to_reference(p).items()}
    rng = np.random.default_rng(8)
    ck, cv = (rng.standard_normal((2, 32, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    rout, rk, rv = RA.gqa_decode(rp, rcfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                 jnp.int32(20), window=window)
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    out, k2, v2 = A.gqa_decode(p, cfg, torch.as_tensor(x), tk, tv, 20, window=window)
    assert k2 is tk and v2 is tv
    _close(out, rout)
    _close(tk, rk)
    _close(tv, rv)
    if window:
        full, _, _ = A.gqa_decode(p, cfg, torch.as_tensor(x), torch.as_tensor(ck.copy()),
                                  torch.as_tensor(cv.copy()), 20)
        assert not torch.allclose(out, full)
