"""Port parity for the FFT surface that completes the port: the unfused
supersteps (``make_fft(fused=False)``, ``$REPRO_FUSE_SUPERSTEP``,
``make_fft1d_large(fused=False)``), ``fft3d``/``ifft3d``/``fft2d``/
``ifft2d``, the axis-general plain forms (``fft_four_step_axis``,
``methods._block_axis``, ``apply_block``), the deprecated ``fft1d`` shim
and ``METHODS``, and the planar helpers of ``core/twiddle.py``, on a
one-rank CPU mesh against the JAX package on a one-device Auto-axes
``jax.sharding.Mesh`` (the reference's executors under ``jax.jit``).

Tolerances:

* the port against itself, fused against unfused: bitwise
  (``torch.equal``). On the plain tier both run the same pencil function
  on the same pencils, the axis moved last either way;
* an axis form (``fft_four_step_axis``) against the last-axis form on
  the axis moved last: relative L2 <= 1e-6 in fp32 (the same products,
  their sums grouped by other matmul shapes), <= 1e-3 with a bf16
  compute type (a bf16 rounding of the first product may flip), as
  the port against the reference's bf16 plans;
* the port against the reference's executors: relative L2 <= 1e-6 (fp32
  pencil passes summed in other orders, and XLA's FMA contractions);
* a pencil form against ``np.fft`` in float64: max |err| <= 1e-5 of the
  largest magnitude;
* ``to_planar``/``from_planar``: exact; ``cmatmul``: relative 1e-6
  (four fp32 products, summed by different libraries).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fft1d as jf1
from repro.core import twiddle as jtw
from repro.core.plan import PencilPlan as JPencilPlan
from repro.fft import large1d as jlarge1d
from repro.fft import methods as jmethods
from repro.fft import pencil as jpencil
import repro_torch.fft as tfft
from repro_torch.core import _deprecated
from repro_torch.core import fft1d as tf1
from repro_torch.core import twiddle as ttw
from repro_torch.core.plan import PencilPlan as TPencilPlan
from repro_torch.fft import large1d as tlarge1d
from repro_torch.fft import methods as tmethods
from repro_torch.fft import pencil as tpencil
from repro_torch.launch.mesh import make_fft_mesh

EXEC_RTOL = 1e-6
NUMPY_RTOL = 1e-5
#: an axis form against the last-axis form with ``compute_dtype=bfloat16``
BF16_RTOL = 1e-3
RNG = np.random.default_rng(30)


@pytest.fixture(scope='module')
def meshes():
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('x', 'y'))
    return jmesh, make_fft_mesh(1, 1, device='cpu')


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _same(a, b):
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _np(t):
    if isinstance(t, tuple):
        return np.stack([x.numpy() for x in t])
    return t.numpy()


def _jnp(t):
    if isinstance(t, tuple):
        return np.stack([np.asarray(x) for x in t])
    return np.asarray(t)


def _operands(shape, real):
    if real:
        return (RNG.standard_normal(shape).astype(np.float32),)
    return tuple(RNG.standard_normal(shape).astype(np.float32) for _ in range(2))


# ---------------------------------------------------------------------------
# make_fft(fused=False), ranks 2 and 3
# ---------------------------------------------------------------------------

UNFUSED = [(method, real, shape) for method in ('stockham', 'four_step', 'block')
           for real in (False, True) for shape in ((8, 16, 32), (16, 32))]


@pytest.mark.parametrize("method, real, shape", UNFUSED,
                         ids=[f"{m}-{'real' if r else 'cplx'}-{'x'.join(map(str, s))}"
                              for m, r, s in UNFUSED])
def test_make_fft_unfused(meshes, method, real, shape):
    """``make_fft(fused=False)`` forward and inverse on a batch of 2:
    bitwise equal to ``fused=True`` on the plain tier, and within
    EXEC_RTOL of the reference's ``make_fft(fused=False)``."""
    jmesh, tmesh = meshes
    layout = ('x', 'y', None)[-len(shape):] if len(shape) == 3 else ('x', None)
    kw = dict(shape=shape, layout=layout, real=real, method=method, kernel='reference',
              comm='all_to_all')
    tplan, jplan = TPencilPlan(mesh=tmesh, **kw), JPencilPlan(mesh=jmesh, **kw)
    x = _operands((2,) + shape, real)
    xt = tuple(torch.as_tensor(a) for a in x)
    got = {}
    for fused in (True, False):
        fwd, _, _ = tpencil.make_fft(tplan, fused=fused)
        inv, _, _ = tpencil.make_fft(tplan, inverse=True, fused=fused)
        y = fwd(*xt)
        got[fused] = (y, inv(*y))
    assert _same(got[True][0], got[False][0]) and _same(got[True][1], got[False][1])
    jfwd, _, _ = jpencil.make_fft(jplan, batch=True, fused=False)
    jinv, _, _ = jpencil.make_fft(jplan, inverse=True, batch=True, fused=False)
    jy = jax.jit(jfwd)(*(jnp.asarray(a) for a in x))
    jx = jax.jit(jinv)(*jy)
    assert _rel_l2(_np(got[False][0]), _jnp(jy)) <= EXEC_RTOL
    assert _rel_l2(_np(got[False][1]), _jnp(jx)) <= EXEC_RTOL


@pytest.mark.parametrize("value", ['', '0', 'false', 'no', 'FALSE', '1', 'yes', 'on'])
def test_default_fused_reads_the_environment(monkeypatch, value):
    monkeypatch.setenv(tpencil.FUSE_ENV, value)
    assert tpencil.FUSE_ENV == jpencil.FUSE_ENV == 'REPRO_FUSE_SUPERSTEP'
    assert tpencil.default_fused() == jpencil.default_fused()
    monkeypatch.delenv(tpencil.FUSE_ENV)
    assert tpencil.default_fused() is True


def test_facade_reads_the_environment_when_it_builds(monkeypatch, meshes):
    """A plan built under ``REPRO_FUSE_SUPERSTEP=0`` runs the unfused
    supersteps (bitwise ``make_fft(fused=False)``'s); rank-2/3 and rank-1
    plans, complex and real, stay bitwise equal to the fused default."""
    _, tmesh = meshes
    x3 = RNG.standard_normal((2, 16, 16, 16)) + 1j * RNG.standard_normal((2, 16, 16, 16))
    x3 = torch.as_tensor(x3.astype(np.complex64))
    x1 = torch.as_tensor(RNG.standard_normal((2, 4096)).astype(np.float32))
    cases = [(tfft.plan, (16, 16, 16), x3, 'four_step'), (tfft.plan, (16, 16, 16), x3, 'block'),
             (tfft.plan, (4096,), x1.to(torch.complex64), 'four_step'),
             (tfft.plan, (4096,), x1.to(torch.complex64), 'stockham'),
             (tfft.rplan, (16, 16, 16), x3.real.contiguous(), 'stockham'),
             (tfft.rplan, (4096,), x1, 'four_step')]
    for make, shape, x, method in cases:
        monkeypatch.delenv(tpencil.FUSE_ENV, raising=False)
        fused = make(shape, tmesh, method=method)
        yf = fused.forward(x)
        xf = fused.inverse(yf)
        monkeypatch.setenv(tpencil.FUSE_ENV, '0')
        unfused = make(shape, tmesh, method=method)
        yu = unfused.forward(x)
        assert torch.equal(yu, yf) and torch.equal(unfused.inverse(yu), xf), (shape, method)
        if len(shape) == 3 and make is tfft.plan:
            fn, _, _ = tpencil.make_fft(unfused._pplan, fused=False)
            yr, yi = fn(x.real.contiguous(), x.imag.contiguous())
            assert torch.equal(yu, torch.complex(yr, yi))


@pytest.mark.parametrize("method", ['stockham', 'four_step'])
def test_make_fft1d_large_unfused(meshes, method):
    """The rank-1 four-step with ``fused=False``: bitwise equal to the
    fused one on the plain tier, within EXEC_RTOL of the reference's
    ``make_fft1d_large(natural_order=True, fused=False)``, forward and
    inverse (factors swapped)."""
    jmesh, tmesh = meshes
    n1 = n2 = 64
    x = _operands((2, n1, n2), False)
    xt = tuple(torch.as_tensor(a) for a in x)
    kw = dict(method=method, kernel='reference')
    for inverse in (False, True):
        fns = [tlarge1d.make_fft1d_large(n1, n2, tmesh, ('x', 'y'), inverse=inverse,
                                         natural_order=True, fused=f, **kw)
               for f in (True, False)]
        yf, yu = (f(*xt) for f in fns)
        assert _same(yf, yu)
        jfn = jlarge1d.make_fft1d_large(n1, n2, jmesh, ('x', 'y'), inverse=inverse,
                                        natural_order=True, batch=True, fused=False, **kw)
        jy = jax.jit(jfn)(*(jnp.asarray(a) for a in x))
        assert _rel_l2(_np(yu), _jnp(jy)) <= EXEC_RTOL


def test_make_fused_op_and_fourstep_op_take_fused(meshes):
    """The operator executors thread ``fused``: rank 3 and rank 1, the
    unfused operator bitwise equal to the fused one on the plain tier."""
    _, tmesh = meshes
    plan = TPencilPlan(shape=(16, 16, 16), mesh=tmesh, layout=('x', 'y', None), real=True,
                       method='four_step', kernel='reference')
    x = torch.as_tensor(RNG.standard_normal((2, 16, 16, 16)).astype(np.float32))
    outs = [tpencil.make_fused_op(plan, lambda r, i: (2.0 * r, 2.0 * i), batch_ndims=(1,),
                                  fused=f)[0](x) for f in (True, False)]
    assert torch.equal(*outs)
    x1 = torch.as_tensor(RNG.standard_normal((2, 64, 64)).astype(np.float32))
    outs = [tlarge1d.make_fourstep_op(64, 64, tmesh, ('x', 'y'),
                                      lambda r, i: (2.0 * r, 2.0 * i), real=False,
                                      batch_ndims=(1,), method='stockham', kernel='reference',
                                      fused=f)(x1, x1)
            for f in (True, False)]
    assert _same(outs[0], outs[1])


# ---------------------------------------------------------------------------
# fft3d / ifft3d / fft2d / ifft2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 32)], ids=['3d', '2d'])
def test_fft3d_fft2d(meshes, shape):
    """The one-call forms: bitwise ``make_fft``'s functions, and within
    EXEC_RTOL of the reference's ``fft3d``/``ifft3d`` (``fft2d``/``ifft2d``
    are the same functions there and here)."""
    jmesh, tmesh = meshes
    layout = ('x', 'y', None) if len(shape) == 3 else ('x', None)
    kw = dict(shape=shape, layout=layout, method='four_step', kernel='reference')
    tplan, jplan = TPencilPlan(mesh=tmesh, **kw), JPencilPlan(mesh=jmesh, **kw)
    fwd, ifwd = (tpencil.fft3d, tpencil.ifft3d) if len(shape) == 3 else (tpencil.fft2d,
                                                                         tpencil.ifft2d)
    assert tpencil.fft2d is tpencil.fft3d and tpencil.ifft2d is tpencil.ifft3d
    re, im = _operands(shape, False)
    tre, tim = torch.as_tensor(re)[None], torch.as_tensor(im)[None]
    y = fwd(tre, tim, tplan)
    assert _same(y, tpencil.make_fft(tplan)[0](tre, tim))
    x2 = ifwd(*y, tplan)
    assert _same(x2, tpencil.make_fft(tplan, inverse=True)[0](*y))
    jy = jax.jit(lambda a, b: jpencil.fft3d(a, b, jplan))(jnp.asarray(re), jnp.asarray(im))
    jx = jax.jit(lambda a, b: jpencil.ifft3d(a, b, jplan))(*jy)
    assert _rel_l2(_np(tuple(t[0] for t in y)), _jnp(jy)) <= EXEC_RTOL
    assert _rel_l2(_np(tuple(t[0] for t in x2)), _jnp(jx)) <= EXEC_RTOL


# ---------------------------------------------------------------------------
# The axis-general plain forms and apply_block
# ---------------------------------------------------------------------------

AXIS_SHAPE = (8, 16, 32)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("inverse", [False, True], ids=['fwd', 'inv'])
def test_axis_forms(axis, inverse):
    """``fft_four_step_axis``, ``methods._block_axis`` and ``apply_block``
    along every axis of an (8, 16, 32) block: within EXEC_RTOL of the
    reference's, within NUMPY_RTOL of ``np.fft``, and within EXEC_RTOL
    (BF16_RTOL with a bf16 compute type) of the last-axis form on the
    axis moved last."""
    re, im = _operands(AXIS_SHAPE, False)
    tre, tim = torch.as_tensor(re), torch.as_tensor(im)
    x = re.astype(np.float64) + 1j * im
    want = np.fft.ifft(x, axis=axis) if inverse else np.fft.fft(x, axis=axis)
    want = np.stack([want.real, want.imag])
    got = {
        'four_step': tf1.fft_four_step_axis(tre, tim, axis, inverse=inverse),
        'block': tmethods._block_axis(tre, tim, axis, inverse=inverse),
        'apply_block': tuple(tmethods.apply_block(torch.stack([tre, tim]), axis=axis + 1,
                                                  inverse=inverse)),
    }
    ref = {
        'four_step': jf1.fft_four_step_axis(jnp.asarray(re), jnp.asarray(im), axis,
                                            inverse=inverse),
        'block': jmethods._block_axis(jnp.asarray(re), jnp.asarray(im), axis, inverse=inverse),
        'apply_block': tuple(jmethods.apply_block(jnp.stack([jnp.asarray(re), jnp.asarray(im)]),
                                                  axis=axis + 1, inverse=inverse)),
    }
    for name, y in got.items():
        assert _rel_l2(_np(y), _jnp(ref[name])) <= EXEC_RTOL, name
        assert _rel_max(_np(y), want) <= NUMPY_RTOL, name
    assert _same(got['block'], got['apply_block'])
    for cd, tol in ((None, EXEC_RTOL), (torch.bfloat16, BF16_RTOL)):
        moved = (tre.movedim(axis, -1), tim.movedim(axis, -1))
        for axis_fn, last_fn in ((tf1.fft_four_step_axis, tf1.fft_four_step),
                                 (tmethods._block_axis, tmethods._block_pencil)):
            last = last_fn(*moved, inverse=inverse, compute_dtype=cd)
            axis_form = axis_fn(tre, tim, axis, inverse=inverse, compute_dtype=cd)
            assert _rel_l2(_np(axis_form), _np(tuple(t.movedim(-1, axis) for t in last))) <= tol


@pytest.mark.parametrize("method", ['four_step', 'block'])
def test_plain_tier_moves_the_axis_last(method):
    """The registry carries the reference's ``axis_fn`` entries, and
    ``apply`` on the plain tier takes one form for every axis: the
    method's pencil on the axis moved last, bit for bit; it
    differentiates."""
    re, im = (torch.as_tensor(a) for a in _operands(AXIS_SHAPE, False))
    m = tmethods.get(method)
    assert m.axis_fn is {'four_step': tf1.fft_four_step_axis,
                         'block': tmethods._block_axis}[method]
    for a in (0, 1):
        want = m.pencil_fn(re.movedim(a, -1), im.movedim(a, -1))
        got = tmethods.apply(re, im, axis=a, method=method, kernel='reference')
        assert _same(got, tuple(t.movedim(-1, a) for t in want)), a
    xr = re.clone().requires_grad_(True)
    yr, yi = tmethods.apply(xr, im, axis=0, method=method, kernel='reference')
    g, = torch.autograd.grad((yr * yr + yi).sum(), xr)
    assert g.shape == re.shape and torch.isfinite(g).all()


def test_apply_block_validates():
    with pytest.raises(ValueError, match='power-of-two'):
        tmethods.apply_block(torch.zeros(2, 12, 4), axis=1)
    with pytest.raises(ValueError, match=r'\(2, \.\.\., n\)'):
        tmethods.apply_block(torch.zeros(3, 8, 4), axis=1)
    with pytest.raises(ValueError, match='no interpret mode'):
        tmethods.apply_block(torch.zeros(2, 8, 4), axis=1, kernel='pallas')


# ---------------------------------------------------------------------------
# The deprecated fft1d shim, METHODS, the planar helpers
# ---------------------------------------------------------------------------

def test_fft1d_shim_warns_once_and_dispatches():
    re, im = (torch.as_tensor(a) for a in _operands((4, 64), False))
    _deprecated.reset('repro_torch.core.fft1d.fft1d')
    with pytest.warns(DeprecationWarning, match='repro_torch.fft.methods.apply'):
        y = tf1.fft1d(re, im, method='four_step')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        y2 = tf1.fft1d(re, im, inverse=True)
    assert _same(y, tmethods.apply(re, im, method='four_step'))
    assert _same(y2, tmethods.apply(re, im, inverse=True))
    from repro.core import fft1d as rf1
    assert tf1.METHODS == tmethods.names() + ('auto',) == rf1.METHODS
    with pytest.raises(AttributeError):
        tf1.NO_SUCH_NAME


def test_planar_helpers():
    x = (RNG.standard_normal((3, 5)) + 1j * RNG.standard_normal((3, 5))).astype(np.complex128)
    tr, ti = ttw.to_planar(x, device='cpu')
    jr, ji = jtw.to_planar(x)
    assert tr.dtype == torch.float32 and tr.device.type == 'cpu'
    assert np.array_equal(tr.numpy(), np.asarray(jr)) and np.array_equal(ti.numpy(),
                                                                         np.asarray(ji))
    assert np.array_equal(ttw.from_planar((tr, ti)), jtw.from_planar((jr, ji)))
    t2 = ttw.to_planar(torch.as_tensor(x.astype(np.complex64)), device='cpu')
    assert _same(t2, (tr, ti))
    a, b = (_operands((4, 6), False), _operands((6, 3), False))
    got = ttw.cmatmul(*(torch.as_tensor(t) for t in a + b))
    want = jtw.cmatmul(*(jnp.asarray(t) for t in a + b),
                       precision=jax.lax.Precision.HIGHEST)
    assert _rel_l2(_np(got), _jnp(want)) <= EXEC_RTOL
