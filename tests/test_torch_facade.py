"""Port parity for the facade's remaining options: ``compute_dtype``,
``use_kernel``, ``batch_spec`` on pod meshes, and ``FFT.operand_nbytes``
/ ``cached_executables`` / ``clear_cache``, against ``repro.fft``.

Both sides get the same numpy operands from a seed, the reference on a
one-device Auto-axes mesh (``jax.sharding.Mesh``; the rank-1 real path
of the reference fails on ``jax.make_mesh``'s Explicit axes). Tolerances
for ``compute_dtype=bfloat16`` (8-bit significands, two rounded products
a four-step pencil): the port within 1e-3 relative L2 of the
reference's ``kernel='reference'`` result (where the fp32 sums differ in
order, a bf16 rounding of the twiddled intermediate may land on the
other side), and each of the two between 1e-4 and 2e-2 from numpy.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.fft as jfft
import repro_torch.fft as tfft
from repro_torch.core import _deprecated
from repro_torch.fft import methods
from repro_torch.launch.mesh import abstract_fft_mesh, make_fft_mesh
from repro_torch.weights import from_numpy

RNG = np.random.default_rng(7)


@pytest.fixture(scope='module')
def meshes():
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('x', 'y'))
    return jmesh, make_fft_mesh(1, 1, device='cpu')


def _operand(shape, real):
    x = RNG.standard_normal(shape)
    return (x if real else x + 1j * RNG.standard_normal(shape)).astype(
        np.float32 if real else np.complex64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np_forward(x, rank, real):
    axes = tuple(range(x.ndim - rank, x.ndim))
    return np.fft.rfftn(x, axes=axes) if real else np.fft.fftn(x, axes=axes)


BF16_CASES = [(shape, method, real) for shape in [(16, 16, 16), (1 << 12,)]
              for method in ('four_step', 'block') for real in (False, True)]


@pytest.mark.parametrize("shape, method, real", BF16_CASES,
                         ids=[f"{len(c[0])}d-{c[1]}-{'real' if c[2] else 'cplx'}"
                              for c in BF16_CASES])
def test_bf16_products_match_reference(meshes, shape, method, real):
    """``compute_dtype=bfloat16`` on the reference tier, forward and
    inverse: the port against the reference's bf16 plan, and both
    measurably (above 1e-4) but boundedly (below 2e-2) off numpy, so the
    cast happened on both sides."""
    jmesh, tmesh = meshes
    x = _operand((2,) + shape, real)
    kw = dict(method=method, kernel='reference', real=real)
    jp = jfft.plan(shape, jmesh, compute_dtype=jnp.bfloat16, donate=False, **kw)
    tp = tfft.plan(shape, tmesh, compute_dtype=torch.bfloat16, **kw)
    assert tp.compute_dtype == torch.bfloat16
    assert tp._options()['compute_dtype'] is tp.compute_dtype
    jy = np.asarray(jp.forward(jnp.asarray(x)))
    ty = tp.forward(from_numpy(x, 'cpu')).numpy()
    want = _np_forward(x.astype(np.complex128 if not real else np.float64), len(shape), real)
    assert _rel(ty, jy) <= 1e-3
    for got in (ty, jy):
        assert 1e-4 < _rel(got, want) < 2e-2
    jx = np.asarray(jp.inverse(jnp.asarray(jy)))
    tx = tp.inverse(from_numpy(jy, 'cpu')).numpy()
    assert _rel(tx, jx) <= 1e-3
    assert 1e-4 < _rel(tx, x) < 2e-2


@pytest.mark.parametrize("method", ['stockham', 'direct'])
@pytest.mark.parametrize("real", [False, True], ids=['cplx', 'real'])
def test_methods_without_products_ignore_compute_dtype(meshes, method, real):
    """Stockham and the direct DFT have no matrix operands: the option
    changes no bit on either tier rule (the reference raises for
    Stockham, a fault of the reference; ROADMAP queue 3)."""
    _, tmesh = meshes
    shape = (16, 16, 16)
    x = from_numpy(_operand((2,) + shape, real), 'cpu')
    p = tfft.plan(shape, tmesh, method=method, kernel='reference', real=real)
    q = p.with_options(compute_dtype=torch.bfloat16)
    assert q.compute_dtype == torch.bfloat16
    assert torch.equal(q.forward(x), p.forward(x))


@pytest.mark.parametrize("method", ['four_step', 'block', 'auto'])
def test_kernel_tier_raises_for_narrow_products(method):
    """On the kernel tier (an abstract mesh answers for the card) the
    tensor-core bodies take fp32 only: bf16 raises at plan time naming
    kernel='reference', and float32 is the plain default."""
    mesh = abstract_fft_mesh(2, 2)
    with pytest.raises(ValueError, match="kernel='reference'"):
        tfft.plan((512,) * 3, mesh, method=method, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kernel='reference'"):
        tfft.rplan((1 << 24,), mesh, method=method, compute_dtype=torch.bfloat16)
    assert tfft.plan((512,) * 3, mesh, method=method,
                     compute_dtype=torch.float32).resolved_kernel == 'pallas'
    assert tfft.plan((512,) * 3, mesh, method=method, kernel='reference',
                     compute_dtype=torch.bfloat16).resolved_kernel == 'reference'
    assert tfft.plan((512,) * 3, mesh, method='stockham',
                     compute_dtype=torch.bfloat16).resolved_kernel == 'pallas'


def test_check_compute_dtype_rule():
    """The one rule, method by method and tier by tier."""
    for name in methods.names():
        m = methods.get(name)
        for tier in ('pallas', 'reference'):
            for dtype in (None, torch.float32, torch.bfloat16, torch.float16):
                narrow = dtype in (torch.bfloat16, torch.float16)
                if narrow and tier == 'pallas' and name in ('four_step', 'block'):
                    with pytest.raises(ValueError, match=name):
                        methods.check_compute_dtype(m, tier, dtype)
                else:
                    methods.check_compute_dtype(m, tier, dtype)


def test_use_kernel_warns_once_and_means_pallas(meshes):
    """``use_kernel=True`` resolves to ``kernel='pallas'`` when ``kernel``
    is 'auto' (an explicit tier wins), with one DeprecationWarning a
    process, as the reference."""
    _, tmesh = meshes
    _deprecated.reset('repro_torch.fft.plan(use_kernel=)')
    with pytest.warns(DeprecationWarning, match="kernel='pallas'"):
        p = tfft.plan((16, 16, 16), tmesh, use_kernel=True)
    assert p.kernel == 'pallas' and p._options()['kernel'] == 'pallas'
    assert p._options() == tfft.plan((16, 16, 16), tmesh, kernel='pallas')._options()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        q = tfft.plan((16, 16, 16), tmesh, use_kernel=True, kernel='reference')
    assert q.kernel == 'reference'
    assert not [w for w in seen if issubclass(w.category, DeprecationWarning)]
    assert methods._merge_kernel_arg('auto', True) == 'pallas'
    assert methods._merge_kernel_arg('auto', False) == 'auto'


NBYTES_CASES = [((16, 16, 16), False, {}), ((16, 16, 16), True, {}),
                ((16, 16, 16), True, dict(padded_spectrum=True)), ((32, 64), True, {}),
                ((1 << 12,), False, {}), ((1 << 12,), True, {})]


@pytest.mark.parametrize("shape, real, kw", NBYTES_CASES,
                         ids=[f"{len(c[0])}d-{'real' if c[1] else 'cplx'}"
                              f"{'-padded' if c[2] else ''}" for c in NBYTES_CASES])
def test_operand_nbytes_matches_reference(meshes, shape, real, kw):
    jmesh, tmesh = meshes
    jp = jfft.plan(shape, jmesh, real=real, **kw)
    tp = tfft.plan(shape, tmesh, real=real, **kw)
    for spectrum in (False, True):
        assert tp.operand_nbytes(spectrum=spectrum) == jp.operand_nbytes(spectrum=spectrum)
        for jd, td in ((np.float64, torch.float64), (np.complex128, torch.complex128)):
            want = jp.operand_nbytes(jd, spectrum=spectrum)
            assert tp.operand_nbytes(td, spectrum=spectrum) == want
            assert tp.operand_nbytes(jd, spectrum=spectrum) == want


def test_cached_executables_and_clear_cache(meshes):
    """One per-rank function a direction; a cleared plan rebuilds them
    and gives the same bits."""
    _, tmesh = meshes
    p = tfft.plan((16, 16, 16), tmesh)
    x = from_numpy(_operand((2, 16, 16, 16), False), 'cpu')
    assert p.cached_executables == 0
    y = p.forward(x)
    p.forward(x[0])
    assert p.cached_executables == 1
    p.inverse(y)
    assert p.cached_executables == 2
    p.clear_cache()
    assert p.cached_executables == 0
    assert torch.equal(p.forward(x), y) and p.cached_executables == 1


POD_MESHES = [(1, 2, 2), (2, 2, 2), (1, 4, 2), (2, 2, 4)]
POD_SHAPES = [(32, 32, 32), (64, 64, 64), (32, 64), (1 << 12,)]
POD_CASES = [(shape, mesh, real, batch_spec) for shape in POD_SHAPES for mesh in POD_MESHES
             for real in (False, True) for batch_spec in ('pod', None)]


@pytest.mark.parametrize("shape, mesh, real, batch_spec", POD_CASES,
                         ids=[f"{len(c[0])}d{c[0][0]}-{'x'.join(map(str, c[1]))}-"
                              f"{'real' if c[2] else 'cplx'}-{c[3]}" for c in POD_CASES])
def test_pod_mesh_picks_match_reference(monkeypatch, shape, mesh, real, batch_spec):
    """A ('pod', 'x', 'y') mesh of (rows, cols, pods), abstract: the
    default axes leave out ``batch_spec`` (without it rank 3 still takes
    ('x', 'y') and ranks 1/2 flatten every axis), the plan is priced on
    the full mesh shape, and the pick, layout and cycles are the
    reference's (its measured table off, as the port has none)."""
    monkeypatch.setenv('REPRO_MEASURED_COSTS', '')
    rows, cols, pods = mesh
    jmesh = AbstractMesh((pods, rows, cols), ('pod', 'x', 'y'))
    tmesh = abstract_fft_mesh(rows, cols, pods=pods)
    assert tmesh.axis_names == ('pod', 'x', 'y') and tmesh.size == rows * cols * pods
    kw = dict(real=real, batch_spec=batch_spec, kernel='reference')
    jp = jfft.plan(shape, jmesh, **kw)
    tp = tfft.plan(shape, tmesh, **kw)
    assert (tp.comm, tp.overlap_chunks, tp.method) == (jp.comm, jp.overlap_chunks, jp.method)
    assert tp.in_layout == jp.in_layout and tp.batch_spec == batch_spec
    assert tp.plan_cost(measured=None).cycles == pytest.approx(
        jp.plan_cost(measured=None).cycles, rel=1e-9)
    q = tp.with_options(overlap_chunks=1)
    assert q.batch_spec == batch_spec and q.overlap_chunks == 1


def test_batch_spec_checks(meshes):
    """``batch_spec`` must name a mesh axis, and its plan takes exactly
    one leading batch dim."""
    _, tmesh = meshes
    with pytest.raises(ValueError, match="not a mesh axis"):
        tfft.plan((16, 16, 16), tmesh, batch_spec='pod')
    with pytest.raises(ValueError, match="two mesh axes"):
        tfft.plan((16, 16, 16), tmesh, batch_spec='x')
    p = tfft.plan((16, 32), tmesh, batch_spec='x')
    assert p.in_layout == ('y', None)
    x = from_numpy(_operand((2, 16, 32), False), 'cpu')
    assert p.forward(x).shape == x.shape
    for bad in (x[0], x.reshape(1, 2, 16, 32)):
        with pytest.raises(ValueError, match="exactly one leading batch dim"):
            p.forward(bad)
