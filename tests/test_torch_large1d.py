"""Port parity for rank-1 plans: ``repro_torch.fft.plan((n,), mesh)`` and
``rplan`` (the distributed four-step, ``repro_torch.fft.large1d``)
against ``repro.fft.plan`` on a one-device ``Mesh``, and the rank-1
selector and cost model against the reference's.

Tolerances:

* transforms, forward and inverse, against the reference: relative L2
  <= 1e-6. Both run two fp32 pencil passes and one twiddle; XLA contracts
  products into FMAs and takes its twiddle angles in fp32 (the port in
  float64), a few ulps apart. Against numpy: <= 1e-6 too;
* picks (strategy, overlap chunks, method) exactly; cycles to 1e-9
  relative (the same float operations in the same order) and the report
  text exactly.

The reference's rank-1 selector reads its own measured table by
default; both packages are held to the analytic model here
(``REPRO_MEASURED_COSTS`` and the port's variable set to '').
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fft as jfft
from repro.comm import cost as rcost
from repro.fft import api as rapi
from repro.fft import large1d as rlarge1d
import repro_torch.fft as tfft
from repro_torch.comm import cost as tcost
from repro_torch.core.twiddle import four_step_factors
from repro_torch.fft import api as tapi
from repro_torch.fft import large1d as tlarge1d
from repro_torch.launch.mesh import abstract_fft_mesh, make_fft_mesh
from repro_torch.weights import from_numpy

RTOL = 1e-6
REL = 1e-9
RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True)
def _analytic(monkeypatch):
    monkeypatch.setenv(tcost.MEASURED_ENV, '')
    monkeypatch.setenv(rcost.MEASURED_ENV, '')


@pytest.fixture(scope='module')
def meshes():
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('x', 'y'))
    return jmesh, make_fft_mesh(1, 1, device='cpu')


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(t):
    return t[0].numpy() + 1j * t[1].numpy() if isinstance(t, tuple) else t.numpy()


CASES = list(itertools.product((1 << 12, 1 << 16), ((), (3,)),
                               ('stockham', 'four_step', 'block')))


@pytest.mark.parametrize("n, batch, method", CASES,
                         ids=[f"{n}-b{len(b)}-{m}" for n, b, m in CASES])
def test_plan_matches_reference(meshes, n, batch, method):
    """Complex rank 1, complex and planar front ends, forward and
    inverse, against the reference and np.fft.fft."""
    jmesh, tmesh = meshes
    x = (RNG.standard_normal(batch + (n,))
         + 1j * RNG.standard_normal(batch + (n,))).astype(np.complex64)
    jp = jfft.plan((n,), jmesh, method=method, donate=False)
    tp = tfft.plan((n,), tmesh, method=method)
    assert (tp.method, tp.comm, tp.overlap_chunks) == (jp.method, jp.comm, jp.overlap_chunks)
    assert (tp.in_layout, tp.out_layout) == (jp.in_layout, jp.out_layout)
    jy = np.asarray(jp.forward(jnp.asarray(x)))
    jx = np.asarray(jp.inverse(jnp.asarray(jy)))
    ty = tp.forward(from_numpy(x, 'cpu'))
    assert ty.dtype == torch.complex64
    assert _rel(_np(ty), jy) <= RTOL
    assert _rel(_np(ty), np.fft.fft(x.astype(np.complex128))) <= RTOL
    assert _rel(_np(tp.inverse(ty)), jx) <= RTOL
    planar = tp.forward(from_numpy((x.real, x.imag), 'cpu'))
    assert isinstance(planar, tuple) and _rel(_np(planar), jy) <= RTOL
    assert _rel(_np(tp.inverse(planar)), jx) <= RTOL


@pytest.mark.parametrize("n, batch, method", CASES,
                         ids=[f"{n}-b{len(b)}-{m}" for n, b, m in CASES])
def test_rplan_matches_reference(meshes, n, batch, method):
    """Real rank 1: the np.fft.rfft spectrum (n//2 + 1 bins) and its
    inverse, against the reference and numpy."""
    jmesh, tmesh = meshes
    x = RNG.standard_normal(batch + (n,)).astype(np.float32)
    jp = jfft.rplan((n,), jmesh, method=method)
    tp = tfft.rplan((n,), tmesh, method=method)
    assert (tp.method, tp.comm) == (jp.method, jp.comm)
    assert tp.spectrum_shape == jp.spectrum_shape == (n // 2 + 1,)
    assert (tp.in_layout, tp.out_layout) == (jp.in_layout, jp.out_layout) == (
        (('x', 'y'),), (None,))
    jy = np.asarray(jp.forward(jnp.asarray(x)))
    ty = tp.forward(from_numpy(x, 'cpu'))
    assert ty.dtype == torch.complex64 and tuple(ty.shape) == batch + (n // 2 + 1,)
    assert _rel(_np(ty), jy) <= RTOL
    assert _rel(_np(ty), np.fft.rfft(x.astype(np.float64))) <= RTOL
    tx = tp.inverse(ty)
    assert tx.dtype == torch.float32
    assert _rel(tx.numpy(), np.asarray(jp.inverse(jnp.asarray(jy)))) <= RTOL
    assert _rel(tx.numpy(), x) <= RTOL


@pytest.mark.parametrize("method", ['stockham', 'four_step'])
def test_make_fft1d_large_matches_reference(meshes, method):
    """``make_fft1d_large`` on the (n1, n2) view of a non-square n = 64 x
    32, against the reference's factory with ``natural_order=True``: the
    natural-order (n2, n1) matrix, y[j1 + n1*j2] at [j2, j1]."""
    jmesh, tmesh = meshes
    n1, n2 = 64, 32
    x = (RNG.standard_normal((n1, n2)) + 1j * RNG.standard_normal((n1, n2))).astype(np.complex64)
    jf = rlarge1d.make_fft1d_large(n1, n2, jmesh, ('x', 'y'), method=method,
                                   natural_order=True)
    jr, ji = jf(jnp.asarray(x.real), jnp.asarray(x.imag))
    tf = tlarge1d.make_fft1d_large(n1, n2, tmesh, ('x', 'y'), method=method)
    tr, ti = tf(*from_numpy((x.real[None], x.imag[None]), 'cpu'))
    got = tr[0].numpy() + 1j * ti[0].numpy()
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) <= RTOL
    want = np.fft.fft(x.reshape(-1).astype(np.complex128)).reshape(n2, n1)
    assert _rel(got, want) <= RTOL


def test_twiddle_orientations_hold_the_same_bits():
    for n1, n2, p, idx in ((64, 64, 1, 0), (4096, 4096, 4, 3), (256, 128, 8, 5)):
        m2 = n2 // p
        wr, wi = tlarge1d.twiddle(n1 * n2, n1, idx * m2, m2)
        tr, ti = tlarge1d.twiddle(n1 * n2, n1, idx * m2, m2, transposed=True)
        assert torch.equal(wr, tr.T) and torch.equal(wi, ti.T)
        k = np.outer(np.arange(n1), idx * m2 + np.arange(m2))
        want = np.exp(-2j * np.pi * k / (n1 * n2))
        assert np.abs(wr.numpy() + 1j * wi.numpy() - want).max() <= 1e-7
        cr, ci = tlarge1d.twiddle(n1 * n2, n1, idx * m2, m2, conj=True)
        assert torch.equal(cr, wr) and torch.equal(ci, -wi)


def test_overlap_over_the_batch_is_bitwise(meshes):
    """``overlap_chunks`` pipelines the four-step over batch chunks: the
    same bits as one chunk, complex and real, and the reference's
    result."""
    jmesh, tmesh = meshes
    n = 1 << 12
    x = RNG.standard_normal((4, n)).astype(np.float32)
    xc = from_numpy(x + 1j * x[::-1], 'cpu')
    for make, jmake, op in ((tfft.plan, jfft.plan, xc), (tfft.rplan, jfft.rplan,
                                                         from_numpy(x, 'cpu'))):
        base = make((n,), tmesh, method='stockham')
        p = make((n,), tmesh, method='stockham', overlap_chunks=2)
        assert p.overlap_chunks == 2 and p.with_options(overlap_chunks=1)._options() == (
            base._options())
        y = p.forward(op)
        assert torch.equal(y, base.forward(op))
        assert torch.equal(p.inverse(y), base.inverse(y))
        jp = jmake((n,), jmesh, method='stockham', overlap_chunks=2)
        assert _rel(_np(y), np.asarray(jp.forward(jnp.asarray(op.numpy())))) <= RTOL


def test_plan_options_and_checks(meshes):
    _, tmesh = meshes
    p = tfft.plan((4096,), tmesh)
    assert p.with_options()._options() == p._options()
    assert p._options()['mesh_axes'] == ('x', 'y')
    q = p.with_options(method='stockham', wire_dtype='bf16')
    assert (q.method, q.wire_dtype, q.rank) == ('stockham', 'bf16', 1)
    r = p.with_options(real=True)
    assert r.real and r.spectrum_shape == (2049,)
    assert p.local_shape(p.in_layout) == (4096,)
    assert tfft.plan((4096,), tmesh, mesh_axes='y').in_layout == ('y',)
    with pytest.raises(ValueError, match='layout applies to ranks 2/3'):
        tfft.plan((4096,), tmesh, layout=(('x', 'y'),))
    with pytest.raises(ValueError, match='padded_spectrum'):
        tfft.rplan((4096,), tmesh, padded_spectrum=True)
    with pytest.raises(ValueError, match='power of two'):
        tfft.plan((100,), tmesh)
    with pytest.raises(ValueError, match='must divide both factors'):
        tfft.plan((64,), abstract_fft_mesh(16, 1))
    with pytest.raises(ValueError):
        p.forward(torch.zeros(4095, dtype=torch.complex64))
    with pytest.raises(ValueError, match='ONE real tensor'):
        tfft.rplan((64,), tmesh).forward((torch.zeros(64), torch.zeros(64)))


MESHES = [(1, 1), (2, 2), (1, 4), (2, 4), (512, 512)]
LENGTHS = [1 << 12, 1 << 16, 1 << 20, 1 << 24]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_resolve_comm_1d_matches_reference(mesh):
    """The rank-1 picks over lengths x complex/real x wires x methods,
    the reference's own function called directly; on 2 x 2, n = 4096
    resolves to hierarchical."""
    ms = {'x': mesh[0], 'y': mesh[1]}
    for n, real, wire, method, comm, oc in itertools.product(
            LENGTHS, (False, True), ('native', 'fp16', 'bf16'), ('auto', 'stockham'),
            ('auto', 'ppermute'), (None, 2)):
        args = (four_step_factors(n), ('x', 'y'), ms, comm, oc, method, real, wire)
        assert tapi._resolve_comm_1d(*args) == rapi._resolve_comm_1d(*args), args
    if mesh == (2, 2):
        assert tapi._resolve_comm_1d((64, 64), ('x', 'y'), ms, 'auto', None,
                                     'auto')[0] == 'hierarchical'


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_large1d_plan_cost_matches_reference(mesh):
    """Every strategy's four-step price, its steps and the report text,
    complex and real, natural order or not, every wire, with overlap."""
    ms = {'x': mesh[0], 'y': mesh[1]}
    trees = {(2, 2): ['pod_tree:x.2*y.2'], (1, 4): ['pod_tree:y.2*y.2'],
             (2, 4): ['pod_tree:x.2*y.2*y.2']}.get(mesh, [])
    for n, axes, strategy, real, wire, natural, oc, method in itertools.product(
            LENGTHS, (('x', 'y'), 'y'), ['all_to_all', 'ppermute', 'hierarchical'] + trees,
            (False, True), ('native', 'fp16'), (True, False), (1, 4),
            ('auto', 'four_step')):
        n1, n2 = four_step_factors(n)
        kw = dict(method=method, strategy=strategy, real=real, wire_dtype=wire,
                  natural_order=natural, overlap_chunks=oc, measured=None)
        a = rcost.large1d_plan_cost(n1, n2, axes, ms, **kw)
        b = tcost.large1d_plan_cost(n1, n2, axes, ms, **kw)
        assert [(s.kind, s.detail) for s in b.steps] == [(s.kind, s.detail) for s in a.steps]
        for s, t in zip(a.steps, b.steps):
            assert _close(s.cycles, t.cycles)
        assert _close(a.cycles, b.cycles) and _close(a.serial_cycles, b.serial_cycles)
        assert tcost.format_report(b, (n,), ms) == rcost.format_report(a, (n,), ms)


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2), (1, 4), (2, 4)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_plan_cost_of_rank1_plans_matches_reference(mesh):
    """``FFT.plan_cost``/``cost_report`` of default rank-1 plans on an
    abstract mesh: the reference's ``large1d_plan_cost`` of the same
    resolved options."""
    am = abstract_fft_mesh(*mesh)
    for n, make in itertools.product((1 << 12, 1 << 24), (tfft.plan, tfft.rplan)):
        p = make((n,), am)
        n1, n2 = four_step_factors(n)
        want = rcost.large1d_plan_cost(
            n1, n2, ('x', 'y'), dict(am.shape), method=p.method, strategy=p.comm,
            overlap_chunks=p.overlap_chunks, real=p.real, measured=None,
            wire_dtype=p.wire_dtype, kernel=p.resolved_kernel)
        got = p.plan_cost(measured=None)
        assert _close(got.cycles, want.cycles) and got.strategy == want.strategy
        assert p.cost_report() == rcost.format_report(want, (n,), dict(am.shape))
        with pytest.raises(RuntimeError, match='cannot run'):
            p.forward(torch.zeros(n))
