"""Port parity for the fused spectral-operator plans: ``plan_op``,
``SpectralOp``, ``spectral_mul``, the executors ``pencil.make_fused_op``
and ``large1d.make_fourstep_op``, and ``cost.spectral_op_cost``.

The reference's ``plan_op(...).apply`` cannot run on the installed jax
(``jax.core.trace_state_clean`` is gone), but the executors under it can:
they run here under ``jax.jit`` on a one-device Auto-axes mesh, on the
same numpy operands as the port's. Tolerances:

* an executor against the reference's: relative L2 <= 1e-6 (fp32 pencil
  passes summed in other orders, and XLA's FMA contractions);
* ``SpectralOp.apply`` against numpy (float64): relative L2 <= 1e-5;
* the operator against its unfused composition (forward, the same
  pointwise, inverse), a baked spectrum against the runtime one, and
  the 'spectrum' form against the 'plan' form given the plan's own
  spectrum: bitwise (``torch.equal``);
* cost: cycles to 1e-9 relative and the report text identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.fft as jfft
from repro.core.plan import PencilPlan as JPencilPlan
from repro.fft import large1d as jlarge1d
from repro.fft import pencil as jpencil
import repro_torch.fft as tfft
from repro_torch.comm import cost as tcost
from repro_torch.core.plan import PencilPlan as TPencilPlan
from repro_torch.fft import large1d as tlarge1d
from repro_torch.fft import pencil as tpencil
from repro_torch.launch.mesh import abstract_fft_mesh, make_fft_mesh

RNG = np.random.default_rng(20)
EXEC_RTOL = 1e-6
NUMPY_RTOL = 1e-5


@pytest.fixture(scope='module')
def meshes():
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('x', 'y'))
    return jmesh, make_fft_mesh(1, 1, device='cpu')


def pointwise(re, im, *factors):
    """Doubles the spectrum, then multiplies it by each planar factor in
    turn; the same code runs on jax arrays and torch tensors."""
    re, im = re * 2.0, im * 2.0
    for kr, ki in factors:
        re, im = re * kr - im * ki, re * ki + im * kr
    return re, im


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _real_or_planar(shape, real):
    if real:
        return (RNG.standard_normal(shape).astype(np.float32),)
    return tuple(RNG.standard_normal(shape).astype(np.float32) for _ in range(2))


def _run_both(jfn, tfn, args):
    jy = jax.jit(jfn)(*(jnp.asarray(a) for a in args))
    ty = tfn(*(torch.as_tensor(a) for a in args))
    if isinstance(ty, tuple):
        return np.stack([np.asarray(j) for j in jy]), np.stack([t.numpy() for t in ty])
    return np.asarray(jy), ty.numpy()


FUSED_CASES = [(shape, real, method, n_spectra, n_baked)
               for shape in [(16, 32), (8, 16, 16)]
               for real in (True, False)
               for method in ('stockham', 'four_step', 'block', 'direct')
               for n_spectra, n_baked in ((0, 0), (1, 1), (2, 0))]


@pytest.mark.parametrize("shape, real, method, n_spectra, n_baked", FUSED_CASES,
                         ids=[f"{len(c[0])}d-{'real' if c[1] else 'cplx'}-{c[2]}-s{c[3]}-b{c[4]}"
                              for c in FUSED_CASES])
def test_make_fused_op_matches_reference(meshes, shape, real, method, n_spectra, n_baked):
    """The rank-2/3 executor against ``repro.fft.pencil.make_fused_op``:
    a main operand with a batch of 2, runtime spectra of batch ranks 0
    and 1 (mixed batch ranks, broadcast by the pointwise), a baked
    spectrum of batch rank 0 in the native (padded rotated) layout."""
    jmesh, tmesh = meshes
    layout = ('x', 'y', None) if len(shape) == 3 else (('x', 'y'), None)
    kw = dict(shape=shape, layout=layout, method=method, kernel='reference', real=real)
    batch_ndims = (1,) + tuple(i % 2 for i in range(n_spectra))
    args = []
    for nb in batch_ndims:
        args += _real_or_planar((2,) * nb + shape, real)
    spec = shape[:-1] + (shape[-1] // 2 + 1,) if real else shape
    for _ in range(n_baked):
        args += _real_or_planar(spec, False)
    jfn, jin, jspec = jpencil.make_fused_op(
        JPencilPlan(mesh=jmesh, **kw), pointwise, batch_ndims=batch_ndims,
        baked_batch_ndims=(0,) * n_baked)
    tfn, tin, tspec = tpencil.make_fused_op(
        TPencilPlan(mesh=tmesh, **kw), pointwise, batch_ndims=batch_ndims,
        baked_batch_ndims=(0,) * n_baked)
    assert (tin, tspec) == (jin, jspec)
    jy, ty = _run_both(jfn, tfn, args)
    assert _rel(ty, jy) <= EXEC_RTOL


FOURSTEP_CASES = [(real, fused, method) for real in (True, False) for fused in (True, False)
                  for method in ('stockham', 'four_step')]


@pytest.mark.parametrize("real, fused, method", FOURSTEP_CASES,
                         ids=[f"{'real' if c[0] else 'cplx'}-{'fused' if c[1] else 'unfused'}-"
                              f"{c[2]}" for c in FOURSTEP_CASES])
def test_make_fourstep_op_matches_reference(meshes, real, fused, method):
    """The rank-1 executor against ``repro.fft.large1d.make_fourstep_op``
    at n = 2^12 (64 x 64): a batch of 2 against one runtime spectrum of
    batch rank 0 and one baked spectrum in the native form (the real
    half plane of 33 rows, the complex D-form)."""
    jmesh, tmesh = meshes
    n1 = n2 = 64
    args = _real_or_planar((2, n1, n2), real) + _real_or_planar((n1, n2), real)
    args += _real_or_planar(((n1 // 2 + 1) if real else n1, n2), False)
    kw = dict(real=real, batch_ndims=(1, 0), baked_batch_ndims=(0,), method=method,
              kernel='reference', fused=fused)
    jfn = jlarge1d.make_fourstep_op(n1, n2, jmesh, ('x', 'y'), pointwise, **kw)
    tfn = tlarge1d.make_fourstep_op(n1, n2, tmesh, ('x', 'y'), pointwise, **kw)
    jy, ty = _run_both(jfn, tfn, args)
    assert _rel(ty, jy) <= EXEC_RTOL


def _np_op(x, k, rank, real):
    axes = tuple(range(x.ndim - rank, x.ndim))
    kaxes = tuple(range(k.ndim - rank, k.ndim))
    if real:
        return np.fft.irfftn(np.fft.rfftn(x.astype(np.float64), axes=axes)
                             * np.fft.rfftn(k.astype(np.float64), axes=kaxes),
                             s=x.shape[-rank:], axes=axes)
    return np.fft.ifftn(np.fft.fftn(x.astype(np.complex128), axes=axes)
                        * np.fft.fftn(k.astype(np.complex128), axes=kaxes), axes=axes)


def _operand(shape, real):
    x = RNG.standard_normal(shape)
    return (x if real else x + 1j * RNG.standard_normal(shape)).astype(
        np.float32 if real else np.complex64)


OP_CASES = [(shape, real, method) for shape in [(4096,), (16, 32), (8, 8, 8)]
            for real in (True, False) for method in ('auto', 'stockham', 'four_step', 'block')]


@pytest.mark.parametrize("shape, real, method", OP_CASES,
                         ids=[f"{len(c[0])}d-{'real' if c[1] else 'cplx'}-{c[2]}"
                              for c in OP_CASES])
def test_apply_against_numpy_and_unfused(meshes, shape, real, method):
    """``plan_op(..., op=spectral_mul)`` on a batch of 2 against one
    unbatched factor: within 1e-5 of numpy; bitwise equal to the unfused
    composition (``plan``/``rplan`` forward with the padded spectrum,
    ``spectral_mul``, inverse); with the factor baked ('plan' form)
    bitwise equal to the runtime operand, transformed once in three
    applies; and the 'spectrum' form, given the plan's own spectrum of
    the factor, bitwise equal to the 'plan' form."""
    _, tmesh = meshes
    x, k = _operand((2,) + shape, real), _operand(shape, real)
    op = tfft.plan_op(shape, tmesh, op=tfft.spectral_mul, real=real, n_spectra=1,
                      method=method)
    got = op.apply(torch.as_tensor(x), torch.as_tensor(k))
    assert got.shape == x.shape and got.dtype == torch.as_tensor(x).dtype
    assert _rel(got.numpy(), _np_op(x, k, len(shape), real)) <= NUMPY_RTOL

    make = tfft.rplan if real else tfft.plan
    kw = dict(padded_spectrum=True) if real and len(shape) > 1 else {}
    p = make(shape, tmesh, method=op.method, **kw)
    s, sk = p.forward(torch.as_tensor(x)), p.forward(torch.as_tensor(k))
    yr, yi = tfft.spectral_mul(s.real, s.imag, (sk.real, sk.imag))
    assert torch.equal(got, p.inverse(torch.complex(yr, yi)))

    baked = tfft.plan_op(shape, tmesh, op=tfft.spectral_mul, real=real, spectra=(k,),
                         method=method)
    assert baked.bake_count == 0 and baked.n_baked == 1
    for _ in range(3):
        assert torch.equal(baked.apply(torch.as_tensor(x)), got)
    assert baked.bake_count == 1

    ks = sk.numpy()[..., :shape[-1] // 2 + 1] if real and len(shape) > 1 else sk.numpy()
    form = tfft.plan_op(shape, tmesh, op=tfft.spectral_mul, real=real, spectra=(ks,),
                        spectra_form='spectrum', method=method)
    assert torch.equal(form.apply(torch.as_tensor(x)), got)
    if not real:
        pr, pi = op.apply((torch.as_tensor(x.real), torch.as_tensor(x.imag)),
                          torch.as_tensor(k))
        assert torch.equal(pr, got.real) and torch.equal(pi, got.imag)


def test_spectral_mul_matches_reference():
    """The port's product against the reference's contraction-pinned one,
    bitwise on finite values, with a broadcast batch."""
    ar, ai = (RNG.standard_normal((3, 64, 33)).astype(np.float32) for _ in range(2))
    kr, ki = (RNG.standard_normal((64, 33)).astype(np.float32) for _ in range(2))
    want = jfft.spectral_mul(jnp.asarray(ar), jnp.asarray(ai), (jnp.asarray(kr), jnp.asarray(ki)))
    got = tfft.spectral_mul(torch.as_tensor(ar), torch.as_tensor(ai),
                            (torch.as_tensor(kr), torch.as_tensor(ki)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_plan_op_argument_errors(meshes):
    """The reference's argument errors, with its messages."""
    _, tmesh = meshes
    with pytest.raises(ValueError, match="op must be callable"):
        tfft.plan_op((16, 32), tmesh, op=42)
    with pytest.raises(ValueError, match="spectra_form"):
        tfft.plan_op((16, 32), tmesh, op=tfft.spectral_mul, spectra_form='nope')
    with pytest.raises(ValueError, match="n_spectra"):
        tfft.plan_op((16, 32), tmesh, op=tfft.spectral_mul, n_spectra=-1)
    with pytest.raises(ValueError, match="restore_layout"):
        tfft.plan_op((16, 32), tmesh, op=tfft.spectral_mul, restore_layout=True)
    with pytest.raises(ValueError, match="batch_spec"):
        tfft.plan_op((16, 32), tmesh, op=tfft.spectral_mul, batch_spec='x')
    op = tfft.plan_op((16, 32), tmesh, op=tfft.spectral_mul, n_spectra=1,
                      padded_spectrum=False)
    assert op.padded_spectrum and not op.restore_layout and op.batch_spec is None
    assert not tfft.plan_op((256,), tmesh, op=tfft.spectral_mul).padded_spectrum
    x = torch.zeros(16, 32)
    with pytest.raises(ValueError, match="runtime spectra"):
        op.apply(x)
    with pytest.raises(ValueError, match="real arrays"):
        op.apply(x.to(torch.complex64), x)
    with pytest.raises(ValueError, match="single real arrays"):
        op.apply((x, x), x)
    with pytest.raises(ValueError, match="does not end with"):
        op.apply(x[:, :16], x)
    with pytest.raises(ValueError, match="rfftn-order"):
        tfft.plan_op((16, 32), tmesh, op=tfft.spectral_mul, spectra=(np.zeros((16, 32)),),
                     spectra_form='spectrum').apply(x)


def test_with_options_round_trips(meshes):
    """Options carry over to an operator plan of the same kind, baked
    spectra included; schedule-only changes keep the bits; the repr
    names the op."""
    _, tmesh = meshes
    shape = (16, 32)
    k = RNG.standard_normal(shape).astype(np.float32)
    x = torch.as_tensor(RNG.standard_normal(shape).astype(np.float32))
    op = tfft.plan_op(shape, tmesh, op=tfft.spectral_mul, op_name='conv', spectra=(k,),
                      method='four_step')
    want = op.apply(x)
    assert op.cached_executables == 1
    for kw in ({'comm': 'all_to_all'}, {'overlap_chunks': 2}, {'kernel': 'reference'},
               {'donate': False}):
        q = op.with_options(**kw)
        assert type(q) is type(op) and q.n_baked == 1 and q.op_name == 'conv', kw
        assert torch.equal(q.apply(x), want), kw
    q = op.with_options(compute_dtype=torch.bfloat16, kernel='reference')
    assert q.compute_dtype == torch.bfloat16 and q._options()['spectra'] is op._spectra_raw
    assert 0 < _rel(q.apply(x).numpy(), want.numpy()) < 2e-2
    assert repr(op).startswith("SpectralOp(op='conv', shape=(16, 32), real=True")
    assert not op.donates_input
    op.clear_cache()
    assert op.cached_executables == 0 and torch.equal(op.apply(x), want)


COST_MESHES = [(1, 1), (2, 2), (1, 4)]
COST_SHAPES = [(64, 64, 64), (32, 64), (1 << 12,)]
COST_CASES = ([(shape, mesh, real, ns, nb) for shape in COST_SHAPES for mesh in COST_MESHES
               for real in (True, False) for ns, nb in ((0, 1), (1, 0), (2, 1))]
              + [((512,) * 3, (512, 512), real, ns, nb) for real in (True, False)
                 for ns, nb in ((0, 1), (1, 0))])


@pytest.mark.parametrize("shape, mesh, real, n_spectra, n_baked", COST_CASES,
                         ids=[f"{len(c[0])}d{c[0][0]}-{c[1][0]}x{c[1][1]}-"
                              f"{'real' if c[2] else 'cplx'}-s{c[3]}-b{c[4]}" for c in COST_CASES])
def test_spectral_op_cost_matches_reference(monkeypatch, shape, mesh, real, n_spectra, n_baked):
    """``plan_op(...).plan_cost()`` and ``cost_report()`` on abstract
    meshes against the reference's, planned with the default options
    (the reference's measured table switched off, as the port has
    none): the same pick, every step's cycles to 1e-9, the same text."""
    monkeypatch.setenv('REPRO_MEASURED_COSTS', '')
    spectra = (np.zeros(shape, np.float32),) * n_baked or None
    kw = dict(real=real, n_spectra=n_spectra, spectra=spectra, kernel='reference')
    ref = jfft.plan_op(shape, AbstractMesh(mesh, ('x', 'y')), op=jfft.spectral_mul, **kw)
    got = tfft.plan_op(shape, abstract_fft_mesh(*mesh), op=tfft.spectral_mul, **kw)
    assert (got.comm, got.overlap_chunks, got.method) == (ref.comm, ref.overlap_chunks,
                                                          ref.method)
    want, have = ref.plan_cost(measured=None), got.plan_cost(measured=None)
    assert [s.kind for s in have.steps] == [s.kind for s in want.steps]
    assert [s.detail for s in have.steps] == [s.detail for s in want.steps]
    for a, b in zip(have.steps, want.steps):
        assert a.cycles == pytest.approx(b.cycles, rel=1e-9, abs=1e-9)
    assert have.cycles == pytest.approx(want.cycles, rel=1e-9)
    direct = tcost.spectral_op_cost(
        shape, got._pplan.layout if len(shape) > 1 else got._mesh_axis_1d,
        dict(got.mesh.shape), factors=got._factors, method=got.method,
        strategy=got.comm, overlap_chunks=got.overlap_chunks, real=real,
        n_spectra=n_spectra, n_baked=n_baked, measured=None, kernel='reference')
    assert direct.cycles == have.cycles
    assert got.cost_report() == ref.cost_report()
