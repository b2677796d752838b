"""Port parity for real plans (``rplan``) and ``method='block'``.

The same numpy inputs (from a seed) go through the JAX package and the
port on the CPU: host tables, the plain block four-step and real pencils
of ``core/fft1d.py``, the plain version of the ``fft_block`` kernel
against the Pallas kernel in interpret mode, and whole plans on a
one-rank mesh against ``repro.fft.plan``/``rplan`` on
``jax.make_mesh((1, 1), ('x', 'y'))``.

Tolerances:
* host tables: bitwise (the same numpy float64 arithmetic);
* pencils and the kernel's plain version: max |port - ref| <= 2e-6 *
  max |ref|. Both sides are fp32 sums of at most 32 terms per factor
  (the block four-step's contractions run over 2 n1 and 2 n2 terms) in
  another order, and the real pencils add an O(n) combine of a few
  roundings; the observed gap is below 4e-7;
* plans: max |port - ref| <= 1e-5 * max |ref|, as in
  ``test_torch_plan.py`` (three fp32 pencil passes).

On a one-rank mesh the padded spectrum has no pad (every group size is
1), so a plan with ``padded_spectrum=True`` computes the same array as
without it; both port plans are held against the one reference result.
The JAX plans are shared through module-scoped caches so each compiles
once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fft as jfft
from repro.core import fft1d as jf
from repro.core import twiddle as jtw
from repro.kernels import fft_block as jkb
import repro_torch.fft as tfft
from repro_torch.core import fft1d as tf
from repro_torch.core import twiddle as ttw
from repro_torch.fft import methods
from repro_torch.kernels import fft_block as tkb
from repro_torch.launch.mesh import make_fft_mesh
from repro_torch.weights import from_numpy

PENCIL_RTOL = 2e-6
PLAN_RTOL = 1e-5
NS = [1 << k for k in range(2, 11)]
SHAPES = [(16, 16, 16), (8, 16, 32), (16, 32)]
RNG = np.random.default_rng(12)


def _real(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _planar(shape):
    return _real(shape), _real(shape)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _np(t):
    if isinstance(t, tuple):
        return t[0].numpy() + 1j * t[1].numpy()
    return t.numpy()


@pytest.fixture(scope='module')
def meshes():
    return jax.make_mesh((1, 1), ('x', 'y')), make_fft_mesh(1, 1, device='cpu')


# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << k for k in range(0, 13)])
def test_real_and_block_tables_bitwise(n):
    for a, b in zip(ttw.rfft_split_twiddle_np(n), jtw.rfft_split_twiddle_np(n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    n1, n2 = ttw.four_step_factors(n)
    for inverse in (False, True):
        for a, b in zip(tf._block_consts_np(n1, n2, inverse),
                        jf._block_consts_np(n1, n2, inverse)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_block_tables_are_cached_per_device():
    a = tf.block_tables(32, 16, False, torch.device('cpu'))
    assert a is tf.block_tables(32, 16, False, torch.device('cpu'))
    assert a is not tf.block_tables(32, 16, True, torch.device('cpu'))
    assert a[0].dtype == torch.float32 and a[1].shape == (2, 16, 32, 2, 16)


# ---------------------------------------------------------------------------
# Plain pencils against repro.core.fft1d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_fft_four_step_block(n):
    """Leading batch dims on both sides of the pencil axis, forward and
    inverse, against the reference (Precision.HIGHEST) and np.fft."""
    x = np.stack(_planar((3, n, 2)))
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for inverse in (False, True):
        got = tf.fft_four_step_block(t, 2, inverse=inverse)
        assert _rel(got.numpy(), jf.fft_four_step_block(j, 2, inverse=inverse)) <= PENCIL_RTOL
    z = x[0] + 1j * x[1]
    got = tf.fft_four_step_block(t, -2)
    assert _rel(got[0].numpy() + 1j * got[1].numpy(), np.fft.fft(z, axis=1)) <= PENCIL_RTOL * 4


@jax.jit
def _jreal(x):
    """The reference's rfft pencil around its four-step and the irfft of
    that spectrum, in one jitted function (op by op they compile once
    per op and shape)."""
    re, im = jf.rfft_pencil(x, cfft=jf.fft_four_step)
    return re, im, jf.irfft_pencil(
        re, im, cifft=lambda a, b: jf.fft_four_step(a, b, inverse=True))


@pytest.mark.parametrize("n", NS)
def test_rfft_irfft_pencils(n):
    """The Hermitian pack/combine around the same complex pencil on both
    sides (the four-step), and around the block four-step for the port."""
    x = _real((2, 3, n))
    jr, ji, jback = _jreal(jnp.asarray(x))
    got = tf.rfft_pencil(torch.from_numpy(x), cfft=tf.fft_four_step)
    assert _rel(_np(got), np.asarray(jr) + 1j * np.asarray(ji)) <= PENCIL_RTOL
    assert float(got[1][..., 0].abs().max()) == 0.0 == float(got[1][..., -1].abs().max())
    assert _rel(_np(got), np.fft.rfft(x)) <= PENCIL_RTOL * 4
    back = tf.irfft_pencil(*got, cifft=lambda r, i: tf.fft_four_step(r, i, inverse=True))
    assert _rel(back.numpy(), jback) <= PENCIL_RTOL
    blk = methods.get('block').real_fn
    assert _rel(_np(blk(torch.from_numpy(x))), np.fft.rfft(x)) <= PENCIL_RTOL * 4
    assert _rel(blk(*got, inverse=True).numpy(), x) <= PENCIL_RTOL * 4


# ---------------------------------------------------------------------------
# The fft_block kernel module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 512])
def test_fft_block_plain_vs_pallas(n):
    """Ragged batch (37 is not a multiple of the Pallas block of 8), in
    the stacked form and the planar form, forward and inverse."""
    x = np.stack(_planar((37, n)))
    for inverse in (False, True):
        want = np.asarray(jkb.fft_block(jnp.asarray(x), inverse=inverse, interpret=True))
        got = tkb.fft_block(torch.from_numpy(x), inverse=inverse)
        assert got.shape == x.shape and _rel(got.numpy(), want) <= PENCIL_RTOL
        gr, gi = tkb.fft_block_planar(*torch.from_numpy(x), inverse=inverse)
        assert _rel(np.stack([gr.numpy(), gi.numpy()]), want) <= PENCIL_RTOL


def test_block_kernel_tier_raises_on_cpu(meshes):
    _, tmesh = meshes
    x = torch.zeros(2, 3, 16)
    with pytest.raises(ValueError, match='pallas'):
        methods.apply_block(x, axis=-1, kernel='pallas')
    with pytest.raises(ValueError, match='pallas'):
        methods.apply(x[0], x[1], method='block', kernel='pallas')
    with pytest.raises(ValueError, match='pallas'):
        methods.apply_real(x[0], method='block', kernel='pallas')
    for mk in (tfft.plan, tfft.rplan):
        p = mk((8, 8, 8), tmesh, method='block', kernel='pallas')
        with pytest.raises(ValueError, match='pallas'):
            p.forward(torch.zeros(8, 8, 8, dtype=torch.float32 if p.real else torch.complex64))
    with pytest.raises(ValueError, match='leading complex axis'):
        tkb.fft_block(torch.zeros(3, 4, 16))


# ---------------------------------------------------------------------------
# Plans against repro.fft on a one-rank mesh
# ---------------------------------------------------------------------------

_REF = {}


def _reference(jmesh, shape, method, real):
    """(x, forward, inverse of the forward) of the JAX plan, once per
    (shape, resolved method, real)."""
    jp = (jfft.rplan if real else jfft.plan)(shape, jmesh, method=method, donate=False)
    key = (shape, jp.method, real)
    if key not in _REF:
        bshape = (2,) + shape
        if real:
            x = _real(bshape)
        else:
            x = (RNG.standard_normal(bshape) + 1j * RNG.standard_normal(bshape)).astype(
                np.complex64)
        y = jp.forward(jnp.asarray(x))
        _REF[key] = (x, np.asarray(y), np.asarray(jp.inverse(y)))
    return _REF[key]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_block_plan_matches_reference(meshes, shape):
    """Complex method='block': complex and planar front ends, a leading
    batch dim, forward and inverse."""
    jmesh, tmesh = meshes
    x, jy, jx = _reference(jmesh, shape, 'block', False)
    tp = tfft.plan(shape, tmesh, method='block')
    assert (tp.method, tp.comm, tp.overlap_chunks) == ('block', 'all_to_all', 1)
    ty = tp.forward(from_numpy(x, 'cpu'))
    assert _rel(_np(ty), jy) <= PLAN_RTOL
    assert _rel(_np(ty), np.fft.fftn(x, axes=tuple(range(1, x.ndim)))) <= PLAN_RTOL
    assert _rel(_np(tp.inverse(ty)), jx) <= PLAN_RTOL
    planar = tp.forward(from_numpy((x.real, x.imag), 'cpu'))
    assert _rel(_np(planar), jy) <= PLAN_RTOL
    assert _rel(_np(tp.inverse(planar)), jx) <= PLAN_RTOL


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("method", ['auto', 'stockham', 'four_step', 'block'])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rplan_matches_reference(meshes, shape, method, padded):
    """Forward from a real tensor with a leading batch dim, inverse from
    the complex spectrum and from a planar pair."""
    jmesh, tmesh = meshes
    x, jy, jx = _reference(jmesh, shape, method, True)
    tp = tfft.rplan(shape, tmesh, method=method, padded_spectrum=padded)
    jp = jfft.rplan(shape, jmesh, method=method, padded_spectrum=padded)
    assert (tp.method, tp.comm, tp.overlap_chunks) == (jp.method, jp.comm, jp.overlap_chunks)
    assert tp.spectrum_shape == jp.spectrum_shape == jy.shape[1:]
    assert (tp.in_layout, tp.out_layout) == (jp.in_layout, jp.out_layout)
    ty = tp.forward(from_numpy(x, 'cpu'))
    assert ty.dtype == torch.complex64 and ty.shape == jy.shape
    assert _rel(_np(ty), jy) <= PLAN_RTOL
    assert _rel(_np(ty), np.fft.rfftn(x, axes=tuple(range(1, x.ndim)))) <= PLAN_RTOL
    tx = tp.inverse(ty)
    assert tx.dtype == torch.float32 and _rel(tx.numpy(), jx) <= PLAN_RTOL
    assert _rel(tx.numpy(), x) <= PLAN_RTOL
    tx2 = tp.inverse((ty.real.contiguous(), ty.imag.contiguous()))
    assert _rel(tx2.numpy(), jx) <= PLAN_RTOL


@pytest.mark.parametrize("method", ['stockham', 'block'])
def test_rplan_restore_layout_and_batch_dims(meshes, method):
    jmesh, tmesh = meshes
    shape = (16, 16, 16)
    x, jy, _ = _reference(jmesh, shape, method, True)
    xb = np.stack([x, x[::-1]])                      # batch shape (2, 2)
    tp = tfft.rplan(shape, tmesh, method=method, restore_layout=True)
    jp = jfft.rplan(shape, jmesh, method=method, restore_layout=True)
    assert tp.out_layout == jp.out_layout == ('x', 'y', None)
    ty = tp.forward(from_numpy(xb, 'cpu'))
    assert ty.shape == (2, 2, 16, 16, 9)
    assert _rel(_np(ty)[0], jy) <= PLAN_RTOL and _rel(_np(ty)[1], jy[::-1]) <= PLAN_RTOL
    assert _rel(tp.inverse(ty).numpy(), xb) <= PLAN_RTOL


@pytest.mark.parametrize("rank", [2, 3])
def test_rplan_resolution_matches_reference(meshes, rank):
    """(method, comm, overlap_chunks), spectrum_shape and both layouts of
    rplan equal JAX's for n = 4..512, padded and not, and for shapes
    whose axes pick different methods."""
    jmesh, tmesh = meshes
    shapes = [(1 << k,) * rank for k in range(2, 10)]
    shapes += [(8, 16, 32)] if rank == 3 else [(16, 32), (64, 32), (32, 64)]
    for shape in shapes:
        for method in ('auto', 'stockham', 'block'):
            for padded in (False, True):
                jp = jfft.rplan(shape, jmesh, method=method, padded_spectrum=padded)
                tp = tfft.rplan(shape, tmesh, method=method, padded_spectrum=padded)
                assert ((tp.method, tp.comm, tp.overlap_chunks)
                        == (jp.method, jp.comm, jp.overlap_chunks)), shape
                assert tp.spectrum_shape == jp.spectrum_shape, shape
                assert (tp.in_layout, tp.out_layout) == (jp.in_layout, jp.out_layout), shape
    p = tfft.rplan((512,) * 3, tmesh)
    assert (p.method, p.comm, p.spectrum_shape) == ('four_step', 'all_to_all', (512, 512, 257))
    assert tfft.rplan((64,) * 3, tmesh).method == 'auto'


def test_real_operand_checks(meshes):
    _, tmesh = meshes
    p = tfft.rplan((8, 8, 8), tmesh)
    x = torch.zeros(8, 8, 8)
    with pytest.raises(ValueError, match='ONE real'):
        p.forward((x, x))
    with pytest.raises(ValueError, match='REAL'):
        p.forward(torch.zeros(8, 8, 8, dtype=torch.complex64))
    with pytest.raises(TypeError):
        p.forward(x.double())
    with pytest.raises(ValueError, match='does not end'):
        p.forward(torch.zeros(8, 8, 5))
    with pytest.raises(ValueError, match='does not end'):
        p.inverse(torch.zeros(8, 8, 8, dtype=torch.complex64))
    with pytest.raises(ValueError, match='does not end'):
        p.inverse((torch.zeros(8, 8, 4), torch.zeros(8, 8, 4)))
    with pytest.raises(TypeError):
        p.inverse(torch.zeros(8, 8, 5, dtype=torch.complex128))
    with pytest.raises(ValueError, match='even'):
        tfft.rplan((8, 8, 7), tmesh)
    with pytest.raises(ValueError, match='real plans only'):
        tfft.plan((8, 8, 8), tmesh, padded_spectrum=True)
    y = p.forward(x)
    assert y.shape == (8, 8, 5) and not p.donates_input
    assert torch.equal(x, torch.zeros_like(x))


def test_real_with_options_round_trips(meshes):
    _, tmesh = meshes
    p = tfft.rplan((16, 16, 16), tmesh, padded_spectrum=True)
    assert p.with_options()._options() == p._options()
    q = p.with_options(method='block')
    assert (q.real, q.padded_spectrum, q.method) == (True, True, 'block')
    c = p.with_options(real=False)
    assert (c.real, c.padded_spectrum, c.spectrum_shape) == (False, False, (16, 16, 16))
    assert c.with_options(real=True).padded_spectrum is False
