"""Port parity for the facade: ``repro_torch.fft.plan`` on a one-rank CPU
mesh against ``repro.fft.plan`` on ``jax.make_mesh((1, 1), ('x', 'y'))``.

Both sides get the same numpy inputs from a seed. Tolerance for every
transform: max |port - ref| <= 1e-5 * max |ref|. Each side runs three
fp32 pencil passes; XLA contracts products into FMAs and sums the
four-step in another order than PyTorch, so the sides differ by a few
fp32 ulps of the largest magnitude per pass (observed <= 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fft as jfft
from repro.comm import cost as rcost
import repro_torch.fft as tfft
from repro_torch.fft import api
from repro_torch.launch.mesh import abstract_fft_mesh, make_fft_mesh
from repro_torch.weights import from_numpy

RTOL = 1e-5
RNG = np.random.default_rng(3)


@pytest.fixture(scope='module')
def meshes():
    return jax.make_mesh((1, 1), ('x', 'y')), make_fft_mesh(1, 1, device='cpu')


def _cplx(shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _np(t):
    if isinstance(t, tuple):
        return t[0].numpy() + 1j * t[1].numpy()
    return t.numpy()


@pytest.mark.parametrize("method", ['auto', 'stockham', 'four_step'])
@pytest.mark.parametrize("n", [8, 16, 64])
def test_plan_matches_reference(meshes, n, method):
    """Complex and planar front ends, one leading batch dim, forward and
    inverse, against the reference and np.fft.fftn."""
    jmesh, tmesh = meshes
    x = _cplx((2, n, n, n))
    jp = jfft.plan((n, n, n), jmesh, method=method, donate=False)
    tp = tfft.plan((n, n, n), tmesh, method=method)
    assert (tp.method, tp.comm, tp.overlap_chunks) == (jp.method, jp.comm, jp.overlap_chunks)
    jy = np.asarray(jp.forward(jnp.asarray(x)))
    jx = np.asarray(jp.inverse(jnp.asarray(jy)))
    ty = tp.forward(from_numpy(x, 'cpu'))
    assert ty.dtype == torch.complex64
    assert _rel(_np(ty), jy) <= RTOL
    assert _rel(_np(ty), np.fft.fftn(x, axes=(1, 2, 3))) <= RTOL
    assert _rel(_np(tp.inverse(ty)), jx) <= RTOL
    planar = tp.forward(from_numpy((x.real, x.imag), 'cpu'))
    assert isinstance(planar, tuple) and planar[0].dtype == torch.float32
    assert _rel(_np(planar), jy) <= RTOL
    assert _rel(_np(tp.inverse(planar)), jx) <= RTOL


@pytest.mark.parametrize("method", ['stockham', 'four_step'])
def test_restore_layout_and_batch_dims(meshes, method):
    jmesh, tmesh = meshes
    n = 16
    x = _cplx((2, 3, n, n, n))
    jp = jfft.plan((n, n, n), jmesh, method=method, restore_layout=True, donate=False)
    tp = tfft.plan((n, n, n), tmesh, method=method, restore_layout=True)
    assert tp.out_layout == jp.out_layout == ('x', 'y', None)
    jy = np.asarray(jp.forward(jnp.asarray(x)))
    ty = tp.forward(from_numpy(x, 'cpu'))
    assert ty.shape == x.shape
    assert _rel(_np(ty), jy) <= RTOL
    assert _rel(_np(tp.inverse(ty)), np.asarray(jp.inverse(jnp.asarray(jy)))) <= RTOL


@pytest.mark.parametrize("shape", [(16, 32), (64, 64)])
def test_rank2_matches_reference(meshes, shape):
    jmesh, tmesh = meshes
    x = _cplx((3,) + shape)
    jp = jfft.plan(shape, jmesh, donate=False)
    tp = tfft.plan(shape, tmesh)
    assert tp.in_layout == jp.in_layout == (('x', 'y'), None)
    assert tp.out_layout == jp.out_layout
    assert (tp.method, tp.comm) == (jp.method, jp.comm)
    jy = np.asarray(jp.forward(jnp.asarray(x)))
    ty = tp.forward(from_numpy(x, 'cpu'))
    assert _rel(_np(ty), jy) <= RTOL
    assert _rel(_np(ty), np.fft.fft2(x)) <= RTOL
    assert _rel(_np(tp.inverse(ty)), x) <= RTOL


@pytest.mark.parametrize("rank", [2, 3])
def test_resolution_matches_reference(meshes, rank):
    """comm='auto' on a one-device mesh: (method, comm, overlap_chunks)
    and the layouts equal the reference's for n = 2..512 (and an uneven
    rank-2 shape whose axes pick different methods)."""
    jmesh, tmesh = meshes
    shapes = [(1 << k,) * rank for k in range(1, 10)]
    if rank == 2:
        shapes += [(32, 64), (64, 32)]
    for shape in shapes:
        for method in ('auto', 'stockham'):
            jp = jfft.plan(shape, jmesh, method=method)
            tp = tfft.plan(shape, tmesh, method=method)
            assert ((tp.method, tp.comm, tp.overlap_chunks)
                    == (jp.method, jp.comm, jp.overlap_chunks)), shape
            assert (tp.in_layout, tp.out_layout) == (jp.in_layout, jp.out_layout), shape


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("wire", ['fp16', 'bf16'])
def test_one_rank_wire_casts_as_the_reference(meshes, wire, real):
    """On a one-rank mesh every swap is local, yet a 16-bit wire still
    rounds the operand around it, in the reference and in the port: the
    two agree, and both differ from the native wire.

    The input lies on the sublattice of every 4th index, in multiples of
    2^-16: every product with an irrational twiddle then meets a zero,
    so both packages compute the same fp32 values exactly and round
    them alike onto the wire (random data would put a few values on
    either side of a 16-bit rounding step). Those values need 17 bits,
    so the wire does round them."""
    jmesh, tmesh = meshes
    n = 16
    x = np.zeros((2, n, n, n), np.complex64)
    q = [RNG.integers(-2**16, 2**16, (2, 4, 4, 4)) / 2**16 for _ in range(2)]
    x[(slice(None),) + (slice(0, n, 4),) * 3] = q[0] + (0 if real else 1j * q[1])
    if real:
        x = x.real.copy()
    make_j, make_t = (jfft.rplan, tfft.rplan) if real else (jfft.plan, tfft.plan)
    jp = make_j((n, n, n), jmesh, method='stockham', wire_dtype=wire, donate=False)
    tp = make_t((n, n, n), tmesh, method='stockham', wire_dtype=wire)
    jy = np.asarray(jp.forward(jnp.asarray(x)))
    ty = tp.forward(from_numpy(x, 'cpu'))
    assert _rel(_np(ty), jy) <= RTOL
    assert _rel(_np(tp.inverse(ty)), np.asarray(jp.inverse(jnp.asarray(jy)))) <= RTOL
    native = tp.with_options(wire_dtype='native').forward(from_numpy(x, 'cpu'))
    assert _rel(_np(ty), _np(native)) > 0


def test_with_options_round_trips(meshes):
    _, tmesh = meshes
    p = tfft.plan((16, 16, 16), tmesh)
    q = p.with_options(wire_dtype='bf16')
    assert q._options() == dict(p._options(), wire_dtype='bf16')
    q = p.with_options(overlap_chunks=4)
    assert q._options() == dict(p._options(), overlap_chunks=4)
    assert q.with_options(overlap_chunks=1)._options() == p._options()
    assert p.with_options()._options() == p._options()
    r = p.with_options(method='stockham', restore_layout=True, kernel='reference')
    assert (r.method, r.restore_layout, r.kernel, r.comm) == (
        'stockham', True, 'reference', 'all_to_all')


def test_operand_checks(meshes):
    _, tmesh = meshes
    p = tfft.plan((8, 8, 8), tmesh)
    with pytest.raises(TypeError):
        p.forward(torch.zeros(8, 8, 8, dtype=torch.complex128))
    with pytest.raises(ValueError):
        p.forward(torch.zeros(8, 8, 4, dtype=torch.complex64))
    with pytest.raises(ValueError):
        p.forward((torch.zeros(8, 8, 8), torch.zeros(8, 8, 8, dtype=torch.float64)))
    x = torch.zeros(8, 8, 8, dtype=torch.complex64)
    p.forward(x)
    assert not p.donates_input and torch.equal(x, torch.zeros_like(x))


@pytest.mark.parametrize("kw, item", [
    (dict(shape=(64,)), 'Rank 1/2'),
    (dict(shape=(64,), real=True), 'Rank 1/2'),
    (dict(shape=(512,) * 3, mesh=(1, 4)), 'Other strategies'),
    (dict(shape=(512,) * 3, mesh=(1, 4), real=True), 'Other strategies'),
])
def test_later_slices_raise_with_their_roadmap_item(meshes, kw, item):
    """Rank 1 ('Rank 1/2') and a default plan whose pick is ppermute (on
    a 1 x 4 mesh, 'Other strategies') are ported and plan, to the
    reference's pick; so are operator plans ('Operator plans'), which
    resolve as the plain plan of the same options and price their fused
    chain."""
    _, tmesh = meshes
    kw = dict(kw)
    shape = kw.pop('shape')
    mesh = abstract_fft_mesh(*kw.pop('mesh')) if 'mesh' in kw else tmesh
    p = tfft.plan(shape, mesh, **kw)
    if item == 'Rank 1/2':
        assert (p.rank, p.comm, p.in_layout) == (1, 'all_to_all', (('x', 'y'),))
        assert p.out_layout == ((None,) if p.real else p.in_layout)
    else:
        assert (p.comm, p.overlap_chunks, p.method) == (
            ('ppermute', 1, 'four_step') if p.real else ('ppermute', 8, 'four_step'))
    op = tfft.plan_op(shape, mesh, op=tfft.spectral_mul, **dict(kw, real=p.real))
    assert (op.comm, op.overlap_chunks, op.method) == (p.comm, p.overlap_chunks, p.method)
    assert 'pointwise' in [s.kind for s in op.plan_cost(measured=None).steps]


def test_multirank_auto_comm_needs_the_selector():
    """On a 2 x 2 mesh the default plan resolves through the ported
    selector to the reference's pick; an explicit strategy other than
    all_to_all (ppermute here) plans as asked, with one overlap chunk."""
    four = abstract_fft_mesh(2, 2)
    for shape, real in [((16,) * 3, False), ((64,) * 3, False), ((64,) * 3, True)]:
        sel = rcost.select(shape, ('x', 'y', None), dict(four.shape), real=real,
                           measured=None)
        p = api.plan(shape, four, real=real)
        assert (p.comm, p.overlap_chunks, p.method) == (
            sel.strategy, sel.overlap_chunks, sel.method)
    assert (p.comm, p.overlap_chunks) == ('all_to_all', 1)
    assert api.plan((64,) * 3, four).overlap_chunks == 8
    p = api.plan((16, 16, 16), four, comm='ppermute')
    assert (p.comm, p.overlap_chunks, p.method) == ('ppermute', 1, 'auto')
    p = api.plan((16, 16, 16), four, comm='all_to_all')
    assert (p.comm, p.overlap_chunks, p.method) == ('all_to_all', 1, 'auto')
    assert p.local_shape(p.in_layout) == (8, 8, 16)


OVERLAP_METHODS = ['stockham', 'four_step', 'block', 'direct']


@pytest.mark.parametrize("real", [False, True], ids=['complex', 'real'])
@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 16, 32)], ids=['16^3', '8x16x32'])
@pytest.mark.parametrize("method", OVERLAP_METHODS)
def test_overlap_matches_reference(meshes, method, shape, real):
    """``overlap_chunks`` = 2 and 4 on a one-rank mesh: the port against
    ``repro.fft.plan(..., overlap_chunks=c)`` (within RTOL, forward and
    inverse), and chunked against the port's own unchunked plan,
    bitwise: every pencil's arithmetic is independent of its neighbours
    and of where its chunk starts. The batch of 2 leaves the batch axis
    unchunked at c = 4 and chunks it at c = 2."""
    jmesh, tmesh = meshes
    x = _cplx((2,) + shape)
    if real:
        x = x.real.copy()
    make_j, make_t = (jfft.rplan, tfft.rplan) if real else (jfft.plan, tfft.plan)
    base = make_t(shape, tmesh, method=method)
    y1 = base.forward(from_numpy(x, 'cpu'))
    x1 = base.inverse(y1)
    for c in (2, 4):
        jp = make_j(shape, jmesh, method=method, overlap_chunks=c, donate=False)
        tp = make_t(shape, tmesh, method=method, overlap_chunks=c)
        assert (tp.comm, tp.overlap_chunks) == (jp.comm, jp.overlap_chunks) == ('all_to_all', c)
        jy = np.asarray(jp.forward(jnp.asarray(x)))
        ty = tp.forward(from_numpy(x, 'cpu'))
        assert _rel(_np(ty), jy) <= RTOL
        tx = tp.inverse(ty)
        assert _rel(_np(tx), np.asarray(jp.inverse(jnp.asarray(jy)))) <= RTOL
        assert torch.equal(ty, y1) and torch.equal(tx, x1), c


def test_default_mesh_is_the_card():
    """Entry points run on CUDA unless the caller asks for the CPU; with
    no card the default mesh raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert make_fft_mesh(1, 1).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            make_fft_mesh(1, 1)
