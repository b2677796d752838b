"""The port's FFT serving engine (``repro_torch.serve.FFTEngine``) against
the reference's (``repro.serve.FFTEngine``), on one CPU rank.

Parity: the same seeded numpy requests go through the reference engine
(one CPU device, an Auto-axes ``jax.sharding.Mesh``, ``donate=False``:
the reference's donation breaks on the installed jax, see
``test_mixed_shapes_and_kinds_no_flush`` there) and the port's, complex,
real, planar, inverse and rank 1, under each method. Each result agrees
with the reference engine's within 1e-5 relative L2 (fp32 pencils; XLA
contracts products into FMAs, eager PyTorch does not) and is bitwise
equal to the port's own per-request ``plan.forward``/``inverse``: a
group only stacks requests, and every pencil's bits depend on its own
values. Both engines pick the same schedule (the cost model is ported
exactly). ``register_op`` requests are held against the reference's
fused-operator executor (its engine's operator path does not run on the
installed jax) and bitwise against the port's per-request ``apply``.

Behaviour: the reference's own engine cases (``tests/test_serve_fft.py``,
``tests/test_serve_drainer.py``) that apply to the port — validation
messages, schedules and their table, tickets, the drainer's triggers,
close, failure re-queue and retries (also by injected faults), the LRU
plan cache — with the port's deliberate differences: no donation, and
on a multi-rank mesh a drainer only where the mesh has its process group
(position 0 leads the others' drainers). The gloo 2 x 2 case is below
(``tests/_torch_multirank_worker.py``, suite ``serve``); the drainer's
and the service's mesh cases are in ``tests/test_torch_serve_mesh.py``.
"""
import gc
import json
import os
import socket
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import repro_torch.fft as fft
from repro_torch.comm import cost as pcost
from repro_torch.launch.mesh import FFTMesh, abstract_fft_mesh, make_fft_mesh
from repro_torch.serve import FaultInjected, FaultPlan, FaultPoint, FFTEngine
from repro_torch.weights import from_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from _torch_multirank_worker import SERVE_SHAPE, SERVE_STREAM, serve_operands  # noqa: E402

RTOL = 1e-5


@pytest.fixture(scope='module')
def mesh():
    return make_fft_mesh(1, 1, device='cpu')


@pytest.fixture(scope='module')
def jmesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('x', 'y'))


def _creq(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rreq(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(y):
    """A result (tensor or planar pair) as one numpy array."""
    if isinstance(y, tuple):
        return np.asarray(y[0]) + 1j * np.asarray(y[1])
    return np.asarray(y)


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.complex128), _np(want).astype(np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# Parity with the reference engine
# ---------------------------------------------------------------------------

def _stream(kind, shape, n, seed):
    """(requests, direction) of one parity case."""
    rng = np.random.default_rng(seed)
    if kind == 'complex':
        return [_creq(rng, shape) for _ in range(n)], 'fwd'
    if kind == 'real':
        return [_rreq(rng, shape) for _ in range(n)], 'fwd'
    if kind == 'mixed':
        return [_creq(rng, shape) if i % 2 else _rreq(rng, shape) for i in range(n)], 'fwd'
    if kind == 'planar':
        return [(_rreq(rng, shape), _rreq(rng, shape)) for _ in range(n)], 'fwd'
    if kind == 'inverse':
        return [_creq(rng, shape) for _ in range(n)], 'inv'
    if kind == 'inverse_real':
        return [np.fft.rfftn(_rreq(rng, shape)).astype(np.complex64) for _ in range(n)], 'inv'
    raise ValueError(kind)


#: (case, shape, stream kind, requests, engine plan options)
PARITY = [
    ('complex_3d', (8, 8, 8), 'complex', 7, {}),
    ('real_3d', (8, 8, 8), 'real', 5, {}),
    ('mixed_3d', (8, 8, 8), 'mixed', 7, {}),
    ('planar_2d', (8, 16), 'planar', 5, {}),
    ('inverse_2d', (8, 8), 'inverse', 5, {}),
    ('inverse_real_3d', (8, 8, 8), 'inverse_real', 3, {}),
    ('rank1', (4096,), 'complex', 3, {}),
    ('rank1_real', (4096,), 'real', 3, {}),
    ('stockham_3d', (16, 16, 16), 'complex', 5, dict(method='stockham')),
    ('four_step_3d', (16, 16, 16), 'mixed', 5, dict(method='four_step')),
    ('block_2d', (16, 16), 'mixed', 5, dict(method='block')),
    ('overlap_3d', (16, 16, 16), 'complex', 4, dict(method='four_step', overlap_chunks=2)),
]


@pytest.mark.parametrize("case, shape, kind, n, kw", PARITY, ids=[c[0] for c in PARITY])
def test_engine_matches_reference_engine(mesh, jmesh, case, shape, kind, n, kw):
    from repro.serve import FFTEngine as RefEngine
    reqs, direction = _stream(kind, shape, n, seed=len(case))
    ref = RefEngine(shape, jmesh, max_coalesce=4, donate=False, schedule_table=None, **kw)
    eng = FFTEngine(shape, mesh, max_coalesce=4, schedule_table=None, **kw)
    rt = [ref.submit(x, direction=direction) for x in reqs]
    pt = [eng.submit(x, direction=direction) for x in reqs]
    ref.flush()
    outs = eng.flush()
    for x, r, t, o in zip(reqs, rt, pt, outs):
        assert t.done and t.result() is o
        got = t.result()
        assert _rel_l2(got, r.result()) <= RTOL
        if direction == 'fwd':
            real = not isinstance(x, tuple) and not np.iscomplexobj(x)
            assert eng.schedule(real) == ref.schedule(real)
            one = eng.plan_for(real).forward(from_numpy(x, device='cpu'))
        else:
            real = kind == 'inverse_real'
            one = eng.plan_for(real).inverse(from_numpy(x, device='cpu'))
        assert _same(got, one)
    widths = eng.dispatch_stats()['width_hist']
    assert sum(w * c for w, c in widths.items()) == n


def test_register_op_matches_reference_executor(mesh, jmesh):
    """Operator groups: a baked Green's-function style factor ('plan'
    form), real 16^3, coalesced; each result bitwise equal to the port's
    own ``apply`` of that request and within 1e-5 of the reference's
    fused-operator executor (runtime factor: the same spectrum)."""
    import jax
    import jax.numpy as jnp
    import repro.fft as rfft
    from repro.core.plan import PencilPlan
    from repro.fft import pencil as rpencil

    shape = (16, 16, 16)
    rng = np.random.default_rng(41)
    k = _rreq(rng, shape)
    reqs = [_rreq(rng, shape) for _ in range(5)]
    eng = FFTEngine(shape, mesh, max_coalesce=4, schedule_table=None)
    op = eng.register_op('conv', op=fft.spectral_mul, real=True, spectra=(k,))
    assert eng.registered_ops() == ['conv'] and eng.plan_for(op='conv') is op
    tickets = [eng.submit(x, op='conv') for x in reqs]
    eng.flush()
    plan = PencilPlan(shape=shape, mesh=jmesh, layout=('x', 'y', None), real=True,
                      method=op.method, kernel='reference', comm='all_to_all')
    fn, _, _ = rpencil.make_fused_op(plan, rfft.spectral_mul, batch_ndims=(1, 0))
    want = np.asarray(jax.jit(fn)(jnp.asarray(np.stack(reqs)), jnp.asarray(k)))
    for i, (x, t) in enumerate(zip(reqs, tickets)):
        assert torch.equal(t.result(), op.apply(from_numpy(x, device='cpu')))
        assert _rel_l2(t.result(), want[i]) <= RTOL
    assert op.bake_count == 1
    w, _ = eng.schedule(op='conv')
    assert eng.dispatch_stats()['groups'] == -(-len(reqs) // w)


def test_register_op_validation(mesh):
    eng = FFTEngine((8, 8), mesh, schedule_table=None)
    with pytest.raises(ValueError, match="runtime spectra"):
        eng.register_op('rt', op=fft.spectral_mul, n_spectra=1)
    with pytest.raises(ValueError, match="EITHER"):
        eng.register_op('x', fft.plan_op((8, 8), mesh, op=fft.spectral_mul,
                                         spectra=(np.ones((8, 8), np.float32),)),
                        shape=(8, 8))
    with pytest.raises(TypeError, match="plan_op"):
        eng.register_op('p', fft.plan((8, 8), mesh))
    with pytest.raises(ValueError, match="non-empty"):
        eng.register_op('', op=fft.spectral_mul)
    eng.register_op('ok', op=fft.spectral_mul, spectra=(np.ones((8, 5), np.complex64),),
                    spectra_form='spectrum')          # the identity
    with pytest.raises(ValueError, match="ONE real array"):
        eng.submit((np.zeros((8, 8)), np.zeros((8, 8))), op='ok')
    with pytest.raises(ValueError, match="take no direction"):
        eng.submit(np.zeros((8, 8), np.float32), op='ok', direction='inv')
    with pytest.raises(KeyError, match="no operator plan"):
        eng.submit(np.zeros((8, 8), np.float32), op='missing')
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    np.testing.assert_allclose(eng.submit(x, op='ok').result().numpy(), x, atol=1e-4)


# ---------------------------------------------------------------------------
# The reference's engine cases (tests/test_serve_fft.py)
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(29)


def test_engine_inverse_and_ticket_flush(mesh):
    shape = (8, 8)
    eng = FFTEngine(shape, mesh)
    x = _creq(RNG, shape)
    y = eng.submit(x).result()                 # result() flushes lazily
    back = eng.transform([y], direction='inv')[0]
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)
    # real inverse is inferred from the spectrum shape
    xr = _rreq(RNG, shape)
    spec = eng.submit(xr).result()
    assert tuple(spec.shape) == (8, 5)
    br = eng.transform([spec], direction='inv')[0]
    assert not br.is_complex()
    np.testing.assert_allclose(br.numpy(), xr, atol=1e-4)


@pytest.mark.parametrize("call, match", [
    (lambda e: e.submit(np.zeros((2, 2, 8, 8), np.complex64)), "owns batching"),
    (lambda e: e.submit(np.zeros((8, 8), np.complex64), direction='back'), "direction"),
    (lambda e: e.submit((np.zeros((8, 8)), np.zeros((8, 8))), real=True), "real plan forward"),
    (lambda e: e.submit(np.zeros((3, 3), np.complex64), direction='inv'),
     "pass real= explicitly"),
    (lambda e: e.submit(torch.zeros((8, 8), dtype=torch.complex128)), "complex64"),
], ids=['rank4', 'direction', 'planar_real', 'ambiguous_inverse', 'dtype'])
def test_engine_submit_validation(mesh, call, match):
    eng = FFTEngine((8, 8), mesh)
    with pytest.raises((ValueError, TypeError), match=match):
        call(eng)


@pytest.mark.parametrize("make, match", [
    (lambda m: FFTEngine((8, 8), m, batch_spec='x'), "batch_spec"),
    (lambda m: FFTEngine((8, 8)), "mesh is required"),
    (lambda m: FFTEngine((8, 8), m, max_coalesce=0), "max_coalesce"),
    (lambda m: FFTEngine((8, 8), m, watermark=0), "watermark"),
    (lambda m: FFTEngine((8, 8), m, max_wait_ms=-1), "max_wait_ms"),
    (lambda m: FFTEngine((8, 8), m, depth=0), "depth"),
    (lambda m: FFTEngine(fft.plan((8, 8), m, batch_spec='x')), "batch_spec"),
], ids=['batch_spec', 'no_mesh', 'max_coalesce', 'watermark', 'max_wait_ms', 'depth',
        'batch_spec_plan'])
def test_engine_construction_validation(mesh, make, match):
    with pytest.raises(ValueError, match=match):
        make(mesh)


@pytest.mark.parametrize("knob", [dict(max_wait_ms=2.0), dict(watermark=4),
                                  dict(background=True)],
                         ids=['max_wait_ms', 'watermark', 'background'])
def test_drainer_refused_on_a_multirank_mesh(knob):
    """On a mesh of several ranks position 0's drainer leads the others'
    over the mesh's gloo side group (a real 2 x 2 mesh serves with it in
    the gloo worker's ``serve`` suite). A mesh with no process group has
    no side group, so a drainer there still raises; and a mesh that only
    prices plans has no device to serve on."""
    four = FFTMesh({'x': 2, 'y': 2}, torch.device('cpu'))
    with pytest.raises(ValueError, match="needs the mesh's process group"):
        FFTEngine((8, 8), four, **knob)
    with pytest.raises(ValueError, match="prices plans and cannot serve"):
        FFTEngine((8, 8), abstract_fft_mesh(2, 2), **knob)


def test_engine_from_existing_plan(mesh):
    p = fft.rplan((8, 8, 8), mesh, method='stockham')
    eng = FFTEngine(p)
    assert eng.shape == (8, 8, 8)
    sp = eng.plan_for(True)
    assert sp.real and sp.method == 'stockham'
    # the complex sibling adopts the resolved settings
    cp = eng.plan_for(False)
    assert not cp.real and cp.method == 'stockham'
    x = _rreq(RNG, (8, 8, 8))
    got = eng.transform([x])[0]
    assert torch.equal(got, sp.forward(from_numpy(x, device='cpu')))


def test_engine_schedule_knobs(mesh):
    eng = FFTEngine((8, 8, 8), mesh, max_coalesce=4, overlap_chunks=2)
    w, c = eng.schedule(False)
    assert 1 <= w <= 4 and c in (1, 2)
    # a latency budget of ~zero forces the un-coalesced schedule
    eng2 = FFTEngine((8, 8, 8), mesh, latency_budget_us=1e-9)
    assert eng2.schedule(False) == (1, 1)
    with pytest.raises(ValueError, match="chunks"):
        eng.set_schedule(2, 4)


def test_engine_per_rank_functions_shared(mesh):
    """The port's analogue of the reference's shared executable cache:
    a plan holds one per-rank function a direction, whatever the group
    width, so serving again builds nothing."""
    eng = FFTEngine((8, 8), mesh, max_coalesce=4)
    eng.set_schedule(2, 1)
    reqs = [_creq(RNG, (8, 8)) for _ in range(5)]
    eng.transform(reqs)
    p = eng.plan_for(False)
    n0 = p.cached_executables
    eng.transform(reqs)
    assert p.cached_executables == n0 == 1


def test_flush_failure_requeues_instead_of_silent_none(mesh, monkeypatch):
    eng = FFTEngine((8, 8), mesh)
    x = _creq(RNG, (8, 8))
    t = eng.submit(x)

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(eng, '_run_group', boom)
    with pytest.raises(RuntimeError, match="boom"):
        eng.flush()
    assert not t.done
    assert sum(len(q) for q in eng._queues.values()) == 1
    with pytest.raises(RuntimeError, match="boom"):   # retried, re-raised
        t.result()
    monkeypatch.undo()
    got = t.result()                                  # retry succeeds
    assert torch.equal(got, eng.plan_for(False).forward(from_numpy(x, device='cpu')))


@pytest.mark.parametrize("where", ['flush', 'drainer'])
def test_injected_dispatch_faults_retry_to_the_same_bits(mesh, where):
    """A FaultPlan raising at ``engine.dispatch`` on the first group:
    the group's requests stay queued and runnable (the port consumes no
    operand, so there is nothing to snapshot), and the retry gives the
    bits of the per-request calls."""
    faults = FaultPlan([FaultPoint('engine.dispatch', 'raise', at=[0], note='injected')])
    xs = [_creq(RNG, (8, 8)) for _ in range(3)]
    kw = dict(max_wait_ms=1.0, retries=2) if where == 'drainer' else {}
    with FFTEngine((8, 8), mesh, max_coalesce=2, schedule_table=None, faults=faults,
                   **kw) as eng:
        eng.set_schedule(2, 1)
        tickets = [eng.submit(x) for x in xs]
        if where == 'flush':
            with pytest.raises(FaultInjected, match="injected"):
                eng.flush()
            assert not any(t.done for t in tickets)
            eng.flush()
        got = [t.result(timeout=60) for t in tickets]
    p = eng.plan_for(False)
    for x, g in zip(xs, got):
        assert torch.equal(g, p.forward(from_numpy(x, device='cpu')))
    assert faults.stats()['engine.dispatch']['fired'] == 1


def test_drainer_stall_fault_delays_but_serves(mesh):
    faults = FaultPlan([FaultPoint('engine.drainer', 'stall', at=[0], delay_s=0.05)])
    with FFTEngine((8, 8), mesh, max_wait_ms=1.0, faults=faults,
                   schedule_table=None) as eng:
        x = _creq(RNG, (8, 8))
        got = eng.submit(x).result(timeout=60)
    np.testing.assert_allclose(got.numpy(), np.fft.fftn(x), atol=1e-3)
    assert faults.stats()['engine.drainer']['fired'] == 1


def test_engine_autotune(mesh):
    eng = FFTEngine((8, 8), mesh, max_coalesce=2)
    reqs = [_creq(RNG, (8, 8)) for _ in range(4)]
    w, c = eng.autotune(reqs, repeats=1, widths=(1, 2), chunks=(1, 2))
    assert eng.schedule(False) == (w, c)
    assert w in (1, 2) and c in (1, 2)
    got = eng.transform([reqs[0]])[0]
    np.testing.assert_allclose(got.numpy(), np.fft.fftn(reqs[0]), atol=1e-3)


def test_autotune_persists_and_seeds_next_engine(mesh, tmp_path):
    path = str(tmp_path / "BENCH_torch_serve_schedule.json")
    eng = FFTEngine((8, 8), mesh, max_coalesce=2, schedule_table=path)
    reqs = [_creq(RNG, (8, 8)) for _ in range(4)]
    w, c = eng.autotune(reqs, repeats=1, widths=(1, 2), chunks=(1, 2), persist=True)
    tbl = pcost.ScheduleTable.load(path)
    row = tbl.lookup(dict(mesh.shape), (8, 8), 'complex', eng.plan_for(False).comm,
                     dtype='complex64', backend='cpu')
    assert (row['coalesce_width'], row['overlap_chunks']) == (w, c)
    assert row['us_per_request'] > 0 and row['backend'] == 'cpu' and 'kernel' not in row
    # a NEW engine on the same config seeds its pick from the table...
    eng2 = FFTEngine((8, 8), mesh, max_coalesce=2, schedule_table=path)
    assert eng2.schedule(False) == (w, c)
    got = eng2.transform([reqs[0]])[0]
    np.testing.assert_allclose(got.numpy(), np.fft.fftn(reqs[0]), atol=1e-3)
    # an engine whose knobs the row does not fit falls back to the model
    eng3 = FFTEngine((8, 8), mesh, max_coalesce=max(w - 1, 1), schedule_table=path)
    assert eng3.schedule(False)[0] <= max(w - 1, 1)


def test_autotune_op_rows_carry_the_op(mesh, tmp_path):
    path = str(tmp_path / "table.json")
    eng = FFTEngine((8, 8), mesh, max_coalesce=2, schedule_table=path)
    eng.register_op('conv', op=fft.spectral_mul, spectra=(np.ones((8, 8), np.float32),))
    reqs = [_rreq(RNG, (8, 8)) for _ in range(2)]
    w, c = eng.autotune(reqs, op='conv', repeats=1, widths=(1, 2), chunks=(1,),
                        persist=True)
    assert eng.schedule(op='conv') == (w, c)
    rows = pcost.ScheduleTable.load(path).rows()
    assert [r.get('op') for r in rows] == ['conv'] and rows[0]['kind'] == 'real'


def test_schedule_table_env_override(mesh, tmp_path, monkeypatch):
    path = str(tmp_path / "alt_schedules.json")
    pcost.persist_schedule_rows(
        [dict(mesh='1x1', shape='8x8', kind='complex', strategy='all_to_all',
              dtype='complex64', coalesce_width=2, overlap_chunks=1, us_per_request=1.0)],
        path)
    monkeypatch.setenv(pcost.SCHEDULE_ENV, path)
    eng = FFTEngine((8, 8), mesh, max_coalesce=4, comm='all_to_all')
    assert eng.schedule(False) == (2, 1)       # seeded from the env table
    monkeypatch.setenv(pcost.SCHEDULE_ENV, '')  # '' disables persistence
    assert pcost.schedule_table_path() is None
    assert pcost.persist_schedule_rows([]) is None


def test_donate_is_accepted_and_consumes_nothing(mesh):
    """The port's plans never consume an operand (``donates_input`` is
    False), with or without ``donate``: submitted tensors and numpy
    arrays stay intact and reusable."""
    for donate in (None, True, False):
        eng = FFTEngine((8, 8), mesh, donate=donate)
        assert eng.donate == (donate is not False)
        assert not eng.plan_for(False).donates_input
        xnp = _creq(RNG, (8, 8))
        keep = xnp.copy()
        xt = from_numpy(xnp, device='cpu')
        y1, y2 = eng.transform([xt, xnp])
        assert np.array_equal(xnp, keep) and np.array_equal(xt.numpy(), keep)
        assert torch.equal(y1, y2)


@pytest.mark.parametrize('planar', (False, True))
def test_a_request_in_the_ports_type_is_not_copied_on_the_host(planar):
    """A complex64 request (float32 planes) reaches the device through
    its transfer alone: no host copy of its bytes (numpy's allocations
    traced; ``meta`` stands for the card). Another dtype is converted
    once; on the CPU the tensor is a copy of its own."""
    import tracemalloc
    from repro_torch.weights import host_operand
    x = _creq(np.random.default_rng(3), (64, 64, 64))        # 2 MiB complex64
    req = (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)) if planar else x
    leaves = req if planar else (req,)
    got = host_operand(req)
    assert all(g is a for g, a in zip(got if planar else (got,), leaves))
    tracemalloc.start()
    try:
        t = from_numpy(req, device='meta')
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < x.nbytes // 16
    assert [tuple(a.shape) for a in (t if planar else (t,))] == [(64,) * 3] * len(leaves)
    wide = tuple(a.astype(np.float64) for a in req) if planar else x.astype(np.complex128)
    assert all(a.dtype in (np.float32, np.complex64) and a.flags.c_contiguous
               for a in (host_operand(wide) if planar else (host_operand(wide),)))
    own = from_numpy(req, device='cpu')
    for a, b in zip(own if planar else (own,), leaves):
        assert np.array_equal(a.numpy(), b) and not np.shares_memory(a.numpy(), b)


# ---------------------------------------------------------------------------
# The reference's drainer cases (tests/test_serve_drainer.py)
# ---------------------------------------------------------------------------

def test_deadline_serves_without_flush(mesh):
    with FFTEngine((8, 8), mesh, max_wait_ms=5.0, watermark=10**6,
                   schedule_table=None) as eng:
        x = _creq(RNG, (8, 8))
        t = eng.submit(x)
        got = t.result(timeout=60)            # no flush() anywhere
        np.testing.assert_allclose(got.numpy(), np.fft.fftn(x), atol=1e-3)
        assert t.done


def test_watermark_serves_without_flush(mesh):
    with FFTEngine((8, 8), mesh, watermark=2, schedule_table=None) as eng:
        xs = [_creq(RNG, (8, 8)) for _ in range(2)]
        t0 = eng.submit(xs[0])
        time.sleep(0.05)
        assert not t0.done                    # below watermark: queued
        t1 = eng.submit(xs[1])                # trips the watermark
        for t, x in zip((t0, t1), xs):
            np.testing.assert_allclose(t.result(timeout=60).numpy(), np.fft.fftn(x),
                                       atol=1e-3)


def test_set_drainer_retargets_triggers(mesh):
    with FFTEngine((8, 8), mesh, watermark=10**6, schedule_table=None) as eng:
        t = eng.submit(_creq(RNG, (8, 8)))
        time.sleep(0.05)
        assert not t.done
        eng.set_drainer(watermark=1)          # a queue of one is now ripe
        t.result(timeout=60)
        with pytest.raises(ValueError, match="watermark"):
            eng.set_drainer(watermark=0)
        with pytest.raises(ValueError, match="max_wait_ms"):
            eng.set_drainer(max_wait_ms=-1)


def test_close_drains_and_submit_after_close_raises(mesh):
    eng = FFTEngine((8, 8), mesh, watermark=10**6, schedule_table=None)
    xs = [_creq(RNG, (8, 8)) for _ in range(3)]
    tickets = [eng.submit(x) for x in xs]
    assert eng.queue_depths() == {((8, 8), False, 'fwd', 'complex64', False): 3}
    eng.close()                               # final pass drains the queue
    for t, x in zip(tickets, xs):
        np.testing.assert_allclose(t.result(timeout=60).numpy(), np.fft.fftn(x), atol=1e-3)
    with pytest.raises(RuntimeError, match="close"):
        eng.submit(xs[0])
    eng.close()                               # idempotent
    assert eng.closed


def test_foreground_close_flushes(mesh):
    eng = FFTEngine((8, 8), mesh, schedule_table=None)
    x = _creq(RNG, (8, 8))
    t = eng.submit(x)
    eng.close()
    assert t.done
    with pytest.raises(RuntimeError, match="close"):
        eng.submit(x)


def test_mixed_shapes_and_kinds_no_flush(mesh):
    """One background engine serves three shapes, complex and real,
    forward and inverse, with no explicit flush(). (The reference's own
    case fails on the installed jax through its donation; the port
    donates nothing.)"""
    shapes = [(8, 8), (4, 4), (8, 8, 8)]
    with FFTEngine(mesh=mesh, max_wait_ms=5.0, schedule_table=None) as eng:
        tickets, want = [], []
        for shape in shapes:
            xc, xr = _creq(RNG, shape), _rreq(RNG, shape)
            tickets.append(eng.submit(xc))
            want.append(np.fft.fftn(xc))
            tickets.append(eng.submit(xr))
            want.append(np.fft.rfftn(xr))
        for t, w in zip(tickets, want):
            np.testing.assert_allclose(t.result(timeout=120).numpy(), w,
                                       atol=3e-4 * np.max(np.abs(w)))
        spec = tickets[0].result()
        back = eng.submit(spec, direction='inv').result(timeout=120)
        np.testing.assert_allclose(back.numpy(), np.fft.ifftn(spec.numpy()), atol=1e-4)
        rback = eng.submit(tickets[1].result(), direction='inv').result(timeout=120)
        assert not rback.is_complex() and tuple(rback.shape) == shapes[0]


def test_engine_without_default_shape_requires_operands(mesh):
    eng = FFTEngine(mesh=mesh, schedule_table=None)
    with pytest.raises(ValueError, match="no default shape"):
        eng.schedule()
    x = _creq(RNG, (4, 4))
    got = eng.transform([x])[0]
    np.testing.assert_allclose(got.numpy(), np.fft.fftn(x), atol=1e-3)
    assert eng.serving_shapes() == [((4, 4), False)]


def test_transform_below_watermark_makes_progress(mesh):
    with FFTEngine((8, 8), mesh, watermark=8, schedule_table=None) as eng:
        x = _creq(RNG, (8, 8))
        got = eng.transform([x], timeout=60)[0]
        np.testing.assert_allclose(got.numpy(), np.fft.fftn(x), atol=1e-3)


def test_dropped_engine_is_reclaimed(mesh):
    """An engine dropped WITHOUT close() must not pin its drainer thread
    (and the whole plan cache) forever."""
    before = threading.active_count()
    eng = FFTEngine((8, 8), mesh, max_wait_ms=5.0, schedule_table=None)
    t = eng.submit(_creq(RNG, (8, 8)))
    t.result(timeout=60)
    ref = weakref.ref(eng)
    del eng, t
    deadline = time.time() + 30
    while time.time() < deadline and (ref() is not None
                                      or threading.active_count() > before):
        gc.collect()
        time.sleep(0.2)
    assert ref() is None
    assert threading.active_count() == before


def test_drainer_failure_requeues_then_retry_succeeds(mesh, monkeypatch):
    eng = FFTEngine((8, 8), mesh, max_wait_ms=5.0, retries=3, schedule_table=None)
    real_run = eng._run_group
    fails = {'left': 2}

    def flaky(*a, **k):
        if fails['left'] > 0:
            fails['left'] -= 1
            raise RuntimeError("injected drainer fault")
        return real_run(*a, **k)

    monkeypatch.setattr(eng, '_run_group', flaky)
    with eng:
        x = _creq(RNG, (8, 8))
        got = eng.submit(x).result(timeout=60)   # retried, never dropped
        np.testing.assert_allclose(got.numpy(), np.fft.fftn(x), atol=1e-3)
    assert fails['left'] == 0


def test_drainer_persistent_failure_surfaces_on_result(mesh, monkeypatch):
    eng = FFTEngine((8, 8), mesh, max_wait_ms=5.0, retries=1, schedule_table=None)

    def boom(*a, **k):
        raise RuntimeError("persistent drainer fault")

    monkeypatch.setattr(eng, '_run_group', boom)
    with eng:
        t = eng.submit(_creq(RNG, (8, 8)))
        with pytest.raises(RuntimeError, match="persistent drainer fault"):
            t.result(timeout=60)
    assert not t.done and t.failed


def test_bystander_groups_survive_culprit_failure(mesh, monkeypatch):
    eng = FFTEngine((8, 8), mesh, max_wait_ms=5.0, retries=1, schedule_table=None)
    real_run = eng._run_group

    def selective(plan, direction, planar, ops, *a, **k):
        if plan.real:
            raise RuntimeError("culprit kind")
        return real_run(plan, direction, planar, ops, *a, **k)

    monkeypatch.setattr(eng, '_run_group', selective)
    with eng:
        xc = _creq(RNG, (8, 8))
        tc = eng.submit(xc)
        tr = eng.submit(_rreq(RNG, (8, 8)))
        with pytest.raises(RuntimeError, match="culprit kind"):
            tr.result(timeout=60)
        np.testing.assert_allclose(tc.result(timeout=60).numpy(), np.fft.fftn(xc),
                                   atol=1e-3)


def test_result_timeout(mesh):
    from repro_torch.serve import ResultTimeout
    with FFTEngine((8, 8), mesh, watermark=10**6, schedule_table=None) as eng:
        t = eng.submit(_creq(RNG, (8, 8)))          # never ripe before close
        with pytest.raises(ResultTimeout):
            t.result(timeout=0.05)
    assert t.done                                   # close() drained it


def test_done_callbacks_run_once_settled(mesh):
    seen = []
    eng = FFTEngine((8, 8), mesh, schedule_table=None)
    t = eng.submit(_creq(RNG, (8, 8)))
    t.add_done_callback(lambda tk: seen.append(tk.done))
    eng.flush()
    t.add_done_callback(lambda tk: seen.append('late'))
    assert seen == [True, 'late']


def test_plan_lru_eviction_order_and_rebuild_once(mesh):
    evicted = []
    eng = FFTEngine(mesh=mesh, max_plans=2, schedule_table=None,
                    on_plan_evict=lambda key, plan: evicted.append(key))
    for shape in ((8, 8), (4, 4), (16, 16)):
        eng.transform([_creq(RNG, shape)])
    assert evicted == [((8, 8), False)]
    assert eng.serving_shapes() == [((4, 4), False), ((16, 16), False)]
    assert eng.plan_builds[((8, 8), False)] == 1
    eng.transform([_creq(RNG, (8, 8))])
    eng.transform([_creq(RNG, (8, 8))])
    assert eng.plan_builds[((8, 8), False)] == 2
    assert evicted == [((8, 8), False), ((4, 4), False)]


def test_plan_cache_byte_budget_evicts(mesh):
    eng = FFTEngine(mesh=mesh, plan_cache_bytes=1, schedule_table=None)
    eng.transform([_creq(RNG, (8, 8))])
    assert len(eng._states) == 1               # sole entry may bust budget
    eng.transform([_creq(RNG, (4, 4))])
    assert len(eng._states) == 1               # old shape evicted
    assert eng.serving_shapes() == [((4, 4), False)]


def test_inverse_inference_never_evicts_served_plans(mesh):
    eng = FFTEngine((8, 8), mesh, max_plans=2, schedule_table=None)
    y44 = eng.transform([_creq(RNG, (4, 4))])[0]
    eng.transform([_creq(RNG, (8, 8))])
    cached = eng.serving_shapes()
    back = eng.transform([y44], direction='inv')[0]
    np.testing.assert_allclose(back.numpy(), np.fft.ifftn(y44.numpy()), atol=1e-4)
    assert set(eng.serving_shapes()) == set(cached)
    spec = np.zeros((8, 5), np.complex64)
    t = eng.submit(spec, direction='inv')
    assert tuple(t.result().shape) == (8, 8)


def test_autotune_persist_disabled_raises(mesh):
    eng = FFTEngine((8, 8), mesh, max_coalesce=2, schedule_table=None)
    with pytest.raises(ValueError, match="persist"):
        eng.autotune([_creq(RNG, (8, 8))], repeats=1, widths=(1,), chunks=(1,),
                     persist=True)


def test_set_schedule_resets_entry_bytes(mesh):
    eng = FFTEngine((8, 8), mesh, schedule_table=None)
    eng.transform([_creq(RNG, (8, 8))])
    key = ((8, 8), False)
    before = eng._states.nbytes(key)
    assert before == eng.plan_for(False).operand_nbytes() * 2
    w, _ = eng.schedule(False)
    eng.set_schedule(max(w, 2), 2)             # clears the group shapes
    assert eng._states.nbytes(key) == 0
    eng.transform([_creq(RNG, (8, 8))])        # re-grows from zero
    assert 0 < eng._states.nbytes(key) <= 2 * before


def test_results_are_views_of_the_group_output(mesh):
    """A group's results are views of its batched output (no per-request
    copy): the results of one group share its storage."""
    eng = FFTEngine((8, 8), mesh, schedule_table=None)
    eng.set_schedule(2, 1)
    a, b = eng.transform([_creq(RNG, (8, 8)), _creq(RNG, (8, 8))])
    assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def test_repr_names_the_schedules(mesh):
    eng = FFTEngine((8, 8), mesh, schedule_table=None)
    w, c = eng.schedule(False)
    assert f"'8x8': 'w={w},c={c}'" in repr(eng)


# ---------------------------------------------------------------------------
# gloo 2 x 2 (tests/_torch_multirank_worker.py --suite serve)
# ---------------------------------------------------------------------------

def _serve_reference(path, jmesh) -> None:
    """The JAX package's engine on one device on the serve suite's
    requests (its fused-operator executor for the op requests)."""
    import jax
    import jax.numpy as jnp
    import repro.fft as rfft
    from repro.core.plan import PencilPlan
    from repro.fft import pencil as rpencil
    from repro.serve import FFTEngine as RefEngine

    ops = serve_operands()
    ref = RefEngine(SERVE_SHAPE, jmesh, max_coalesce=4, donate=False, schedule_table=None)
    tickets = {kind: [ref.submit(x) for x in ops[kind]]
               for kind, _ in SERVE_STREAM if kind != 'op'}
    ref.flush()
    out = {kind: [_np(t.result()) for t in ts] for kind, ts in tickets.items()}
    out['inverse'] = [_np(y) for y in ref.transform(out['complex'], direction='inv')]
    plan = PencilPlan(shape=SERVE_SHAPE, mesh=jmesh, layout=('x', 'y', None), real=True,
                      method=ref.plan_for(True).method, kernel='reference',
                      comm='all_to_all')
    fn, _, _ = rpencil.make_fused_op(plan, rfft.spectral_mul, batch_ndims=(1, 0))
    out['op'] = list(np.asarray(jax.jit(fn)(jnp.asarray(np.stack(ops['op'])),
                                            jnp.asarray(ops['k']))))
    np.savez(path, **{f'serve_{k}_{j}': y for k, ys in out.items() for j, y in enumerate(ys)})


@pytest.fixture(scope='module')
def gloo_serve(tmp_path_factory, jmesh):
    tmp = tmp_path_factory.mktemp('serve')
    _serve_reference(tmp / 'reference.npz', jmesh)
    with socket.socket() as sk:
        sk.bind(('localhost', 0))
        port = sk.getsockname()[1]
    subprocess.run([sys.executable, os.path.join(HERE, '_torch_multirank_worker.py'),
                    str(tmp / 'serve.json'), str(port), '--suite', 'serve',
                    '--ref', str(tmp / 'reference.npz')], check=True, timeout=300)
    with open(tmp / 'serve.json') as fh:
        return json.load(fh)['serve']


@pytest.mark.parametrize("kind", ['complex', 'real', 'planar', 'inverse', 'op'])
def test_gloo_2x2_flush_matches_reference_engine(gloo_serve, kind):
    """Each rank's blocks of the engine's results against the same
    blocks of the reference engine's, relative L2 over all ranks."""
    assert gloo_serve[f'l2_{kind}'] <= RTOL


def test_gloo_2x2_flush_is_bitwise_per_request(gloo_serve):
    """Every result on every rank bitwise equal to that rank's
    per-request call; the groups paired up across the ranks."""
    assert gloo_serve['bitwise'] and gloo_serve['shape_ok']
    (wc, cc), (wr, cr), (wo, co), groups = gloo_serve['resolved']
    n = dict(SERVE_STREAM)
    assert groups == (-(-n['complex'] // wc) + -(-n['real'] // wr) + -(-n['planar'] // wc)
                      + -(-n['op'] // wo) + -(-n['complex'] // wc))


def test_gloo_2x2_refuses_the_drainer(gloo_serve):
    """The name predates the multi-rank drainer. On gloo 2 x 2 a background
    engine (``max_wait_ms``, no ``flush()``) now serves the same stream,
    every result bitwise equal to the same rank's per-request call, its
    groups in one order on every rank."""
    assert gloo_serve['drainer_bitwise'] and gloo_serve['drainer_paired']
