"""The port's resilient service under faults and contention, on one CPU
rank over real unix sockets.

In-process ports of the JAX package's subprocess workers: the five cases
of ``tests/_service_chaos_worker.py`` (exactly-once under a seeded fault
plan, fairness under a flood, idempotent resubmit with re-attach and
reaping, brownout, hot reload) and the three of
``tests/_serve_service_worker.py`` (multi-tenant bit identity, quota
isolation, SLO ordering), at small shapes. Every served output is held
bitwise against the port's own per-request plan call, computed before
any traffic. Every wait carries a timeout, so a hang fails the test.
"""
import os
import threading
import time

import numpy as np
import pytest

from repro_torch.launch.mesh import make_fft_mesh
from repro_torch.serve import (BrownoutBreaker, FaultPlan, FaultPoint, FFTClient, FFTEngine,
                               FFTService, RetryAfter, SLOClass, TenantConfig,
                               default_slo_classes)
from repro_torch.weights import from_numpy

WAIT = 60.0


@pytest.fixture()
def eng():
    e = FFTEngine(mesh=make_fft_mesh(1, 1, device='cpu'), max_wait_ms=20.0,
                  schedule_table=None)
    yield e
    e.close()


@pytest.fixture()
def sock(tmp_path):
    return str(tmp_path / 's.sock')


def _creq(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _ref(eng, x, direction='fwd'):
    """The request through the engine's plan alone: the bits a served
    result must have."""
    real = direction == 'fwd' and not np.iscomplexobj(x)
    p = eng.plan_for(real, shape=x.shape)
    return (p.forward if direction == 'fwd' else p.inverse)(from_numpy(x, 'cpu')).numpy()


def _stream(seed, count, shapes):
    """(direction, operand) pairs: rotating shapes, complex and real
    forwards, a complex inverse every 5th request."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        shape = shapes[i % len(shapes)]
        if i % 5 == 4:
            out.append(('inv', _creq(rng, shape)))
        elif i % 2:
            out.append(('fwd', _creq(rng, shape)))
        else:
            out.append(('fwd', rng.standard_normal(shape).astype(np.float32)))
    return out


def _connect(sock, tenant, attempts=6, **kw):
    """Client construction with retry: an armed reader/writer fault can
    kill the handshake itself; a resilient caller redials."""
    last = None
    for i in range(attempts):
        try:
            return FFTClient(sock, tenant=tenant, **kw)
        except (ConnectionError, OSError) as exc:
            last = exc
            time.sleep(0.02 * (i + 1))
    raise AssertionError(f"could not connect as {tenant!r}: {last}")


def _wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _join(threads, timeout=300):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "client thread wedged (hang)"


# ---------------------------------------------------------------------------
# tests/_service_chaos_worker.py
# ---------------------------------------------------------------------------

def test_chaos_soak_exactly_once_and_bit_identical(eng, sock):
    """Connection drops, truncated result frames, slow reads, accept
    delays, drainer stalls and clock skew fire mid-stream while three
    tenants run mixed streams through ``FFTClient.transform``: nothing
    hangs, every operand is served exactly once and bit-identical."""
    shapes = [(8, 8, 8), (4, 4, 4)]
    streams = {n: _stream(s, 12, shapes) for n, s in (('alice', 11), ('bob', 12), ('carol', 13))}
    refs = {(n, i): _ref(eng, x, d) for n, st in streams.items() for i, (d, x) in enumerate(st)}
    plan = FaultPlan(seed=7, points=[
        FaultPoint('service.writer', 'drop', p=0.06, limit=5),
        FaultPoint('service.writer', 'truncate', p=0.04, limit=3),
        FaultPoint('service.reader', 'drop', p=0.02, limit=3),
        FaultPoint('service.reader', 'delay', p=0.05, delay_s=0.02, limit=10),
        FaultPoint('service.accept', 'delay', p=0.3, delay_s=0.01, limit=5),
        FaultPoint('engine.drainer', 'stall', every=25, delay_s=0.05, limit=4),
        FaultPoint('policy.clock', 'skew', every=40, skew_s=5.0, limit=3),
    ])
    svc = FFTService(engine=eng, persist_policy=False, faults=plan,
                     tenants=[TenantConfig(n, max_inflight=16) for n in streams]).start(sock)
    failures = []

    def run(name, stream):
        try:
            with _connect(sock, name) as c:
                for i, (d, x) in enumerate(stream):
                    [got] = c.transform([x], direction=d, real=None if d == 'fwd' else False,
                                        timeout=90.0, deadline_s=90.0)
                    if not np.array_equal(got, refs[(name, i)]):
                        raise AssertionError(f"{name}[{i}]: served output != plan call")
        except BaseException as exc:
            failures.append((name, repr(exc)))
    _join([threading.Thread(target=run, args=kv) for kv in streams.items()])
    assert not failures, failures
    m = svc.metrics()
    for name in streams:
        tm = m['tenants'][name]
        assert tm['completed'] == 12 and tm['failed'] == 0, (name, tm)
    stats = m['service']['faults']
    assert plan.total_fired() > 0 and stats['service.writer']['fired'] > 0, stats
    assert stats['engine.drainer']['fired'] > 0, stats
    assert plan.skew_s('policy.clock') > 0, "skew never accumulated"
    svc.close(drain=True, timeout=WAIT)


def test_fairness_under_flood(eng, sock):
    """A tenant flooding 3x the victim's load cannot push the
    equal-weight victim's completed share below 40% (weighted deficit
    round-robin over a scheduler window of 2)."""
    rng = np.random.default_rng(21)
    shape = (8, 8, 8)
    victim = [_creq(rng, shape) for _ in range(16)]
    victim_refs = [_ref(eng, x) for x in victim]
    flood_x = _creq(rng, shape)
    flood_ref = _ref(eng, flood_x)
    eng.set_drainer(watermark=2, max_wait_ms=5.0)
    svc = FFTService(engine=eng, persist_policy=False, policy=None, max_inflight=256,
                     sched_window=2, tenants=[TenantConfig('victim', max_inflight=64),
                                              TenantConfig('flood', max_inflight=64)]).start(sock)
    with _connect(sock, 'flood') as cf, _connect(sock, 'victim') as cv:
        flood_tix = [cf.submit(flood_x) for _ in range(48)]
        victim_tix = [cv.submit(x) for x in victim]
        for t, ref in zip(victim_tix, victim_refs):
            assert np.array_equal(t.result(timeout=WAIT), ref)
        m = svc.metrics()
        done_v = m['tenants']['victim']['completed']
        done_f = m['tenants']['flood']['completed']
        assert done_v / (done_v + done_f) >= 0.40, (done_v, done_f)
        sched = m['service']['scheduler']
        assert sched['window'] == 2 and sched['shares']['victim'] >= 0.40, sched
        for t in flood_tix:
            assert np.array_equal(t.result(timeout=WAIT), flood_ref)
    svc.close(drain=True, timeout=WAIT)


def test_idempotent_resubmit_reattach_and_reaping(eng, sock):
    """A scripted drop of the first RESULT frame forces a reconnect and
    resubmit: the result is re-delivered, not recomputed. A mid-flight
    drop re-attaches delivery to the new connection. Idle connections
    are reaped on the heartbeat timeout; keepalive clients survive."""
    rng = np.random.default_rng(31)
    xs = [_creq(rng, (8, 8, 8)) for _ in range(4)]
    refs = [_ref(eng, x) for x in xs]
    eng.set_drainer(watermark=1, max_wait_ms=5.0)
    plan = FaultPlan(points=[FaultPoint('service.writer', 'drop', at=[1])])
    # the tenant's class waits a minute before its deadline flushes a
    # request (the default 'standard' waits 20 ms): B's request must stay
    # queued until the test flushes it, however slowly the resubmit comes
    # on a loaded host; A and C flush at the drainer's watermark of 1
    slos = dict(default_slo_classes(),
                standard=SLOClass('standard', deadline_ms=240_000.0, max_wait_ms=60_000.0))
    svc = FFTService(engine=eng, persist_policy=False, policy=None, faults=plan,
                     heartbeat_timeout_s=1.0, slo_classes=slos,
                     tenants=[TenantConfig('idem', max_inflight=16)]).start(sock)

    # A: dropped RESULT -> reconnect -> re-delivered, not recomputed
    c1 = FFTClient(sock, tenant='idem')
    [got] = c1.transform([xs[0]], timeout=WAIT, deadline_s=WAIT)
    assert np.array_equal(got, refs[0])
    assert c1.reconnects == 1, c1.reconnects
    m = svc.metrics()
    d = m['service']['dedup']
    assert d['redelivered'] == 1 and d['hits'] == 1, d
    assert m['tenants']['idem']['scheduled'] == 1 and m['tenants']['idem']['completed'] == 1

    # B: mid-flight drop -> resubmit re-ATTACHES delivery
    eng.set_drainer(watermark=10**6, max_wait_ms=None)
    c1.submit(xs[1], key='manual/7')
    _wait_until(lambda: svc._inflight_total >= 1)
    c1.close()
    c2 = FFTClient(sock, tenant='idem')
    t2 = c2.submit(xs[1], key='manual/7')
    _wait_until(lambda: svc.metrics()['service']['dedup']['reattached'] == 1)
    eng.flush()
    assert np.array_equal(t2.result(timeout=WAIT), refs[1])
    assert svc.metrics()['tenants']['idem']['scheduled'] == 2
    c2.close()
    eng.set_drainer(watermark=1, max_wait_ms=5.0)

    # C: idle connections reaped; keepalive clients survive
    c3 = FFTClient(sock, tenant='idem')
    c4 = FFTClient(sock, tenant='idem', heartbeat_s=0.2)
    time.sleep(1.6)
    [g3] = c3.transform([xs[2]], timeout=WAIT, deadline_s=WAIT)
    assert np.array_equal(g3, refs[2])
    assert c3.reconnects >= 1, "idle connection was never reaped"
    [g4] = c4.transform([xs[3]], timeout=WAIT, deadline_s=WAIT)
    assert np.array_equal(g4, refs[3])
    assert c4.reconnects == 0, "keepalive client should have survived"
    c3.close()
    c4.close()
    svc.close(drain=True, timeout=WAIT)


def test_brownout_trips_sheds_batch_and_recovers(eng, sock):
    """Consecutive injected dispatch failures trip the breaker: batch
    sheds typed ``RETRY_AFTER('brownout')`` while interactive serves;
    after the cooldown a half-open probe closes it and the failed keys
    recompute (failures are never cached)."""
    rng = np.random.default_rng(41)
    xb, xl = _creq(rng, (8, 8, 8)), _creq(rng, (8, 8, 8))
    rb, rl = _ref(eng, xb), _ref(eng, xl)
    eng.set_drainer(watermark=1, max_wait_ms=2.0)
    # the engine retries a blamed group once (retries=1): six scripted
    # fires = three consecutive ticket failures
    plan = FaultPlan(points=[FaultPoint('engine.dispatch', 'raise', at=[0, 1, 2, 3, 4, 5])])
    breaker = BrownoutBreaker(failure_threshold=3, overload_trip=10**6, cooldown_s=0.5,
                              probe_quota=1)
    svc = FFTService(engine=eng, persist_policy=False, policy=None, faults=plan,
                     brownout=breaker,
                     tenants=[TenantConfig('bat', slo='batch', max_inflight=16),
                              TenantConfig('live', slo='interactive', max_inflight=16)]
                     ).start(sock)
    with FFTClient(sock, tenant='bat') as cb, FFTClient(sock, tenant='live') as cl:
        for i in range(3):
            with pytest.raises(RuntimeError, match='FaultInjected'):
                cb.submit(xb, key=f'k{i}').result(timeout=WAIT)
        with pytest.raises(RetryAfter) as ei:
            cb.submit(xb).result(timeout=WAIT)
        assert ei.value.reason == 'brownout' and ei.value.retry_after_ms >= 1.0
        assert np.array_equal(cl.submit(xl).result(timeout=WAIT), rl)
        m = svc.metrics()
        br = m['service']['breaker']
        assert br['state'] == 'open' and br['transitions'].get('closed_to_open') == 1, br
        assert m['tenants']['bat']['rejected'].get('brownout', 0) >= 1
        assert m['tenants']['live']['rejected'] == {}
        time.sleep(0.6)                        # past the cooldown
        for i in range(3):
            assert np.array_equal(cb.submit(xb, key=f'k{i}').result(timeout=WAIT), rb)
        m = svc.metrics()
        br = m['service']['breaker']
        assert br['state'] == 'closed', br
        assert br['transitions'].get('open_to_half_open') == 1, br
        assert br['transitions'].get('half_open_to_closed') == 1, br
        assert m['tenants']['bat']['completed'] == 3 and m['tenants']['bat']['failed'] == 3
    svc.close(drain=True, timeout=WAIT)


def test_hot_reload_reweights_and_retires_atomically(eng, sock):
    """An admin RELOAD bumps the generation, re-weights a live tenant and
    retires a missing one, whose request admitted before the reload still
    serves; non-admins are refused."""
    rng = np.random.default_rng(51)
    xo, xw = _creq(rng, (8, 8, 8)), _creq(rng, (8, 8, 8))
    ro, rw = _ref(eng, xo), _ref(eng, xw)
    eng.set_drainer(watermark=10**6, max_wait_ms=None)
    svc = FFTService(engine=eng, persist_policy=False, policy=None,
                     tenants=[TenantConfig('root', admin=True), TenantConfig('w1'),
                              TenantConfig('old')]).start(sock)
    c_old = FFTClient(sock, tenant='old')
    held = c_old.submit(xo)
    _wait_until(lambda: svc._inflight_total >= 1)
    with FFTClient(sock, tenant='root') as c_root, FFTClient(sock, tenant='w1') as c_w1:
        new_cfgs = [TenantConfig('root', admin=True),
                    TenantConfig('w1', weight=5.0, max_inflight=32)]
        with pytest.raises(RuntimeError, match='admin'):
            c_w1.reload(new_cfgs)
        ok = c_root.reload(new_cfgs, retire_missing=True)
        assert ok['generation'] == 1 and sorted(ok['tenants']) == ['root', 'w1'], ok
        m = svc.metrics()
        assert m['service']['reload_generation'] == 1
        assert m['tenants']['w1']['weight'] == 5.0
        assert m['tenants']['old']['retired'] is True
        with pytest.raises(PermissionError, match='retired'):
            FFTClient(sock, tenant='old')
        with pytest.raises(RuntimeError, match='retired'):
            c_old.submit(xo).result(timeout=WAIT)
        eng.flush()
        assert np.array_equal(held.result(timeout=WAIT), ro)
        eng.set_drainer(watermark=1, max_wait_ms=5.0)
        assert np.array_equal(c_w1.submit(xw).result(timeout=WAIT), rw)
        assert c_root.reload(new_cfgs)['generation'] == 2
    c_old.close()
    svc.close(drain=True, timeout=WAIT)


# ---------------------------------------------------------------------------
# tests/_serve_service_worker.py
# ---------------------------------------------------------------------------

def test_multi_tenant_mixed_streams_bit_identical(eng, sock):
    """Three tenants stream mixed shapes and kinds concurrently; every
    served output is bitwise the per-request plan call."""
    shapes = [(8, 8, 8), (4, 4, 4), (16, 16)]
    streams = {n: _stream(s, 10, shapes) for n, s in (('alice', 1), ('bob', 2), ('carol', 3))}
    refs = {(n, i): _ref(eng, x, d) for n, st in streams.items() for i, (d, x) in enumerate(st)}
    svc = FFTService(engine=eng, persist_policy=False,
                     tenants=[TenantConfig(n, max_inflight=16) for n in streams]).start(sock)
    failures = []

    def run(name, stream):
        try:
            with FFTClient(sock, tenant=name) as c:
                tickets = [c.submit(x, direction=d, real=None if d == 'fwd' else False)
                           for d, x in stream]
                for i, t in enumerate(tickets):
                    if not np.array_equal(t.result(timeout=WAIT), refs[(name, i)]):
                        raise AssertionError(f"{name}[{i}]: served output != plan call")
                c.drain(timeout=WAIT)
        except BaseException as exc:
            failures.append((name, repr(exc)))
    _join([threading.Thread(target=run, args=kv) for kv in streams.items()])
    assert not failures, failures
    with FFTClient(sock, tenant='alice') as probe:
        m = probe.metrics()
    for name in streams:
        tm = m['tenants'][name]
        assert tm['completed'] == 10 and tm['failed'] == 0 and tm['rejected'] == {}, tm
    assert m['service']['dispatch']['groups'] > 0
    svc.close(drain=True, timeout=WAIT)


def test_quota_isolation_under_a_flood(eng, sock):
    """A tenant fire-hosing past its quota of 2 sees typed backpressure
    while a well-behaved tenant keeps serving with no rejection and an
    un-degraded p99 (10x its baseline + 500 ms)."""
    rng = np.random.default_rng(53)
    shape = (8, 8, 8)
    good = [_creq(rng, shape) for _ in range(8)]
    good_refs = [_ref(eng, x) for x in good]
    flood_x = _creq(rng, shape)
    svc = FFTService(engine=eng, persist_policy=False,
                     tenants=[TenantConfig('good', max_inflight=8),
                              TenantConfig('flood', max_inflight=2)]).start(sock)

    def serve_good(latencies):
        with FFTClient(sock, tenant='good') as c:
            for x, ref in zip(good, good_refs):
                t0 = time.monotonic()
                got = c.submit(x).result(timeout=WAIT)
                latencies.append((time.monotonic() - t0) * 1e3)
                assert np.array_equal(got, ref)
    base, under = [], []
    serve_good(base)
    stats = {'rejected': 0, 'served': 0}

    def run_flood():
        with FFTClient(sock, tenant='flood') as c:
            for t in [c.submit(flood_x) for _ in range(60)]:
                try:
                    t.result(timeout=WAIT)
                    stats['served'] += 1
                except RetryAfter as ra:
                    assert ra.reason in ('tenant_quota', 'rate') and ra.retry_after_ms > 0
                    stats['rejected'] += 1
    _join([threading.Thread(target=run_flood),
           threading.Thread(target=serve_good, args=(under,))])
    assert stats['rejected'] > 0 and stats['served'] >= 2, stats

    def p99(v):
        s = sorted(v)
        return s[min(len(s) - 1, int(0.99 * len(s)))]
    with FFTClient(sock, tenant='good') as probe:
        m = probe.metrics()
    assert m['tenants']['good']['rejected'] == {}, m['tenants']['good']
    assert m['tenants']['flood']['rejected'], m['tenants']['flood']
    assert len(under) == 8 and p99(under) <= 10.0 * p99(base) + 500.0, (base, under)
    svc.close(drain=True, timeout=WAIT)


def test_slo_classes_order_the_queue(eng, sock):
    """Batch requests sit out a 30 s coalescing wait until one rush
    request's 1 ms deadline ripens the shared queue: the whole group
    dispatches promptly."""
    rng = np.random.default_rng(57)
    xs = [_creq(rng, (8, 8, 8)) for _ in range(4)]
    refs = [_ref(eng, x) for x in xs]
    eng.set_drainer(watermark=16, max_wait_ms=None)
    svc = FFTService(engine=eng, persist_policy=False, policy=None,
                     slo_classes={'batch': SLOClass('batch', deadline_ms=120000,
                                                    max_wait_ms=30000),
                                  'rush': SLOClass('rush', deadline_ms=200, max_wait_ms=1.0)},
                     tenants=[TenantConfig('mix', max_inflight=8, slo='batch')]).start(sock)
    with FFTClient(sock, tenant='mix') as c:
        t0 = time.monotonic()
        batch = [c.submit(x) for x in xs[:3]]
        time.sleep(0.3)
        assert not any(t.done for t in batch), "batch dispatched before any trigger"
        rush = c.submit(xs[3], slo='rush')
        outs = [t.result(timeout=WAIT) for t in batch + [rush]]
        dt = time.monotonic() - t0
        assert all(np.array_equal(g, r) for g, r in zip(outs, refs))
        assert dt < 20.0, f"queue ripened in {dt:.1f}s (batch wait 30s)"
        c.drain(timeout=WAIT)
    svc.close(drain=True, timeout=WAIT)
    assert not os.path.exists(sock)
