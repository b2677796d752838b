"""The port's multi-tenant FFT service (``repro_torch.serve.FFTService``
and ``FFTClient``) on one CPU rank, over real unix sockets (and one TCP
``('127.0.0.1', 0)`` case).

Each in-process case of the reference's ``tests/test_serve_service.py``
(the round trip of complex, real and planar requests through the client
ticket timeout) runs on the port. Every served result is checked two
ways: within 1e-5 relative L2 of the JAX package's plan on
``jax.make_mesh((1, 1))`` (the engine parity tests' tolerance: fp32
pencils, XLA contracts products into FMAs and eager PyTorch does not;
``tests/test_torch_facade.py`` allows 1e-3 for bf16), and bitwise
against the port's own per-request plan call — the service only queues,
coalesces and carries requests.

Across packages, in both directions: a ``repro.serve.FFTClient`` is
served by the port's service, and the port's client by the reference's
service, bit for bit what a reference client gets from it. Plus: a
delivered keyed result keeps nothing of the engine's group output alive
(the dedup window holds host arrays), a service on a mesh of more than
one rank refuses to build its engine, and the launcher's ``--smoke``.
"""
import contextlib
import gc
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

from repro_torch.launch.mesh import FFTMesh, make_fft_mesh
from repro_torch.serve import (FFTClient, FFTEngine, FFTService, ResultTimeout, RetryAfter,
                               SLOClass, TenantConfig)
from repro_torch.serve import protocol as proto
from repro_torch.weights import from_numpy

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RNG = np.random.default_rng(29)
RTOL = 1e-5
WAIT = 60.0


@pytest.fixture(scope="module")
def mesh():
    return make_fft_mesh(1, 1, device='cpu')


@pytest.fixture(scope="module")
def jmesh():
    import jax
    return jax.make_mesh((1, 1), ('x', 'y'))


@pytest.fixture()
def sock_path(tmp_path):
    return str(tmp_path / "fft.sock")


def _creq(shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _rreq(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _joined(y):
    return y[0] + 1j * y[1] if isinstance(y, tuple) else y


def _jax_call(jmesh, x, shape, direction, real):
    """The request through the JAX package's plan (complex form)."""
    import jax.numpy as jnp
    import repro.fft as jfft
    p = (jfft.rplan(shape, jmesh) if real else jfft.plan(shape, jmesh, donate=False))
    fn = p.forward if direction == 'fwd' else p.inverse
    return np.asarray(fn(jnp.asarray(_joined(x))))


def _port_call(eng, x, shape, direction, real):
    """The request through the port's plan, one call, as the engine
    plans it."""
    p = eng.plan_for(real, shape=shape)
    fn = p.forward if direction == 'fwd' else p.inverse
    arg = (tuple(from_numpy(a, 'cpu') for a in x) if isinstance(x, tuple)
           else from_numpy(x, 'cpu'))
    y = fn(arg)
    return tuple(t.numpy() for t in y) if isinstance(y, tuple) else y.numpy()


def _check(svc, jmesh, x, y, direction='fwd', real=False, shape=None):
    """A served result: bitwise the port's per-request call, within
    RTOL of the JAX plan's."""
    shape = tuple(np.shape(x[0] if isinstance(x, tuple) else x)) if shape is None else shape
    want = _port_call(svc.engine, x, shape, direction, real)
    if isinstance(want, tuple):
        assert isinstance(y, tuple) and len(y) == 2
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(y, want))
    else:
        assert y.dtype == want.dtype and np.array_equal(y, want)
    ref = _jax_call(jmesh, x, shape, direction, real)
    got = _joined(y).astype(np.complex128)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= RTOL


@contextlib.contextmanager
def serving(svc):
    """The service for a with block, closed with a bounded drain."""
    try:
        yield svc
    finally:
        svc.close(drain=True, timeout=WAIT)


def _hold(**kw):
    """A service that holds requests in its queue (huge watermark, a
    long SLO wait) until the test lets them go."""
    slos = {'hold': SLOClass('hold', deadline_ms=60000, max_wait_ms=800)}
    return dict(schedule_table=None, policy=None, watermark=10**6, slo_classes=slos, **kw)


# ---------------------------------------------------------------------------
# The reference's in-process cases, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("address", ['unix', 'tcp'])
def test_service_round_trip_complex_real_planar(mesh, jmesh, sock_path, address):
    addr = sock_path if address == 'unix' else ('127.0.0.1', 0)
    with serving(FFTService(mesh, schedule_table=None).start(addr)) as svc:
        if address == 'tcp':
            assert isinstance(svc.address, tuple) and svc.address[1] > 0
        with svc.local_client('t0') as c:
            xc = _creq((8, 8))
            yc = c.transform([xc])[0]
            _check(svc, jmesh, xc, yc)

            xr = _rreq((8, 8))
            yr = c.transform([xr], real=True)[0]
            assert yr.shape == (8, 5)        # half spectrum on the wire
            _check(svc, jmesh, xr, yr, real=True)

            planar = (_rreq((8, 8)), _rreq((8, 8)))
            yp = c.transform([planar])[0]
            _check(svc, jmesh, planar, yp)

            # inverse round trips through the service, complex and real
            xi = c.transform([yc], direction='inv', real=False)[0]
            _check(svc, jmesh, yc, xi, direction='inv')
            np.testing.assert_allclose(xi, xc, atol=1e-5)
            xri = c.transform([(yr.real.copy(), yr.imag.copy())], direction='inv',
                              real=True)[0]
            _check(svc, jmesh, yr, xri, direction='inv', real=True, shape=(8, 8))
            c.drain(timeout=WAIT)


def test_service_round_trip_3d_and_op(mesh, jmesh, sock_path):
    """3-D requests and a registered operator plan (``ops=``): the op
    request bitwise against the operator's own apply."""
    import repro_torch.fft as tfft
    shape = (8, 8, 8)
    op = tfft.plan_op(shape, mesh, op=tfft.spectral_mul, real=True,
                      spectra=(torch.rand(8, 8, 5, dtype=torch.float32).to(torch.complex64),),
                      spectra_form='spectrum')
    with serving(FFTService(mesh, schedule_table=None, ops={'damp': op}).start(sock_path)) as svc:
        with svc.local_client('t3') as c:
            x = _rreq(shape)
            y = c.submit(x, op='damp').result(timeout=WAIT)
            want = svc.engine.plan_for(op='damp').apply(from_numpy(x, 'cpu')).numpy()
            assert y.dtype == want.dtype and np.array_equal(y, want)
            xc = _creq(shape)
            _check(svc, jmesh, xc, c.transform([xc])[0])
            assert svc.engine.registered_ops() == ['damp']


def test_service_retry_after_on_tenant_quota(mesh, jmesh, sock_path):
    svc = FFTService(mesh, tenants=[TenantConfig('cap1', max_inflight=1, slo='hold')],
                     **_hold()).start(sock_path)
    with serving(svc), svc.local_client('cap1') as c:
        x = _creq((8, 8))
        t1 = c.submit(x)                     # held by the huge watermark
        t2 = c.submit(x)                     # quota: typed backpressure
        with pytest.raises(RetryAfter) as ei:
            t2.result(timeout=30)
        assert ei.value.reason == 'tenant_quota'
        assert ei.value.retry_after_ms > 0
        _check(svc, jmesh, x, t1.result(timeout=WAIT))
        m = c.metrics()
        assert m['tenants']['cap1']['rejected'] == {'tenant_quota': 1}


def test_service_retry_after_on_rate_and_window(mesh, sock_path):
    kw = _hold()
    kw['slo_classes'] = {**kw['slo_classes'], 'standard': SLOClass('standard', 250, 20)}
    svc = FFTService(mesh, max_inflight=1,
                     tenants=[TenantConfig('slow', rate_per_s=0.001, burst=1),
                              TenantConfig('other', max_inflight=4, slo='hold')],
                     **kw).start(sock_path)
    with serving(svc):
        with svc.local_client('other') as co, svc.local_client('slow') as cs:
            x = _creq((8, 8))
            held = co.submit(x, slo='hold')  # occupies the whole window
            with pytest.raises(RetryAfter) as ei:
                co.submit(x, slo='hold').result(timeout=30)
            assert ei.value.reason == 'inflight_window'
            # admission order is rate -> quota -> window
            with pytest.raises(RetryAfter) as ei1:
                cs.submit(x).result(timeout=30)
            assert ei1.value.reason == 'inflight_window'
            with pytest.raises(RetryAfter) as ei2:
                cs.submit(x).result(timeout=30)
            assert ei2.value.reason == 'rate'
            held.result(timeout=WAIT)


def test_service_auth_and_unknown_tenants(mesh, jmesh, sock_path):
    svc = FFTService(mesh, schedule_table=None,
                     tenants=[TenantConfig('sec', token='s3cret')]).start(sock_path)
    with serving(svc):
        with pytest.raises(PermissionError, match="unknown tenant"):
            FFTClient(sock_path, tenant='nobody')
        with pytest.raises(PermissionError, match="token"):
            FFTClient(sock_path, tenant='sec', token='wrong')
        with FFTClient(sock_path, tenant='sec', token='s3cret') as c:
            assert c.server_info['tenant'] == 'sec'
            x = _creq((8, 8))
            _check(svc, jmesh, x, c.transform([x])[0])


def test_service_version_mismatch_answered_typed(mesh, sock_path):
    with serving(FFTService(mesh, schedule_table=None).start(sock_path)):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(WAIT)
        s.connect(sock_path)
        try:
            frame = bytearray(proto.pack_frame(proto.HELLO, {'tenant': 'v'}))
            frame[4] = proto.PROTOCOL_VERSION + 1
            s.sendall(bytes(frame))
            msg_type, meta, _ = proto.recv_frame(s)
            assert msg_type == proto.ERROR
            assert meta['kind'] == 'version'
            assert 'protocol v' in meta['error']
            assert proto.recv_frame(s) is None   # then the close
        finally:
            s.close()


def test_service_metrics_schema_and_slo_accounting(mesh, sock_path):
    svc = FFTService(mesh, schedule_table=None).start(sock_path)
    with serving(svc), svc.local_client('m0') as c:
        c.transform([_creq((8, 8)) for _ in range(3)], slo='interactive')
        c.drain(timeout=WAIT)
        m = c.metrics()
    assert set(m) == {'service', 'tenants', 'shapes'}
    s = m['service']
    assert set(s) == {'uptime_s', 'inflight', 'max_inflight', 'reload_generation',
                      'queue_depths', 'dispatch', 'policy', 'scheduler', 'dedup', 'breaker',
                      'faults'}
    assert s['inflight'] == 0 and s['max_inflight'] == 64
    assert sum(s['dispatch']['width_hist'].values()) == s['dispatch']['groups'] > 0
    assert s['policy'] is not None and s['policy']['watermark'] >= 1
    assert s['breaker']['state'] == 'closed' and s['faults'] is None
    assert s['dedup']['misses'] == 3 and s['scheduler']['window'] == 32
    t = m['tenants']['m0']
    assert t['completed'] == 3 and t['failed'] == 0
    lat = t['latency_ms']['interactive']
    assert lat['count'] == 3
    assert 0 < lat['p50_ms'] <= lat['p99_ms']
    assert lat['slo_deadline_ms'] == 50.0
    assert isinstance(lat['violations'], int)
    assert m['shapes'] and all(v['count'] for v in m['shapes'].values())
    assert list(m['shapes']) == ['8x8:fwd']


def test_service_unknown_slo_is_request_error(mesh, sock_path):
    with serving(FFTService(mesh, schedule_table=None).start(sock_path)) as svc:
        with svc.local_client('t') as c:
            t = c.submit(_creq((8, 8)), slo='platinum')
            with pytest.raises(RuntimeError, match="unknown SLO"):
                t.result(timeout=30)


def test_service_graceful_drain_on_close(mesh, jmesh, sock_path):
    svc = FFTService(mesh, tenants=[TenantConfig('d0', slo='hold')], **_hold()).start(sock_path)
    c = svc.local_client('d0')
    xs = [_creq((8, 8)) for _ in range(4)]
    tickets = [c.submit(x) for x in xs]
    deadline = time.monotonic() + 30
    while svc._inflight_total < 4:           # all four admitted & held
        assert time.monotonic() < deadline
        time.sleep(0.005)
    svc.close(drain=True, timeout=WAIT)      # serves + flushes all 4
    assert svc._inflight_total == 0
    assert svc.engine.closed
    for x, t in zip(xs, tickets):
        y = t.result(timeout=30)
        assert y.shape == (8, 8)
        assert np.array_equal(y, _port_call(svc.engine, x, (8, 8), 'fwd', False))
    c.close()
    assert not os.path.exists(sock_path)     # socket path cleaned up
    svc.close()                              # idempotent


def test_service_adaptive_policy_retargets_engine(mesh, sock_path):
    svc = FFTService(mesh, schedule_table=None).start(sock_path)
    with serving(svc), svc.local_client('load') as c:
        lo = svc._last_decision
        assert lo is not None and lo.watermark == 1     # idle: narrow
        for _ in range(400):
            svc.policy.observe(4)
        svc._apply_policy()
        hi = svc._last_decision
        assert hi.load_level > lo.load_level
        assert hi.watermark > lo.watermark
        assert svc.engine.watermark == hi.watermark
        rows = svc.policy.rows(dict(svc.engine.mesh.shape), (8, 8), 'complex', 'auto')
        assert {r['load'] for r in rows} >= {lo.load_level, hi.load_level}
        c.transform([_creq((8, 8))])


def test_service_persists_policy_rows_with_the_device_tag(mesh, sock_path, tmp_path):
    """On close the policy's load-tagged rows go to the engine's schedule
    table, tagged with the mesh's device type; a fresh service seeds its
    policy from them."""
    table = str(tmp_path / 'sched.json')
    svc = FFTService(mesh, schedule_table=table).start(sock_path)
    with svc.local_client('p') as c:
        c.transform([_creq((8, 8)) for _ in range(2)])
    svc.close(timeout=WAIT)
    import json
    with open(table) as f:
        rows = [r for r in json.load(f)['results'] if r.get('load') is not None]
    assert rows and all(r['backend'] == 'cpu' and r['shape'] == '8x8' for r in rows)
    eng = FFTEngine((8, 8), mesh, schedule_table=table, background=True)
    try:
        fresh = FFTService(engine=eng, persist_policy=False)
        assert fresh.policy._levels == {r['load']: (r['coalesce_width'], r['max_wait_ms'])
                                        for r in rows}
        fresh.close(timeout=WAIT)
    finally:
        eng.close()


def test_client_ticket_timeout_leaves_request_pending(mesh, jmesh, sock_path):
    svc = FFTService(mesh, tenants=[TenantConfig('t', slo='hold')], **_hold()).start(sock_path)
    with serving(svc), svc.local_client('t') as c:
        x = _creq((8, 8))
        t = c.submit(x)
        with pytest.raises(ResultTimeout):
            t.result(timeout=0.05)           # still queued server-side
        _check(svc, jmesh, x, t.result(timeout=WAIT))


def test_service_request_errors_are_answered(mesh, sock_path):
    """A request the engine cannot serve (wrong form, a non-wire dtype,
    an unknown op) is answered with a typed error; the link stays up."""
    with serving(FFTService(mesh, schedule_table=None).start(sock_path)) as svc:
        with svc.local_client('e') as c:
            with pytest.raises(RuntimeError, match="unknown|KeyError|no operator"):
                c.submit(_rreq((8, 8)), op='nope').result(timeout=WAIT)
            with pytest.raises(proto.ProtocolError, match="not wire-safe"):
                c.submit(np.zeros((8, 8), np.uint8))
            x = _creq((8, 8))
            assert np.array_equal(c.transform([x])[0],
                                  _port_call(svc.engine, x, (8, 8), 'fwd', False))
            m = c.metrics()
    assert m['tenants']['e']['failed'] == 1 and m['tenants']['e']['completed'] == 1


# ---------------------------------------------------------------------------
# The dedup window holds host arrays, never the engine's output
# ---------------------------------------------------------------------------

def test_delivered_keyed_result_holds_no_engine_memory(mesh, sock_path):
    """Every result of a coalesced group is a view of the group's batched
    output. After a keyed result is delivered, the dedup window keeps its
    host arrays: a weakref to the group output dies, and a resubmit under
    the key is re-delivered from the window, bit-identical, with no
    second dispatch."""
    eng = FFTEngine(mesh=mesh, max_coalesce=4, schedule_table=None, background=True)
    outputs = []
    run_group = eng._run_group

    def watched(*args, **kw):
        ys = run_group(*args, **kw)
        base = ys[0]._base if ys[0]._base is not None else ys[0]
        outputs.append(weakref.ref(base))
        return ys
    eng._run_group = watched
    svc = FFTService(engine=eng, policy=None).start(sock_path)
    try:
        with FFTClient(sock_path, tenant='w') as c:
            xs = [_creq((8, 8)) for _ in range(3)]
            eng.set_schedule(3, 1, shape=(8, 8))
            eng.set_drainer(watermark=3, max_wait_ms=None)
            tickets = [c.submit(x, key=f'k{i}') for i, x in enumerate(xs)]
            ys = [t.result(timeout=WAIT) for t in tickets]
            assert len(outputs) == 1 and eng.dispatch_stats()['width_hist'] == {3: 1}
            c.drain(timeout=WAIT)
            gc.collect()
            assert outputs[0]() is None, "the dedup window keeps the group's output alive"
            again = c.submit(xs[1], key='k1').result(timeout=WAIT)
            assert np.array_equal(again, ys[1]) and again.tobytes() == ys[1].tobytes()
            m = c.metrics()
            assert m['service']['dedup']['redelivered'] == 1
            assert m['tenants']['w']['scheduled'] == 3 and len(outputs) == 1
    finally:
        svc.close(timeout=WAIT)
        eng.close()


def test_a_dead_connections_keyed_result_still_leaves_the_engine(mesh, sock_path):
    """The submitter vanishes before its keyed result is written: the
    writer still moves the result to the host, so the window never pins
    the group output, and a new connection gets it re-delivered."""
    eng = FFTEngine(mesh=mesh, max_coalesce=2, schedule_table=None, background=True)
    outputs = []
    run_group = eng._run_group

    def watched(*args, **kw):
        ys = run_group(*args, **kw)
        outputs.append(weakref.ref(ys[0]._base if ys[0]._base is not None else ys[0]))
        return ys
    eng._run_group = watched
    eng.set_drainer(watermark=10**6, max_wait_ms=None)
    svc = FFTService(engine=eng, policy=None).start(sock_path)
    try:
        x = _creq((8, 8))
        c1 = FFTClient(sock_path, tenant='gone')
        c1.submit(x, key='once')
        deadline = time.monotonic() + 30
        while svc._inflight_total < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        c1.close()
        while svc._conns and any(c.tenant is not None and c.tenant.cfg.name == 'gone'
                                 and not c.dead and c.sock.fileno() != -1
                                 for c in svc._conns):
            assert time.monotonic() < deadline
            time.sleep(0.005)
        eng.flush()
        while svc._inflight_total:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        time.sleep(0.1)                      # the writer's last item
        gc.collect()
        assert len(outputs) == 1 and outputs[0]() is None
        with FFTClient(sock_path, tenant='gone') as c2:
            y = c2.submit(x, key='once').result(timeout=WAIT)
        assert np.array_equal(y, _port_call(eng, x, (8, 8), 'fwd', False))
        assert len(outputs) == 1
    finally:
        svc.close(timeout=WAIT)
        eng.close()


# ---------------------------------------------------------------------------
# Across packages: the wire is the contract
# ---------------------------------------------------------------------------

def test_reference_client_against_the_ports_service(mesh, jmesh, sock_path):
    from repro.serve import FFTClient as RefClient
    with serving(FFTService(mesh, schedule_table=None,
                    tenants=[TenantConfig('j', token='t')]).start(sock_path)) as svc:
        with RefClient(sock_path, tenant='j', token='t') as c:
            assert c.server_info['tenant'] == 'j'
            xc, xr = _creq((8, 8)), _rreq((4, 4, 4))
            yc, yr = c.transform([xc, xr])
            _check(svc, jmesh, xc, yc)
            _check(svc, jmesh, xr, yr, real=True)
            planar = (_rreq((8, 8)), _rreq((8, 8)))
            _check(svc, jmesh, planar, c.transform([planar])[0])
            xi = c.transform([yc], direction='inv', real=False)[0]
            _check(svc, jmesh, yc, xi, direction='inv')
            c.drain(timeout=WAIT)
            m = c.metrics()
            assert m['tenants']['j']['completed'] == 4


def test_ports_client_against_the_reference_service(jmesh, sock_path):
    """The port's client talks to the JAX package's service; its results
    are bit for bit what the reference's own client gets there."""
    from repro.serve import FFTClient as RefClient
    from repro.serve import FFTService as RefService
    xs = [_creq((8, 8)), _rreq((8, 8)), (_rreq((4, 4)), _rreq((4, 4)))]
    with contextlib.closing(RefService(jmesh, schedule_table=None).start(sock_path)):
        with FFTClient(sock_path, tenant='p') as c, RefClient(sock_path, tenant='r') as r:
            got = c.transform(xs)
            want = r.transform(xs)
            for a, b in zip(got, want):
                if isinstance(b, tuple):
                    assert all(np.array_equal(u, v) and u.dtype == v.dtype
                               for u, v in zip(a, b))
                else:
                    assert a.dtype == b.dtype and np.array_equal(a, b)
            gi = c.transform([got[0]], direction='inv', real=False)[0]
            assert np.array_equal(gi, r.transform([want[0]], direction='inv', real=False)[0])
            c.drain(timeout=WAIT)
            assert c.metrics()['tenants']['p']['completed'] == 4


# ---------------------------------------------------------------------------
# Meshes, the launcher
# ---------------------------------------------------------------------------

def test_service_on_a_larger_mesh_raises():
    """The service needs a background engine, whose drainer runs on one
    rank only: on 2 x 2 building the service's engine raises."""
    mesh4 = FFTMesh({'x': 2, 'y': 2}, torch.device('cpu'))
    with pytest.raises(ValueError, match="background drainer cannot run on a mesh of 4"):
        FFTService(mesh4, schedule_table=None)
    eng = FFTEngine(mesh=make_fft_mesh(1, 1, device='cpu'), schedule_table=None)
    with pytest.raises(ValueError, match="needs a background engine"):
        FFTService(engine=eng)
    eng.close()


def test_launcher_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))
    proc = subprocess.run([sys.executable, '-m', 'repro_torch.launch.fft_service', '--smoke',
                           '--device', 'cpu'], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert 'fft_service smoke OK' in proc.stdout


def test_launcher_defaults_to_the_card():
    """``--device`` defaults to ``cuda``; without a card that raises, as
    ``make_fft_mesh`` does, rather than serving on the CPU."""
    from repro_torch.launch import fft_service as launcher
    with pytest.raises(SystemExit):
        launcher.main(['serve', '--address', '/x', '--device', 'tpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launcher.main(['--smoke'])
    assert launcher._tenant_specs('a:10:4:2:batch,b')[0].slo == 'batch'
    assert launcher._address('localhost:9') == ('localhost', 9)
    assert launcher._address('/tmp/s.sock') == '/tmp/s.sock'


def test_launcher_serve_and_client_over_tcp(tmp_path):
    """``serve`` in one process on the CPU, ``client`` in another; the
    tenant file's SIGHUP reload keeps serving."""
    import json
    import signal
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))
    tf = tmp_path / 'tenants.json'
    tf.write_text(json.dumps([{'name': 'alice', 'max_inflight': 8}]))
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    srv = subprocess.Popen([sys.executable, '-m', 'repro_torch.launch.fft_service', 'serve',
                            '--address', f'127.0.0.1:{port}', '--device', 'cpu',
                            '--tenant-file', str(tf), '--duration', '60',
                            '--schedules', str(tmp_path / 'sched.json')],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=env, cwd=ROOT)
    try:
        line = srv.stdout.readline()
        assert 'serving on' in line, line
        srv.send_signal(signal.SIGHUP)
        assert 'reloaded' in srv.stdout.readline()
        cli = subprocess.run([sys.executable, '-m', 'repro_torch.launch.fft_service', 'client',
                              '--address', f'127.0.0.1:{port}', '--tenant', 'alice',
                              '--requests', '4'], capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=120)
        assert cli.returncode == 0, cli.stdout + cli.stderr
        assert 'all verified' in cli.stdout and '"completed": 4' in cli.stdout
    finally:
        srv.send_signal(signal.SIGINT)
        try:
            out, _ = srv.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            srv.kill()
            out, _ = srv.communicate()
    assert 'drained and closed' in out
    # the policy's rows went to the table named, tagged with the device
    rows = json.loads((tmp_path / 'sched.json').read_text())['results']
    assert rows and all(r['backend'] == 'cpu' and r['load'] is not None for r in rows)


def test_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, 'examples', 'torch_fft_service.py'),
                           '--device', 'cpu', '--n', '8', '--requests', '6'],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert 'torch_fft_service OK' in proc.stdout and 'bit-identical' in proc.stdout


def test_delivery_converts_once_under_concurrent_writers(mesh):
    """Writers of several connections (a redelivery races the first
    send) read one settled request's delivery at once: the result comes
    to the host exactly once, every reader gets those same arrays, and
    the engine's ticket is dropped. More threads than cores, a short
    switch interval."""
    from repro_torch.serve.service import _Delivery
    eng = FFTEngine((8, 8), mesh, schedule_table=None)
    try:
        for _ in range(20):
            t = eng.submit(_creq((8, 8)))
            eng.flush()
            d = _Delivery(t, keyed=True)
            got, errors = [], []

            def read():
                try:
                    got.append(d.payload())
                except BaseException as exc:
                    errors.append(exc)
            old = sys.getswitchinterval()
            sys.setswitchinterval(1e-6)
            try:
                threads = [threading.Thread(target=read) for _ in range(4 * (os.cpu_count() or 4))]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=WAIT)
                assert not any(th.is_alive() for th in threads)
            finally:
                sys.setswitchinterval(old)
            assert not errors and len(got) == len(threads)
            assert all(p is got[0] for p in got) and got[0][0] == 'array'
            assert d._ticket is None
            assert np.array_equal(got[0][1][0], t.result(timeout=0).numpy())
    finally:
        eng.close()
