"""Worker: the port's FFT serving on a mesh of gloo CPU ranks (or NCCL cards).

Run in a subprocess so the test process never initialises a process
group:

    python tests/_torch_serve_mesh_worker.py OUT.json PORT [cpu|cuda]
        [--mesh 2x2|1x4] [--cases all|stream,...|bench] [--npz SERVED.npz]

One process a mesh position (``torch.multiprocessing.spawn``), each
running the same program, as ``torch.distributed.run`` would. The cases
are those of the reference's ``tests/_serve_drainer_worker.py`` and
``tests/_serve_service_worker.py`` (one process, 16 fake devices), on
the port's mesh, where every rank builds its own engine and position 0's
drainer leads:

* ``stream``: one producer thread a rank submits the mixed stream of
  ``stream_requests()`` (complex, real, their inverses, planar, a
  registered operator; three shapes) to a background engine, with no
  ``flush()``, while the main thread waits on the tickets. Every result
  is held bitwise against the same rank's per-request plan call, made
  after the engine closed; the groups' count, widths and order
  (``FFTEngine.dispatch_digest``) are recorded on every rank. Several
  producers a rank would submit in a different order on each rank,
  which no engine can pair, so there is one.
* ``deadline``, ``watermark``: a load only the deadline dispatches (a
  watermark that never trips), and one only the watermark does (no
  deadline); both bitwise.
* ``fault``: an ``engine.dispatch`` fault (``FaultPlan``, given to every
  rank's engine, drawn on position 0 only) fires twice and the request
  is retried to a bitwise result on every rank; a persistent one
  surfaces on ``result()`` on every rank as ``FaultInjected``.
* ``stall``: ``engine.drainer`` stalls the first three passes (0.2 s
  each, the first at the engine's start); the requests are served all
  the same, no sooner than 0.2 s after the engine started.
* ``service``: ``FFTService`` over one background engine (Stockham) on
  every rank, a unix socket on position 0: three tenants stream mixed
  requests at once (the reference's case 1); a tenant flooding past its
  quota meets ``RetryAfter`` while another keeps serving (case 2); a
  rush-class request ripens three batch-class ones (case 3). Every
  served result is held bitwise against the per-request plan calls of
  every rank, put together on position 0, and against a one-rank
  service's result frame for the same request (position 0, a 1 x 1
  mesh, the same method). ``close(drain=True)`` ends every rank's part.

``bench`` (on four cards, named alone): the service at the client at
``BENCH_N``^3 (:func:`case_bench`).

Position 0 writes the records (booleans over all ranks, per-rank
values as lists) to OUT.json and, with ``--npz``, the served results as
global arrays (``stream_<i>``, ``service_<tenant>_<i>``; planar joined)
for ``tests/_torch_serve_mesh_reference.py``'s JAX results. The worker
never imports jax.
"""
import argparse
import json
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'src'))

import repro_torch.fft as fft  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402

#: the reference workers' shapes
SHAPES = [(8, 8, 8), (4, 4, 4), (16, 16)]
#: the stream's kinds, in turn over the shapes
STREAM_KINDS = ('complex', 'real', 'complex_inv', 'real_inv', 'planar')
#: the registered operator's transform (real, a baked factor)
OP_SHAPE = (8, 8, 8)
#: (direction, real, operand form, result form) of each kind
KINDS = {'complex': ('fwd', False, 'in', 'out'), 'planar': ('fwd', False, 'in', 'out'),
         'real': ('fwd', True, 'in', 'spectrum'), 'complex_inv': ('inv', False, 'out', 'in'),
         'real_inv': ('inv', True, 'spectrum', 'in'), 'op': ('op', True, 'in', 'in')}
TENANTS = (('alice', 1), ('bob', 2), ('carol', 3))
WAIT = 120.0


def stream_requests():
    """The stream: (kind, transform shape, global operand), the same on
    every rank and in the JAX reference. A real inverse takes
    ``np.fft.rfftn`` of a real array (a Hermitian half spectrum)."""
    rng = np.random.default_rng(47)
    out = []
    for i in range(15):
        shape, kind = SHAPES[i % 3], STREAM_KINDS[i % 5]
        re = rng.standard_normal(shape).astype(np.float32)
        im = rng.standard_normal(shape).astype(np.float32)
        x = {'complex': (re + 1j * im).astype(np.complex64),
             'complex_inv': (re + 1j * im).astype(np.complex64),
             'real': re, 'real_inv': np.fft.rfftn(re).astype(np.complex64),
             'planar': (re, im)}[kind]
        out.append((kind, shape, x))
        if i % 5 == 4:
            out.append(('op', OP_SHAPE, rng.standard_normal(OP_SHAPE).astype(np.float32)))
    return out


def op_factor():
    return np.random.default_rng(48).standard_normal(OP_SHAPE).astype(np.float32)


def tenant_stream(seed, count=10):
    """The reference service worker's ``make_stream``: rotating shapes,
    real and complex forwards, a complex inverse every 5th."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        shape = SHAPES[i % len(SHAPES)]
        if i % 5 == 4:
            out.append(('complex_inv', shape, (rng.standard_normal(shape)
                                               + 1j * rng.standard_normal(shape)
                                               ).astype(np.complex64)))
        elif i % 2:
            out.append(('complex', shape, (rng.standard_normal(shape)
                                           + 1j * rng.standard_normal(shape)
                                           ).astype(np.complex64)))
        else:
            out.append(('real', shape, rng.standard_normal(shape).astype(np.float32)))
    return out


def _complex_requests(seed, n, shape=SHAPES[0]):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# Blocks, per-request calls, global results
# ---------------------------------------------------------------------------

def _plan(eng, kind, shape):
    if kind == 'op':
        return eng.plan_for(op='conv')
    return eng.plan_for(KINDS[kind][1], shape=shape)


def _block(mesh, eng, kind, shape, x):
    """This rank's block of a global request and its submit kwargs."""
    from repro_torch.serve.service import _form_slices
    direction, real, form, _ = KINDS[kind]
    _, sl = _form_slices(mesh, _plan(eng, kind, shape), form, mesh.position)
    blk = tuple(a[sl] for a in x) if isinstance(x, tuple) else x[sl]
    if kind == 'op':
        return blk, {'op': 'conv'}
    return blk, {'direction': direction, 'real': real, 'shape': shape}


def _one(eng, kind, shape, blk, device):
    """The per-request call of this rank's block (every rank together)."""
    from repro_torch.weights import from_numpy
    p = _plan(eng, kind, shape)
    x = from_numpy(blk, device)
    if kind == 'op':
        return p.apply(x)
    return p.forward(x) if KINDS[kind][0] == 'fwd' else p.inverse(x)


def _leaves(y):
    return [a.detach().cpu().numpy() for a in (y if isinstance(y, tuple) else (y,))]


def _equal(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def _global(mesh, eng, reqs, ys):
    """Position 0: every rank's blocks of ``ys`` put together into global
    arrays (planar joined), in request order; None elsewhere."""
    from repro_torch.serve.service import _assemble
    every = [None] * mesh.size
    dist.all_gather_object(every, [_leaves(y) for y in ys])
    if mesh.position:
        return None
    out = []
    for i, (kind, shape, _) in enumerate(reqs):
        parts = [every[pos][i] for pos in range(mesh.size)]
        g = _assemble(mesh, _plan(eng, kind, shape), KINDS[kind][3], parts)
        out.append(g[0] + 1j * g[1] if len(g) == 2 else g[0])
    return out


def _served_by_rank(mesh, eng, reqs, device):
    """The per-request calls of every request on every rank, put
    together on position 0 (the mesh's own per-request results)."""
    ys = [_one(eng, kind, shape, _block(mesh, eng, kind, shape, x)[0], device)
          for kind, shape, x in reqs]
    return _global(mesh, eng, reqs, ys)


# ---------------------------------------------------------------------------
# The drainer cases
# ---------------------------------------------------------------------------

def _serve(eng, mesh, reqs, device, producer=True, t0=None):
    """Submit this rank's blocks of ``reqs`` (from one producer thread,
    or in line) with no flush(); wait on every ticket from this thread;
    close the engine; then the per-request calls. Returns (results,
    bitwise, seconds to the last result from ``t0``, default the first
    submit)."""
    blocks = [_block(mesh, eng, kind, shape, x) for kind, shape, x in reqs]
    tickets: 'queue.Queue' = queue.Queue()
    t0 = time.perf_counter() if t0 is None else t0

    def produce():
        for blk, kw in blocks:
            tickets.put(eng.submit(blk, **kw))
    if producer:
        th = threading.Thread(target=produce)
        th.start()
    else:
        produce()
    ys = [tickets.get(timeout=WAIT).result(timeout=WAIT) for _ in blocks]
    seconds = time.perf_counter() - t0
    if producer:
        th.join()
    eng.close()
    bitwise = all(_equal(y, _one(eng, kind, shape, blk, device))
                  for y, (kind, shape, _), (blk, _) in zip(ys, reqs, blocks))
    return ys, bitwise, seconds


def _record(eng, bitwise, **extra):
    st = eng.dispatch_stats()
    return dict(bitwise=bitwise, groups=st['groups'], widths=st['width_hist'],
                digest=eng.dispatch_digest, **extra)


def case_stream(mesh, device, served):
    from repro_torch.serve import FFTEngine
    eng = FFTEngine(mesh=mesh, max_wait_ms=20.0, max_coalesce=4, schedule_table=None)
    eng.register_op('conv', op=fft.spectral_mul, real=True, spectra=(op_factor(),),
                    shape=OP_SHAPE)
    reqs = stream_requests()
    # groups of up to 4 (the model picks 1 at these sizes); only position
    # 0's pick counts, the others take the width from its passes
    for kind, shape, _ in reqs:
        eng.set_schedule(4, 1, **({'op': 'conv'} if kind == 'op' else
                                  {'real': KINDS[kind][1], 'shape': shape}))
    ys, bitwise, _ = _serve(eng, mesh, reqs, device)
    g = _global(mesh, eng, reqs, ys)
    if g is not None:
        served.update({f'stream_{i}': y for i, y in enumerate(g)})
    return _record(eng, bitwise, requests=len(reqs), closed=eng.closed)


def case_deadline(mesh, device):
    from repro_torch.serve import FFTEngine
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(5):
        shape = SHAPES[i % 2]
        x = rng.standard_normal(shape).astype(np.float32)
        reqs.append(('real', shape, x) if i % 2 else
                    ('complex', shape, (x + 1j * rng.standard_normal(shape)).astype(np.complex64)))
    eng = FFTEngine(mesh=mesh, max_wait_ms=50.0, watermark=10**6, max_coalesce=4,
                    schedule_table=None)
    _, bitwise, _ = _serve(eng, mesh, reqs, device, producer=False)
    return _record(eng, bitwise)


def case_watermark(mesh, device):
    from repro_torch.serve import FFTEngine
    reqs = [('complex', SHAPES[0], x) for x in _complex_requests(6, 4)]
    eng = FFTEngine(mesh=mesh, watermark=2, max_coalesce=2, schedule_table=None)
    _, bitwise, _ = _serve(eng, mesh, reqs, device, producer=False)
    return _record(eng, bitwise)


def case_fault(mesh, device):
    from repro_torch.serve import FFTEngine
    from repro_torch.serve.faults import FaultInjected, FaultPlan, FaultPoint
    reqs = [('complex', SHAPES[1], _complex_requests(7, 1, SHAPES[1])[0])]
    plan = FaultPlan([FaultPoint('engine.dispatch', 'raise', at=[0, 1])])
    eng = FFTEngine(mesh=mesh, max_wait_ms=20.0, retries=3, max_coalesce=4,
                    schedule_table=None, faults=plan)
    _, bitwise, _ = _serve(eng, mesh, reqs, device, producer=False)
    rec = _record(eng, bitwise, fired=plan.stats()['engine.dispatch']['fired'])
    # a persistent fault: retried once, then it fails the ticket on every rank
    eng = FFTEngine(mesh=mesh, max_wait_ms=20.0, retries=1, max_coalesce=4,
                    schedule_table=None,
                    faults=FaultPlan([FaultPoint('engine.dispatch', 'raise', every=1)]))
    kind, shape, x = reqs[0]
    blk, kw = _block(mesh, eng, kind, shape, x)
    t = eng.submit(blk, **kw)
    try:
        t.result(timeout=WAIT)
        surfaced = False
    except FaultInjected as exc:
        surfaced = exc.site == 'engine.dispatch'
    eng.close()
    st = eng.dispatch_stats()
    rec.update(persistent_surfaced=surfaced, persistent_groups=st['groups'],
               persistent_digest=eng.dispatch_digest)
    return rec


def case_stall(mesh, device):
    from repro_torch.serve import FFTEngine
    from repro_torch.serve.faults import FaultPlan, FaultPoint
    plan = FaultPlan([FaultPoint('engine.drainer', 'stall', at=[0, 1, 2], delay_s=0.2)])
    reqs = [('complex', SHAPES[0], x) for x in _complex_requests(8, 3)]
    # timed from the engine's start, where its first pass stalls
    t0 = time.perf_counter()
    eng = FFTEngine(mesh=mesh, max_wait_ms=5.0, max_coalesce=4, schedule_table=None,
                    faults=plan)
    _, bitwise, seconds = _serve(eng, mesh, reqs, device, producer=False, t0=t0)
    return _record(eng, bitwise, stalls=plan.stats()['engine.drainer']['fired'],
                   seconds=seconds)


# ---------------------------------------------------------------------------
# The service cases (position 0 serves; the others follow in start())
# ---------------------------------------------------------------------------

def _service(mesh, eng, sock, **kw):
    from repro_torch.serve import FFTService
    return FFTService(engine=eng, persist_policy=False, **kw).start(sock)


def _check_served(mesh, eng, device, reqs, got) -> bool:
    """Every served result (position 0's) bitwise equal to the mesh's
    per-request calls, put together; every rank calls."""
    want = _served_by_rank(mesh, eng, reqs, device)
    if want is None:
        return True
    if len(got) != len(want) or any(g is None for g in got):
        return False
    return all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))


def service_multi_tenant(mesh, eng, device, sock, served):
    from repro_torch.serve import FFTClient, TenantConfig
    streams = {name: tenant_stream(seed) for name, seed in TENANTS}
    svc = _service(mesh, eng, sock, tenants=[TenantConfig(n, max_inflight=16)
                                             for n in streams])
    rec = {}
    got = {}
    if svc.is_leader:
        failures = []

        def run(name, stream):
            try:
                with FFTClient(sock, tenant=name) as c:
                    tickets = [c.submit(x, direction=KINDS[kind][0],
                                        real=None if kind != 'complex_inv' else False)
                               for kind, _, x in stream]
                    got[name] = [np.asarray(t.result(timeout=WAIT)) for t in tickets]
                    c.drain(timeout=WAIT)
            except BaseException as exc:
                failures.append((name, repr(exc)))
        threads = [threading.Thread(target=run, args=kv) for kv in streams.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=2 * WAIT)
        with FFTClient(sock, tenant='alice') as probe:
            m = probe.metrics()
        counts = all(m['tenants'][n]['completed'] == 10 and m['tenants'][n]['failed'] == 0
                     and m['tenants'][n]['rejected'] == {} for n in streams)
        rec = dict(clients_ok=not failures and len(got) == 3, failures=failures,
                   counts_ok=counts, mesh_metrics=m['service'].get('mesh'))
        svc.close(drain=True)
        for name, ys in got.items():
            served.update({f'service_{name}_{i}': y for i, y in enumerate(ys)})
    rec['served_closed'] = svc._closed
    reqs = [r for name, _ in TENANTS for r in streams[name]]
    flat = [y for name, _ in TENANTS for y in got.get(name, [None] * 10)]
    rec['bitwise'] = _check_served(mesh, eng, device, reqs, flat if svc.is_leader else None)
    return rec


def service_quota(mesh, eng, device, sock):
    from repro_torch.serve import FFTClient, RetryAfter, TenantConfig
    good = _complex_requests(9, 8)
    flood_x = _complex_requests(10, 1)[0]
    svc = _service(mesh, eng, sock, tenants=[TenantConfig('good', max_inflight=8),
                                             TenantConfig('flood', max_inflight=2)])
    rec, outs = {}, []
    if svc.is_leader:
        def serve_good(lat, keep):
            with FFTClient(sock, tenant='good') as c:
                for x in good:
                    t0 = time.monotonic()
                    y = np.asarray(c.submit(x).result(timeout=WAIT))
                    lat.append((time.monotonic() - t0) * 1e3)
                    if keep:
                        outs.append(y)
        base, under = [], []
        serve_good(base, True)
        stats = {'rejected': 0, 'served': 0, 'reasons_ok': True}

        def run_flood():
            with FFTClient(sock, tenant='flood') as c:
                for t in [c.submit(flood_x) for _ in range(60)]:
                    try:
                        t.result(timeout=WAIT)
                        stats['served'] += 1
                    except RetryAfter as ra:
                        stats['reasons_ok'] &= (ra.reason in ('tenant_quota', 'rate')
                                                and ra.retry_after_ms > 0)
                        stats['rejected'] += 1
        tf = threading.Thread(target=run_flood)
        tg = threading.Thread(target=serve_good, args=(under, False))
        tf.start()
        tg.start()
        for th in (tf, tg):
            th.join(timeout=2 * WAIT)

        def p99(v):
            s = sorted(v)
            return s[min(len(s) - 1, int(0.99 * len(s)))]
        with FFTClient(sock, tenant='good') as probe:
            m = probe.metrics()
        bound = 10.0 * p99(base) + 500.0
        rec = dict(flood=stats, good_rejected=m['tenants']['good']['rejected'],
                   flood_rejected=m['tenants']['flood']['rejected'],
                   p99_base_ms=p99(base), p99_under_ms=p99(under), bound_ms=bound,
                   isolated=(stats['rejected'] > 0 and stats['served'] >= 2
                             and stats['reasons_ok'] and m['tenants']['good']['rejected'] == {}
                             and bool(m['tenants']['flood']['rejected'])
                             and len(under) == len(good) and p99(under) <= bound))
        svc.close(drain=True)
    rec['bitwise'] = _check_served(mesh, eng, device, [('complex', SHAPES[0], x) for x in good],
                                   outs if svc.is_leader else None)
    return rec


def service_slo(mesh, eng, device, sock):
    from repro_torch.serve import FFTClient, SLOClass, TenantConfig
    xs = _complex_requests(11, 4)
    eng.set_drainer(watermark=16, max_wait_ms=None)
    svc = _service(mesh, eng, sock, policy=None,
                   slo_classes={'batch': SLOClass('batch', deadline_ms=120000, max_wait_ms=30000),
                                'rush': SLOClass('rush', deadline_ms=200, max_wait_ms=1.0)},
                   tenants=[TenantConfig('mix', max_inflight=8, slo='batch')])
    rec, outs = {}, []
    if svc.is_leader:
        with FFTClient(sock, tenant='mix') as c:
            t0 = time.monotonic()
            batch = [c.submit(x) for x in xs[:3]]
            time.sleep(0.3)
            sat = not any(t.done for t in batch)
            rush = c.submit(xs[3], slo='rush')
            outs = [np.asarray(t.result(timeout=WAIT)) for t in batch + [rush]]
            dt = time.monotonic() - t0
            c.drain(timeout=WAIT)
        rec = dict(batch_waited=sat, seconds=dt, ordered=sat and dt < 20.0)
        svc.close(drain=True)
    rec['bitwise'] = _check_served(mesh, eng, device, [('complex', SHAPES[0], x) for x in xs],
                                   outs if svc.is_leader else None)
    return rec


def one_rank_bytes(served, device) -> bool:
    """Position 0 alone: case 1's requests through a one-rank service
    (1 x 1 mesh, the same method) over its own socket; every result
    frame's array equal, dtype and bytes, to the mesh service's."""
    from repro_torch.serve import FFTClient, FFTService
    single = make_fft_mesh(1, 1, device=device)
    sock = os.path.join(tempfile.mkdtemp(prefix='serve_mesh_one_'), 's.sock')
    ok = True
    with FFTService(single, schedule_table=None, persist_policy=False, max_wait_ms=20.0,
                    method='stockham').start(sock):
        with FFTClient(sock, tenant='one') as c:
            for name, seed in TENANTS:
                for i, (kind, _, x) in enumerate(tenant_stream(seed)):
                    y = np.asarray(c.submit(x, direction=KINDS[kind][0],
                                            real=None if kind != 'complex_inv' else False
                                            ).result(timeout=WAIT))
                    g = served[f'service_{name}_{i}']
                    ok &= y.dtype == g.dtype and y.shape == g.shape and y.tobytes() == g.tobytes()
            c.drain(timeout=WAIT)
    return bool(ok)


def case_service(mesh, device, served):
    from repro_torch.serve import FFTEngine
    # position 0 binds; the others' start() never reads the address
    sock = (os.path.join(tempfile.mkdtemp(prefix='serve_mesh_'), 's.sock')
            if mesh.position == 0 else None)
    eng = FFTEngine(mesh=mesh, max_wait_ms=20.0, schedule_table=None, method='stockham')
    rec = {'multi_tenant': service_multi_tenant(mesh, eng, device, sock, served),
           'quota': service_quota(mesh, eng, device, sock),
           'slo': service_slo(mesh, eng, device, sock)}
    eng.close()
    rec['engine_closed'] = eng.closed
    rec['one_rank_bytes'] = one_rank_bytes(served, device) if mesh.position == 0 else True
    return rec


#: the timed service: real N^3 requests (a complex 512^3 request is one
#: 2^30-byte array, over the frame cap) from two tenants
BENCH_N = 512
BENCH_REQUESTS = 4
BENCH_TENANTS = (('alice', 'standard'), ('bob', 'batch'))


def _host_split(x, block, spectrum_block, device) -> dict:
    """Position 0's host steps of one request, each timed alone (ms):
    packing its SUBMIT frame, unpacking it, a unix socket pair's trip of
    it, its own block's copy to the card and its own result block's copy
    back."""
    import socket
    from repro_torch.serve import protocol as proto
    from repro_torch.serve.service import _host_array
    from repro_torch.weights import from_numpy
    out = {}
    t0 = time.perf_counter()
    buf = proto.pack_frame(proto.SUBMIT, {'req_id': 1, 'direction': 'fwd'}, [x])
    out['pack_ms'] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    proto.unpack_frame(buf)
    out['unpack_ms'] = (time.perf_counter() - t0) * 1e3
    a, b = socket.socketpair()
    try:
        got = []
        reader = threading.Thread(target=lambda: got.append(proto.recv_frame(b)))
        t0 = time.perf_counter()
        reader.start()
        a.sendall(buf)
        reader.join(timeout=WAIT)
        out['socket_ms'] = (time.perf_counter() - t0) * 1e3
    finally:
        a.close()
        b.close()
    del buf, got

    def sync():
        if device == 'cuda':
            torch.cuda.synchronize()
    sync()
    t0 = time.perf_counter()
    from_numpy(block, device)
    sync()
    out['h2d_ms'] = (time.perf_counter() - t0) * 1e3
    y = torch.zeros(spectrum_block, dtype=torch.complex64, device=device)
    sync()
    t0 = time.perf_counter()
    _host_array(y)
    out['d2h_ms'] = (time.perf_counter() - t0) * 1e3
    return out


def case_bench(mesh, device, served):
    """The service at the client on the cards (``BENCH_REQUESTS`` real
    ``BENCH_N``^3 requests, groups of up to 4, one overlap chunk, as
    ``chip_smoke.py``'s ``[service]`` sets them): the two tenants' stream
    (``stream_us_per_request``), one request in flight at a time (median
    of 3, ``us_per_request``), the same through position 0's scatter,
    engines and gather with no socket (``engine_us_per_request``); the
    host split with the mesh's ``scatter_ms`` and ``gather_ms`` a
    request; each card's peak memory and position 0's host peak; on
    every rank 3 ``fft_matmul`` launches a group, all on the tensor-core
    body; every served result bitwise equal to the ranks' per-request
    calls put together, and, where it is the same method, to a one-card
    service's result frame (position 0, a 1 x 1 mesh)."""
    import resource
    import statistics
    from repro_torch import kernels
    from repro_torch.kernels import fft_matmul
    from repro_torch.serve import FFTClient, FFTService, TenantConfig
    shape = (BENCH_N,) * 3
    cuda = device == 'cuda'
    rng = np.random.default_rng(12)
    reqs = [rng.standard_normal(shape, dtype=np.float32) for _ in range(BENCH_REQUESTS)]
    sock = (os.path.join(tempfile.mkdtemp(prefix='serve_mesh_'), 's.sock')
            if mesh.position == 0 else None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    svc = FFTService(mesh, max_coalesce=4, schedule_table=None, persist_policy=False,
                     tenants=[TenantConfig(nm, slo=slo) for nm, slo in BENCH_TENANTS])
    svc.engine.set_schedule(4, 1, real=True, shape=shape)
    method = svc.engine.plan_for(True, shape=shape).method
    kernels.reset_launch_counts()
    svc.start(sock)                    # the other ranks: until position 0 closes
    rec, got = {}, []
    if svc.is_leader:
        results, errors = [None] * len(reqs), []
        clients = [FFTClient(sock, tenant=nm) for nm, _ in BENCH_TENANTS]

        def drive(c, idx):
            try:
                tickets = [(i, c.submit(reqs[i])) for i in idx]
                for i, t in tickets:
                    results[i] = t.result(timeout=900)
            except BaseException as exc:
                errors.append(repr(exc))
        threads = [threading.Thread(target=drive, args=(c, range(j, len(reqs), 2)))
                   for j, c in enumerate(clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=1800)
        stream_us = (time.perf_counter() - t0) / len(reqs) * 1e6
        got = results
        one_at_a_time = []
        for i in range(3):
            t0 = time.perf_counter()
            clients[i % 2].submit(reqs[i]).result(timeout=900)
            one_at_a_time.append((time.perf_counter() - t0) * 1e6)
        engine_us = []
        for i in range(3):
            t0 = time.perf_counter()
            svc._link.submit(reqs[i], direction='fwd', real=None, op=None,
                             max_wait_ms=2.0).result(timeout=900)
            engine_us.append((time.perf_counter() - t0) * 1e6)
        m = clients[0].metrics()
        for c in clients:
            c.close()
        svc.close(drain=True)
        p = svc.engine.plan_for(True, shape=shape)
        split = _host_split(reqs[0], reqs[0][mesh.block_slices(shape, p.in_layout, 0)],
                            p.spectrum_local_shape(0), device)
        split.update(scatter_ms=m['service']['mesh']['scatter_ms'],
                     gather_ms=m['service']['mesh']['gather_ms'])
        rec = dict(errors=errors, stream_us_per_request=stream_us,
                   us_per_request=statistics.median(one_at_a_time),
                   engine_us_per_request=statistics.median(engine_us),
                   host_split=split, method=method,
                   tenants={nm: m['tenants'][nm]['completed'] for nm, _ in BENCH_TENANTS},
                   rejected=sum(sum(m['tenants'][nm]['rejected'].values())
                                for nm, _ in BENCH_TENANTS),
                   width_hist=m['service']['dispatch']['width_hist'],
                   peak_host_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    counts = kernels.launch_counts()
    groups = svc.engine.dispatch_stats()['groups']
    rec.update(groups=groups, fft_matmul=counts['fft_matmul'],
               launches_ok=(not cuda or (
                   counts['fft_matmul'] == 3 * groups == fft_matmul.launches_mma
                   and not any(v for k, v in counts.items() if k != 'fft_matmul'))),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0,
               digest=svc.engine.dispatch_digest)
    rec['bitwise'] = _check_served(mesh, svc.engine, device,
                                   [('real', shape, x) for x in reqs],
                                   got if svc.is_leader else None)
    if svc.is_leader:
        single = make_fft_mesh(1, 1, device=device)
        sock1 = os.path.join(tempfile.mkdtemp(prefix='serve_one_'), 's.sock')
        same = True
        with FFTService(single, max_coalesce=4, schedule_table=None,
                        persist_policy=False).start(sock1) as one:
            rec['one_card_method'] = one.engine.plan_for(True, shape=shape).method
            with FFTClient(sock1, tenant='one') as c:
                for x, g in zip(reqs, got):
                    y = np.asarray(c.submit(x).result(timeout=900))
                    same &= (y.dtype == g.dtype and y.shape == g.shape
                             and y.tobytes() == g.tobytes())
                    if not same:
                        rec['one_card_max_abs'] = float(np.abs(y - g).max())
                        break
        rec['one_card_bytes'] = bool(same)
    return rec


CASES = {'stream': case_stream, 'deadline': case_deadline, 'watermark': case_watermark,
         'fault': case_fault, 'stall': case_stall, 'service': case_service,
         'bench': case_bench}
#: the cases of --cases all (the timed service runs only when named)
ALL = ('stream', 'deadline', 'watermark', 'fault', 'stall', 'service')


def _merge(recs):
    """One record from every rank's: booleans AND-ed, dicts merged key by
    key, anything else as the list by rank."""
    first = recs[0]
    if isinstance(first, bool):
        return all(recs)
    if isinstance(first, dict) and all(isinstance(r, dict) for r in recs):
        keys = set().union(*recs)
        if all(set(r) == keys for r in recs):
            return {k: _merge([r[k] for r in recs]) for k in first}
    return list(recs)


def run(rank, port, out, device, mesh_name, cases, npz, bench_n=BENCH_N):
    global BENCH_N
    BENCH_N = bench_n
    rows, cols = (int(v) for v in mesh_name.split('x'))
    if device == 'cuda':
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group('nccl' if device == 'cuda' else 'gloo',
                            init_method=f'tcp://localhost:{port}', rank=rank,
                            world_size=rows * cols)
    try:
        mesh = make_fft_mesh(rows, cols, device=device)
        served, mine = {}, {}
        for name in cases:
            fn = CASES[name]
            t0 = time.perf_counter()
            mine[name] = (fn(mesh, device, served) if name in ('stream', 'service', 'bench')
                          else fn(mesh, device))
            mine[name]['case_seconds'] = time.perf_counter() - t0
            dist.barrier()
        every = [None] * (rows * cols)
        dist.all_gather_object(every, mine)
        if rank == 0:
            merged = {name: _merge([r[name] for r in every]) for name in cases}
            with open(out, 'w') as fh:
                json.dump(merged, fh, default=str)
            if npz:
                np.savez(npz, **served)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('out')
    ap.add_argument('port', type=int)
    ap.add_argument('device', nargs='?', default='cpu', choices=('cpu', 'cuda'))
    ap.add_argument('--mesh', default='2x2', choices=('2x2', '1x4'))
    ap.add_argument('--cases', default='all', help="'all' or comma-separated case names")
    ap.add_argument('--npz', default=None, help='write the served global results here')
    ap.add_argument('--bench-n', type=int, default=BENCH_N,
                    help='the bench case at this N^3 (a smaller N rehearses it)')
    args = ap.parse_args()
    names = list(ALL) if args.cases == 'all' else args.cases.split(',')
    rows, cols = (int(v) for v in args.mesh.split('x'))
    mp.spawn(run, args=(args.port, args.out, args.device, args.mesh, names, args.npz,
                        args.bench_n),
             nprocs=rows * cols, join=True)
