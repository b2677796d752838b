"""Multi-tenant service front end: the socket's overhead and the adaptive
drainer policy.

Port of ``benchmarks/bench_serve_service.py``. Two questions, one JSON:

1. **What does the socket front end cost?** The same sequential request
   stream is served (a) directly on an in-process :class:`FFTEngine` and
   (b) through :class:`FFTService` over a unix socket, wire framing,
   admission, writer threads and all. The ``overhead`` row reports both
   us a request and their ratio.

2. **Does the adaptive drainer policy earn its keep?** Three arrival
   traces, ``steady_slow`` (a trickle), ``steady_fast`` (a dense stream)
   and ``bursty`` (bursts and gaps), are each served under every fixed
   (watermark, max_wait_ms) setting and under :class:`AdaptivePolicy`,
   which retargets the drainer from its arrival-rate estimate. A cell
   reports the client's mean and p99 latency (stamped when the result
   frame arrives) and its wall time, the best of ``--repeats`` passes
   after one untimed pass. The ``summary`` row lists the traces on which
   the adaptive policy beat EVERY fixed setting on mean latency; full
   mode asserts there is one (the reference's claim), ``--smoke``
   asserts nothing.

``--chaos`` runs the degraded-mode cell instead: the resilient client
(reconnect and idempotent resubmit) against a scripted fault plan
(dropped and truncated frames, drainer stalls, dispatch errors) beside
a clean run of the same stream, asserting exactly-once delivery: no
request failed, and the plan fired.

The requests are complex ``--n``^3 (default 8^3: the question is one of
latency, not of the transform), from a seed. The service runs on a
1 x 1 mesh on ``--device`` (the card by default; ``cpu`` runs the plain
tier), where the reference ran a 4 x 4 host mesh in one process; a
served mesh is ``torch_multirank_cuda.py --suite serve``'s.

Prints the CSV rows (``name,us_per_call,derived``; a cell's us is its
mean latency) and writes ``--out`` (default
``results/bench_torch_serve_service.json``); ``--refresh`` merges rows
by (mode, trace, config, shape) and persists the adaptive policy's
load-level rows into ``--schedule-out`` (default
``results/bench_torch_serve_schedule.json``, never the repo root's).

    python3 benchmarks/torch_bench_serve_service.py [--requests 64] [--repeats 2]
        [--n 8] [--refresh] [--smoke] [--chaos] [--device cuda|cpu]

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_util as U  # noqa: E402

from repro_torch.comm import cost as ccost  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402
from repro_torch.serve import (AdaptivePolicy, FaultPlan, FaultPoint,  # noqa: E402
                               FFTEngine, FFTService, SLOClass, TenantConfig)

MAX_COALESCE = 8
FIXED = [(1, 1.0), (4, 5.0), (8, 20.0)]      # (watermark, max_wait_ms)


def make_requests(shape, count, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
            for _ in range(count)]


def traces(smoke: bool):
    """trace name -> arrival offsets in seconds (relative to t0)."""
    if smoke:
        return {
            'steady_slow': [i * 0.030 for i in range(8)],
            'steady_fast': [i * 0.001 for i in range(18)],
            'bursty': [b * 0.120 for b in range(2) for _ in range(6)],
        }
    return {
        'steady_slow': [i * 0.040 for i in range(24)],
        'steady_fast': [i * 0.001 for i in range(50)],
        'bursty': [b * 0.150 for b in range(5) for _ in range(8)],
    }


def serve_trace(client, reqs, offsets, shape):
    """Submit one request per arrival offset; return (latencies_ms,
    wall_s), latency stamped at the result frame's arrival."""
    t0 = time.perf_counter()
    submits, tickets = [], []
    for x, off in zip(reqs, offsets):
        wait = t0 + off - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        submits.append(time.monotonic())
        tickets.append(client.submit(x))
    outs = [t.result(timeout=600) for t in tickets]
    wall = time.perf_counter() - t0
    assert all(o.shape == shape for o in outs)
    lats = [(t.done_at - s) * 1e3 for t, s in zip(tickets, submits)]
    return lats, wall


def p99(vals):
    s = sorted(vals)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def run_cell(eng, sock, config, reqs, offsets, repeats, shape):
    """One (trace, drainer-config) cell: a fresh service on the shared
    engine, one warm pass, then the best of ``repeats`` timed passes.
    Returns (row fields, policy or None)."""
    name, watermark, wait_ms = config
    if name == 'adaptive':
        policy = AdaptivePolicy(max_coalesce=MAX_COALESCE, max_wait_ms=50.0)
        slo_wait = 50.0
    else:
        policy = None
        eng.set_drainer(watermark=watermark, max_wait_ms=wait_ms)
        slo_wait = wait_ms
    svc = FFTService(
        engine=eng, policy=policy, persist_policy=False, max_inflight=1000,
        slo_classes={'bench': SLOClass('bench', deadline_ms=1e9, max_wait_ms=slo_wait)},
        tenants=[TenantConfig('bench', max_inflight=1000, slo='bench')],
    ).start(sock)
    try:
        with svc.local_client('bench') as c:
            best = None
            for i in range(repeats + 1):     # pass 0 warms
                lats, wall = serve_trace(c, reqs, offsets, shape)
                if i == 0:
                    continue
                row = dict(mean_ms=sum(lats) / len(lats), p99_ms=p99(lats), wall_s=wall)
                if best is None or row['mean_ms'] < best['mean_ms']:
                    best = row
            c.drain(timeout=120)
    finally:
        svc.close(drain=True)
    best = {k: round(v, 3) for k, v in best.items()}
    return best, policy


def _chaos_plan():
    """The degraded-mode schedule: scripted (every-Nth) faults so the
    row is reproducible — no fire at hit 0, the handshake survives."""
    return FaultPlan(seed=3, points=[
        FaultPoint('service.writer', 'drop', every=7, limit=8),
        FaultPoint('service.writer', 'truncate', every=11, limit=4),
        FaultPoint('engine.drainer', 'stall', every=9, delay_s=0.02, limit=6),
        FaultPoint('engine.dispatch', 'raise', every=13, limit=2),
    ])


def run_chaos_cell(eng, sock, reqs, plan):
    """One degraded-mode cell: the resilient client loop (reconnect +
    idempotent resubmit) against an armed fault plan; per-request
    latency measured around ``transform``. Asserts exactly-once
    delivery — every request served, none failed."""
    eng.set_drainer(watermark=4, max_wait_ms=5.0)
    svc = FFTService(
        engine=eng, policy=None, persist_policy=False, faults=plan,
        slo_classes={'bench': SLOClass('bench', 1e9, 5.0)},
        tenants=[TenantConfig('bench', max_inflight=1000, slo='bench')],
    ).start(sock)
    lats = []
    try:
        with svc.local_client('bench') as c:
            c.transform(reqs[:2], timeout=120.0)       # warm
            t0 = time.perf_counter()
            for x in reqs:
                s = time.perf_counter()
                c.transform([x], timeout=120.0, deadline_s=120.0)
                lats.append((time.perf_counter() - s) * 1e3)
            wall = time.perf_counter() - t0
            reconnects = c.reconnects
        tm = svc.metrics()['tenants']['bench']
        assert tm['failed'] == 0, f"degraded mode lost work: {tm}"
        fired = 0 if plan is None else plan.total_fired()
    finally:
        svc.close(drain=True)
        eng.faults = None
    return dict(mean_ms=round(sum(lats) / len(lats), 3), p99_ms=round(p99(lats), 3),
                wall_s=round(wall, 3), reconnects=reconnects, faults_fired=fired)


def _row_key(r):
    return (r.get('mode'), r.get('trace'), r.get('config'), str(r.get('shape')))


def chaos(eng, sock, args, shape, base) -> list:
    """The degraded-mode rows: the same stream clean and under faults."""
    n = 24 if args.smoke else 48
    reqs = make_requests(shape, n, seed=23)
    cells, results = {}, []
    for label in ('clean', 'degraded'):
        plan = _chaos_plan() if label == 'degraded' else None
        cell = cells[label] = run_chaos_cell(eng, sock, reqs, plan)
        results.append(dict(mode='chaos', trace='degraded_mode', config=label,
                            n_requests=n, **base, **cell))
        U.emit(f"serve_service/chaos/{label}", cell['mean_ms'] * 1e3,
               f"p99={cell['p99_ms']:.1f}ms reconnects={cell['reconnects']} "
               f"faults={cell['faults_fired']}")
    slow = cells['degraded']['mean_ms'] / max(cells['clean']['mean_ms'], 1e-9)
    print(f"# chaos: degraded {cells['degraded']['mean_ms']:.2f}ms vs clean "
          f"{cells['clean']['mean_ms']:.2f}ms ({slow:.2f}x, "
          f"{cells['degraded']['reconnects']} reconnects, "
          f"{cells['degraded']['faults_fired']} faults fired, zero lost)")
    assert cells['degraded']['faults_fired'] > 0, "chaos cell fired no faults"
    return results


def overhead(eng, sock, args, shape, base) -> dict:
    """The same sequential stream in process and through the socket."""
    reqs = make_requests(shape, 12 if args.smoke else args.requests)
    eng.set_drainer(watermark=1, max_wait_ms=1.0)
    for x in reqs[:2]:                   # warm
        eng.submit(x).result(timeout=600)
    t0 = time.perf_counter()
    for x in reqs:
        eng.submit(x).result(timeout=600)
    eng_us = (time.perf_counter() - t0) / len(reqs) * 1e6
    svc = FFTService(
        engine=eng, policy=None, persist_policy=False,
        slo_classes={'bench': SLOClass('bench', 1e9, 1.0)},
        tenants=[TenantConfig('bench', max_inflight=1000, slo='bench')],
    ).start(sock)
    with svc.local_client('bench') as c:
        c.transform(reqs[:2])            # warm the wire path
        t0 = time.perf_counter()
        c.transform(reqs)
        svc_us = (time.perf_counter() - t0) / len(reqs) * 1e6
    svc.close(drain=True)
    row = dict(mode='overhead', n_requests=len(reqs), **base,
               engine_us_per_req=round(eng_us, 1), service_us_per_req=round(svc_us, 1),
               overhead_ratio=round(svc_us / eng_us, 3))
    U.emit(f"serve_service/overhead/{'x'.join(map(str, shape))}", svc_us,
           f"engine_us={eng_us:.1f} ratio={row['overhead_ratio']:.2f}x")
    return row


def policies(eng, sock, args, shape, base) -> tuple:
    """Every (trace, config) cell: (rows, traces the adaptive policy
    beat every fixed setting on, the last adaptive policy)."""
    repeats = 1 if args.smoke else args.repeats
    configs = ([(f"fixed_w{w}_{ms:g}ms", w, ms) for w, ms in FIXED]
               + [('adaptive', None, None)])
    rows, beats, last_policy = [], [], None
    for trace, offsets in traces(args.smoke).items():
        reqs = make_requests(shape, len(offsets), seed=17)
        means = {}
        for config in configs:
            cell, policy = run_cell(eng, sock, config, reqs, offsets, repeats, shape)
            if policy is not None:
                last_policy = policy
            means[config[0]] = cell['mean_ms']
            rows.append(dict(mode='policy', trace=trace, config=config[0],
                             n_requests=len(offsets), watermark=config[1],
                             max_wait_ms=config[2], **base, **cell))
            U.emit(f"serve_service/{trace}/{config[0]}", cell['mean_ms'] * 1e3,
                   f"p99={cell['p99_ms']:.1f}ms wall={cell['wall_s']:.2f}s")
        fixed_best = min(v for k, v in means.items() if k != 'adaptive')
        if means['adaptive'] < fixed_best:
            beats.append(trace)
        print(f"# {trace}: adaptive {means['adaptive']:.2f}ms vs best fixed "
              f"{fixed_best:.2f}ms")
    return rows, beats, last_policy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--requests', type=int, default=64,
                    help='request count for the overhead cell')
    ap.add_argument('--repeats', type=int, default=2)
    ap.add_argument('--n', type=int, default=8, help='the requests are complex n^3')
    ap.add_argument('--refresh', action='store_true',
                    help='merge rows into --out and persist the adaptive load-level rows '
                         'into --schedule-out')
    ap.add_argument('--smoke', action='store_true',
                    help='tiny traces, 1 repeat, no win assertion (CI)')
    ap.add_argument('--chaos', action='store_true',
                    help='degraded-mode rows only: the resilient client against an armed '
                         'fault plan vs a clean run')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--out', default=os.path.join('results', 'bench_torch_serve_service.json'))
    ap.add_argument('--schedule-out',
                    default=os.path.join('results', 'bench_torch_serve_schedule.json'))
    args = ap.parse_args(argv)
    U.need_device(args.device)
    shape = (args.n,) * 3
    mesh = make_fft_mesh(1, 1, device=args.device)
    sock = os.path.join(tempfile.mkdtemp(prefix='bench_torch_serve_service_'), 's.sock')
    card = U.card(args.device)
    base = dict(shape=list(shape), mesh='1x1', card=card, backend=args.device)
    print(f"# torch_bench_serve_service: {'x'.join(map(str, shape))} complex on 1x1 ({card})")
    print("name,us_per_call,derived")
    beats = None
    with FFTEngine(mesh=mesh, max_coalesce=MAX_COALESCE, max_wait_ms=20.0,
                   schedule_table=None) as eng:
        if args.chaos:
            results = chaos(eng, sock, args, shape, base)
        else:
            results = [overhead(eng, sock, args, shape, base)]
            rows, beats, last_policy = policies(eng, sock, args, shape, base)
            results += rows
            results.append(dict(mode='summary', adaptive_beats_all_fixed_on=beats,
                                fixed_settings=[list(f) for f in FIXED], card=card,
                                backend=args.device))
            if args.refresh and last_policy is not None:
                prow = last_policy.rows(dict(eng.mesh.shape), shape, 'complex', 'auto',
                                        backend=args.device)
                path = ccost.persist_schedule_rows(prow, os.path.abspath(args.schedule_out))
                print(f"# persisted {len(prow)} load-level rows into {path}")
    U.write_rows(args.out, 'serve_service', args.device, results, _row_key, args.refresh)
    if beats:
        print(f"# adaptive beat every fixed setting on: {beats}")
    if beats is not None and not args.smoke:
        assert beats, ("the adaptive policy beat every fixed (watermark, max_wait_ms) "
                       "setting on NO trace")


if __name__ == "__main__":
    main()
