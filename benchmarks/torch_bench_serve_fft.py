"""Serving throughput: a sequential per-request loop against the FFTEngine,
complex and real, and the drainer's mixed stream.

Port of ``benchmarks/bench_serve_fft.py``. For each comm strategy and
for complex AND real requests of n^3 it times:

* ``sequential``: one ``plan.forward`` a request, each finished before
  the next (``torch.cuda.synchronize`` on the card), the host block
  copied to the device inside the loop as the engine's ``submit`` does;
* ``engine``: the same requests through :class:`FFTEngine` with
  ``submit`` and ``flush()``, its (coalesce width, overlap chunks) from
  ``autotune`` on the same requests.

Every engine result is held bit for bit against its per-request call
(``torch.equal``, every rank's verdict combined) before any time is
reported, and the two loops are timed interleaved, ``--repeats`` times:
the headline is each loop's minimum (the slowest rank's on a mesh), the
cross-check the median of the adjacent pairs' ratios. With ``--shapes``
it adds the continuous mode: one multi-shape engine with a background
drainer (watermark 2 and ``--deadline-ms``) serves an interleaved stream
of those shapes, complex and real, with no ``flush()`` anywhere, against
the per-shape sequential loops; ``--smoke`` runs it on ``8,16x16``.

On 1 x 1 (``--device cuda``, the default, or ``cpu``) only
``all_to_all`` runs, since every strategy is the identity on one rank;
under ``torch.distributed.run`` with ``--mesh 2x2|1x4`` every strategy
runs, each rank serving its own blocks (``FFT.in_layout``). On a mesh
every rank tunes (``autotune`` times each rank's own groups, before any
drainer starts) and adopts position 0's pick, so the ranks' groups pair
up; position 0 alone persists it.

Rank 0 prints the CSV rows (``name,us_per_call,derived``) and writes
``--out`` (default ``results/bench_torch_serve_fft.json``); ``--refresh``
merges rows by (mode, shape, mesh, strategy, kind) and persists
``autotune``'s winners through ``persist_schedule_rows`` into
``--schedule-out`` (default ``results/bench_torch_serve_schedule.json``,
never the repo root's table); ``REPRO_TORCH_SERVE_SCHEDULES`` points an
engine at it.

    python3 benchmarks/torch_bench_serve_fft.py [--n 256] [--requests 16]
        [--shapes 16,8x8x8,32x32] [--refresh] [--smoke] [--device cuda|cpu]
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 -- \\
        benchmarks/torch_bench_serve_fft.py --mesh 2x2 [--n 256]

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_util as U  # noqa: E402

from repro_torch import comm, fft  # noqa: E402
from repro_torch.serve import FFTEngine  # noqa: E402


def make_requests(shape, kind, n_requests):
    """The reference's requests: numpy, from seed 3."""
    rng = np.random.default_rng(3)
    reqs = []
    for _ in range(n_requests):
        x = rng.standard_normal(shape).astype(np.float32)
        if kind == 'complex':
            x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
        reqs.append(x)
    return reqs


def block(mesh, p, x: np.ndarray) -> np.ndarray:
    """This rank's block of the global request ``x`` under ``p``'s layout."""
    return mesh.shard(torch.from_numpy(x), p.in_layout).numpy()


def _sync(mesh) -> None:
    if mesh.device.type == 'cuda':
        torch.cuda.synchronize(mesh.device)


def run_sequential(plan, blocks, mesh):
    """One finished plan call a request: each request's swaps serialize
    against the next request's pencils."""
    outs = []
    t0 = time.perf_counter()
    for x in blocks:
        y = plan.forward(torch.as_tensor(x, device=mesh.device))
        _sync(mesh)
        outs.append(y)
    return outs, (time.perf_counter() - t0) / len(blocks) * 1e6


def run_engine(eng, blocks, shape, real, mesh):
    # submit() inside the timed region: it pays the host-to-device copy
    # the sequential loop also pays
    t0 = time.perf_counter()
    tickets = [eng.submit(x, shape=shape, real=real) for x in blocks]
    eng.flush()
    outs = [t.result() for t in tickets]
    _sync(mesh)
    return outs, (time.perf_counter() - t0) / len(blocks) * 1e6


def _bitwise(got, want, device, what) -> None:
    ok = all(torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())
             for a, b in zip(got, want))
    if not U.all_ranks(ok, device):
        raise AssertionError(f"{what}: a served output differs from per-request execution")


def adopt_leader(eng, mesh, w: int, c: int, real: bool) -> tuple:
    """Every rank adopts position 0's autotuned (width, chunks)."""
    if mesh.size == 1:
        return w, c
    t = torch.tensor([w, c], device=mesh.device)
    dist.broadcast(t, src=mesh.ranks[0])
    w, c = (int(v) for v in t.tolist())
    eng.set_schedule(w, c, real=real)
    return w, c


def bench_one(mesh, shape, strategy, kind, n_requests, repeats, args, persist=False):
    real = kind == 'real'
    reqs = make_requests(shape, kind, n_requests)
    plan = (fft.rplan(shape, mesh, comm=strategy) if real
            else fft.plan(shape, mesh, comm=strategy, donate=False))
    blocks = [block(mesh, plan, x) for x in reqs]
    eng = FFTEngine(shape, mesh, comm=strategy, schedule_table=args.schedule_out)
    lead = mesh.position == 0
    # persist=True merges the measured winner into --schedule-out
    w, c = eng.autotune(blocks, real=real, repeats=max(repeats - 1, 1),
                        persist=persist and lead)
    w, c = adopt_leader(eng, mesh, w, c, real)
    # warm both paths
    run_sequential(plan, blocks[:1], mesh)
    run_engine(eng, blocks, shape, real, mesh)
    seq_outs, _ = run_sequential(plan, blocks, mesh)
    eng_outs, _ = run_engine(eng, blocks, shape, real, mesh)
    _bitwise(eng_outs, seq_outs, args.device, f"{kind}, {strategy}")
    del seq_outs, eng_outs
    seq_ts, eng_ts = [], []
    for _ in range(repeats):                       # interleaved timing
        seq_ts.append(U.slowest(run_sequential(plan, blocks, mesh)[1]))
        eng_ts.append(U.slowest(run_engine(eng, blocks, shape, real, mesh)[1]))
    eng.close()
    # host wall time drifts, so: interleave the two loops, take each
    # loop's min (the uncontended floor) for the headline ratio, and keep
    # the median of adjacent (seq, engine) pair ratios as the cross-check
    seq_us, eng_us = min(seq_ts), min(eng_ts)
    ratios = sorted(s / e for s, e in zip(seq_ts, eng_ts))
    return dict(kind=kind, strategy=strategy, n_requests=n_requests,
                seq_us_per_req=seq_us, engine_us_per_req=eng_us,
                speedup=seq_us / eng_us,
                speedup_median_pairs=ratios[len(ratios) // 2],
                coalesce_width=w, overlap_chunks=c, bit_identical=True)


def parse_shapes(spec):
    """'16,8x8x8,32x32' -> [(16, 16, 16), (8, 8, 8), (32, 32)]; a bare
    integer means a cube."""
    shapes = []
    for tok in spec.split(','):
        tok = tok.strip()
        if not tok:
            continue
        if 'x' in tok:
            shapes.append(tuple(int(s) for s in tok.split('x')))
        else:
            shapes.append((int(tok),) * 3)
    return shapes


def bench_mixed(mesh, shapes, strategy, n_requests, repeats, args):
    """Continuous multi-shape serving: ONE background engine (drainer
    deadline, no flush() anywhere) against the per-shape sequential
    loops. Returns one aggregate row plus a row per shape."""
    per_shape = max(n_requests // len(shapes), 2)
    per_shape += 1 - per_shape % 2              # odd: leaves a remainder
    plans = {}
    for shape in shapes:
        plans[(shape, False)] = fft.plan(shape, mesh, comm=strategy, donate=False)
        plans[(shape, True)] = fft.rplan(shape, mesh, comm=strategy)
    reqs = []                                   # interleaved mixed stream
    for i in range(per_shape):
        for j, shape in enumerate(shapes):
            real = (i + j) % 2 == 0
            x = make_requests(shape, 'real' if real else 'complex', 1)[0]
            reqs.append((shape, real, block(mesh, plans[(shape, real)], x)))

    def run_sequential_mixed(sub=reqs):
        outs = []
        t0 = time.perf_counter()
        for shape, real, x in sub:
            y = plans[(shape, real)].forward(torch.as_tensor(x, device=mesh.device))
            _sync(mesh)
            outs.append(y)
        return outs, (time.perf_counter() - t0) / len(sub) * 1e6

    def run_drainer(eng):
        t0 = time.perf_counter()
        tickets = [eng.submit(x, shape=shape, real=real) for shape, real, x in reqs]
        outs = [t.result(timeout=600) for t in tickets]
        _sync(mesh)
        return outs, (time.perf_counter() - t0) / len(reqs) * 1e6

    per_shape_seq = {}
    # watermark 2 + the deadline: full pairs dispatch on the watermark,
    # the odd remainder of every (shape, kind) queue rides the deadline
    # — both drainer triggers are exercised every run
    with FFTEngine(mesh=mesh, comm=strategy, watermark=2, max_wait_ms=args.deadline_ms,
                   schedule_table=args.schedule_out) as eng:
        for shape in shapes:                    # a rank's block names no shape
            eng.plan_for(False, shape)
            eng.plan_for(True, shape)
        run_sequential_mixed()                  # warm both paths
        run_drainer(eng)
        seq_outs, _ = run_sequential_mixed()
        eng_outs, _ = run_drainer(eng)
        _bitwise(eng_outs, seq_outs, args.device, f"drainer ({strategy})")
        del seq_outs, eng_outs
        seq_ts, eng_ts = [], []
        for _ in range(repeats):                # interleaved timing
            seq_ts.append(U.slowest(run_sequential_mixed()[1]))
            eng_ts.append(U.slowest(run_drainer(eng)[1]))
        # per-shape sequential floor (the engine serves the mixed
        # stream as a whole, so per-shape ratios share its us/request)
        for shape in shapes:
            per_shape_seq[shape] = U.slowest(
                run_sequential_mixed([r for r in reqs if r[0] == shape])[1])
        served = {f"{'x'.join(map(str, s))}{'/real' if r else ''}"
                  for s, r in eng.serving_shapes()}
    seq_us, eng_us = min(seq_ts), min(eng_ts)
    ratios = sorted(s / e for s, e in zip(seq_ts, eng_ts))
    rows = [dict(mode='drainer', kind='mixed', strategy=strategy,
                 shape=[list(s) for s in shapes], mesh=args.mesh,
                 n_requests=len(reqs), deadline_ms=args.deadline_ms,
                 seq_us_per_req=seq_us, engine_us_per_req=eng_us,
                 speedup=seq_us / eng_us,
                 speedup_median_pairs=ratios[len(ratios) // 2],
                 served_plans=sorted(served), bit_identical=True)]
    for shape in shapes:
        rows.append(dict(
            mode='drainer', kind='per_shape', strategy=strategy,
            shape=list(shape), mesh=args.mesh,
            seq_us_per_req=per_shape_seq[shape],
            engine_us_per_req=eng_us,
            speedup=per_shape_seq[shape] / eng_us, bit_identical=True))
    return rows


def _row_key(r):
    shape = r.get('shape')
    return (r.get('mode', 'batch'), str(shape), r.get('mesh'),
            r.get('strategy'), r.get('kind'))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=None,
                    help='the batch mode cube (default 256 on the card, 32 on the CPU)')
    ap.add_argument('--requests', type=int, default=16)
    ap.add_argument('--repeats', type=int, default=9)
    ap.add_argument('--shapes', type=str, default=None,
                    help='comma-separated shapes (16 = cube, 8x8 = rank 2) for the '
                         'continuous multi-shape drainer mode')
    ap.add_argument('--deadline-ms', type=float, default=50.0,
                    help='drainer max-wait deadline for the mixed mode')
    ap.add_argument('--refresh', action='store_true',
                    help='merge rows into --out (replace same-key rows, keep the rest) '
                         'and persist autotuned schedules into --schedule-out')
    ap.add_argument('--smoke', action='store_true',
                    help='n = 16, 8 requests, one strategy, 2 repeats, and a drainer run '
                         'on 8,16x16 with a 50 ms deadline')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--mesh', default='1x1',
                    help='RxC under torch.distributed.run (every strategy runs there)')
    ap.add_argument('--out', default=os.path.join('results', 'bench_torch_serve_fft.json'))
    ap.add_argument('--schedule-out',
                    default=os.path.join('results', 'bench_torch_serve_schedule.json'))
    args = ap.parse_args(argv)
    U.need_device(args.device)
    args.schedule_out = os.path.abspath(args.schedule_out)
    os.makedirs(os.path.dirname(args.schedule_out), exist_ok=True)
    n = 16 if args.smoke else (args.n or (256 if args.device == 'cuda' else 32))
    n_requests = 8 if args.smoke else args.requests
    repeats = 2 if args.smoke else args.repeats
    shapes_spec = args.shapes
    if args.smoke and shapes_spec is None:
        shapes_spec = '8,16x16'                # exercise the drainer in CI
    mesh = U.timing_mesh(args.mesh, args.device)
    strategies = ('all_to_all',) if args.smoke or mesh.size == 1 else comm.names()
    lead = mesh.position == 0
    say = print if lead else (lambda *a, **k: None)
    emit = U.emit if lead else (lambda *a, **k: None)
    shape = (n, n, n)
    say(f"# torch_bench_serve_fft: {n_requests} requests of {n}^3 on {args.mesh} "
        f"({U.card(args.device)})")
    say("name,us_per_call,derived")
    results = []
    for strategy in strategies:
        for kind in ('complex', 'real'):
            r = bench_one(mesh, shape, strategy, kind, n_requests, repeats, args,
                          persist=args.refresh)
            results.append(dict(mode='batch', shape=list(shape), mesh=args.mesh, **r))
            emit(f"serve_fft/{n}/{strategy}/{kind}/engine", r['engine_us_per_req'],
                 f"seq_us={r['seq_us_per_req']:.1f} speedup={r['speedup']:.2f}x "
                 f"w={r['coalesce_width']} c={r['overlap_chunks']}")
    if shapes_spec:
        shapes = parse_shapes(shapes_spec)
        for strategy in strategies:
            rows = bench_mixed(mesh, shapes, strategy, n_requests, repeats, args)
            results.extend(rows)
            agg = rows[0]
            emit(f"serve_fft/mixed/{strategy}/drainer", agg['engine_us_per_req'],
                 f"seq_us={agg['seq_us_per_req']:.1f} speedup={agg['speedup']:.2f}x "
                 f"shapes={len(shapes)} deadline={args.deadline_ms}ms")
    if lead:
        card = U.card(args.device)
        for row in results:
            row.update(card=card, backend=args.device)
        results = U.write_rows(args.out, 'serve_fft', args.device, results, _row_key,
                               args.refresh)
        if args.refresh:
            say(f"# persisted the autotuned schedules into {args.schedule_out}")
    batch = [r['speedup'] for r in results if r.get('mode') == 'batch']
    if batch:
        say(f"# worst engine speedup vs sequential loop (batch mode): {min(batch):.2f}x")
    drainer = [r['speedup'] for r in results
               if r.get('mode') == 'drainer' and r.get('kind') == 'mixed']
    if drainer:
        say(f"# continuous mode (deadline-stall included): {min(drainer):.2f}x vs the "
            "blocking loop")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
