"""Time the default 512^3 plan on a 2 x 2 mesh of four NVIDIA GPUs.

Run from the root of a checkout, on a machine with four cards:

    python3 benchmarks/torch_mesh_overlap.py [--n 512] [--reps 5] [--chunks 1,2,4,8]

Four NCCL ranks (one process and one card each, ``tcp://localhost``)
plan ``repro_torch.fft.plan((n,)*3, make_fft_mesh(2, 2))`` with its
defaults, which the cost model resolves to ``all_to_all`` with 8 overlap
chunks and ``four_step`` at n = 512, and the same plan with each of
``--chunks`` overlap chunks. Each rank makes the global complex64
operand from one seed on its card, takes its block, and checks:

* every chunked forward equals the unchunked one bit for bit;
* the forward against ``torch.fft.fftn`` of the global array, and the
  round trip, relative L2 over all ranks (<= 1e-5);
* the default plan's kernel launches per direction: 17 ``fft_matmul``
  (8 + 8 chunks and the last superstep), all on the tensor-core body.

Then each rank times fwd+inv of every plan by CUDA events (median of
``--reps``, the plans in turns: in order of chunks, then in reverse, a
barrier before each series); each chunked plan also as ``<c>_serial``,
every swap finished as soon as it is started, so that its chunks run
one after another with no collective in flight during compute (the
same bytes, collectives and kernels: what the overlap itself costs or
saves). It profiles one call of the default plan
and of the unchunked one (device time by kernel, NCCL's included; a
rank's NCCL kernels also count the time they wait for their peers).
The mesh's time is the slowest rank's. Printed: the cards' names and power limits, one line per
plan, and a JSON summary line last. It imports neither jax nor the JAX
package, and fails without four cards.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'src'))

import repro_torch.fft as fft  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.comm import strategies  # noqa: E402
from repro_torch.kernels import _build, fft_matmul  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402

WORLD = 4
SEED = 0
RTOL = 1e-5


def time_ms(fn, reps: int, warmup: int = 2) -> list:
    """``reps`` samples of one call's device time by CUDA events, the
    calls queued back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def profile(fn) -> dict:
    """Device time by kernel over one call, and the device's busy time."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + e.self_device_time_total
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=sum(per_kernel.values()) / 1e3,
                top=[[k[:48], round(v / 1e3, 3)] for k, v in top])


class serial_swaps:
    """Within the block, every all-to-all swap finishes where it starts."""

    def __enter__(self):
        self.start = strategies.AllToAllStrategy.swap_start

        def start(strategy, *args, **kw):
            y = self.start(strategy, *args, **kw).wait()
            return strategies.PendingSwap(lambda: y)
        strategies.AllToAllStrategy.swap_start = start

    def __exit__(self, *exc):
        strategies.AllToAllStrategy.swap_start = self.start


def run(rank: int, port: int, n: int, reps: int, chunks: tuple, out: str) -> None:
    torch.cuda.set_device(rank)
    # a rank that stops fails the others in minutes, not at NCCL's default
    dist.init_process_group('nccl', init_method=f'tcp://localhost:{port}', rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_fft_mesh(2, 2)
        p = fft.plan((n, n, n), mesh)
        if (p.comm, p.overlap_chunks, p.method) != ('all_to_all', 8, 'four_step'):
            raise AssertionError(f"default plan resolved to {p.comm}/{p.overlap_chunks}/"
                                 f"{p.method}")
        plans = {c: p.with_options(overlap_chunks=c) for c in chunks}
        q = plans[1]
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        x = torch.complex(torch.randn((n, n, n), generator=gen, device='cuda'),
                          torch.randn((n, n, n), generator=gen, device='cuda'))
        want = mesh.shard(torch.fft.fftn(x), p.out_layout)
        xb = mesh.shard(x, p.in_layout)
        del x
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        y = p.forward(xb)
        fwd = kernels.launch_counts()
        x2 = p.inverse(y)
        torch.cuda.synchronize()
        total = kernels.launch_counts()
        mma = fft_matmul.launches_mma
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        y1 = q.forward(xb)
        differ = sum(not torch.equal(plan.forward(xb), y1) for plan in plans.values())
        sums = torch.tensor([float(torch.linalg.vector_norm(y - want)) ** 2,
                             float(torch.linalg.vector_norm(want)) ** 2,
                             float(torch.linalg.vector_norm(x2 - xb)) ** 2,
                             float(torch.linalg.vector_norm(xb)) ** 2,
                             float(differ + (not torch.equal(y, y1)))], device='cuda',
                            dtype=torch.float64)
        dist.all_reduce(sums)
        del y, y1, x2, want
        series = {}
        for c in chunks + chunks[::-1]:
            for serial in (False, True) if c > 1 else (False,):
                dist.barrier()
                with serial_swaps() if serial else contextlib.nullcontext():
                    series.setdefault(f"{c}_serial" if serial else str(c), []).extend(
                        time_ms(lambda plan=plans[c]: plan.inverse(plan.forward(xb)), reps))
        # every rank profiles: the plans' collectives need all four
        prof = {name: profile(lambda plan=plan: plan.inverse(plan.forward(xb)))
                for name, plan in (('unchunked', q), ('default', p))}
        mine = dict(rank=rank, launches_fwd=fwd, launches=total, launches_mma=mma,
                    peak_gib_over_operand=peak_gib, device=torch.cuda.get_device_name(rank),
                    ms={k: sorted(v)[len(v) // 2] for k, v in series.items()}, profile=prof)
        every = [None] * WORLD
        dist.all_gather_object(every, mine)
        if rank == 0:
            fwd_err = (sums[0] / sums[1]).sqrt().item()
            rt_err = (sums[2] / sums[3]).sqrt().item()
            ok = (sums[4].item() == 0 and fwd_err <= RTOL and rt_err <= RTOL
                  and all(r['launches_fwd']['fft_matmul'] == 17
                          and r['launches']['fft_matmul'] == 34 and r['launches_mma'] == 34
                          and sum(r['launches'].values()) == 34 for r in every))
            summary = dict(n=n, mesh='2x2', plan=[p.comm, p.overlap_chunks, p.method],
                           bitwise_vs_unchunked=sums[4].item() == 0,
                           fwd_rel_l2=fwd_err, roundtrip_rel_l2=rt_err,
                           fwd_inv_ms_by_chunks={k: max(r['ms'][k] for r in every)
                                                 for k in every[0]['ms']},
                           ranks=every, ok=ok)
            with open(out, 'w') as fh:
                json.dump(summary, fh)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=512)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--chunks', default='1,2,4,8',
                    help='overlap chunk counts to time (1 is always included)')
    ap.add_argument('--out', default=os.path.join(ROOT, 'build', 'mesh_overlap.json'))
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        sys.exit(f"torch_mesh_overlap: needs {WORLD} CUDA devices")
    cards = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], check=True, capture_output=True,
                           text=True).stdout.strip().splitlines()
    for c in cards:
        print(f"[card] {c}", flush=True)
    _build.build()           # once, before the ranks start
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    chunks = tuple(sorted({1, *(int(c) for c in args.chunks.split(','))}))
    mp.spawn(run, args=(port, args.n, args.reps, chunks, args.out), nprocs=WORLD,
             join=True)
    with open(args.out) as fh:
        summary = json.load(fh)
    for r in summary['ranks']:
        print(f"[rank] {r['rank']} device={r['device']!r} ms={json.dumps(r['ms'])} "
              f"peak_gib_over_operand={r['peak_gib_over_operand']:.4g} "
              f"launches={json.dumps(r['launches'])} launches_mma={r['launches_mma']}",
              flush=True)
        for name, prof in r['profile'].items():
            print(f"[profile] rank={r['rank']} plan={name} {json.dumps(prof)}", flush=True)
    print(json.dumps({k: v for k, v in summary.items() if k != 'ranks'}), flush=True)
    if not summary['ok']:
        sys.exit("torch_mesh_overlap: a check failed (see the summary)")


if __name__ == '__main__':
    main()
