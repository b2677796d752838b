"""Serve a continuous mixed stream of FFT requests — no flush() calls.

The PyTorch counterpart of ``examples/serve_fft.py``: a stream of
independent transform requests (three shapes, complex fields AND real
fields, which route to rfft plans) goes to one
:class:`repro_torch.serve.FFTEngine` whose background drainer coalesces
them into batched, overlap-pipelined calls. A kind's queue dispatches
when it reaches its coalesce-width watermark or when its oldest request
has waited ``--deadline-ms``; ``submit(...).result()`` is all a client
calls. The outputs are bitwise those of each request alone.

On a mesh of several ranks (``--mesh RxC`` under
``torch.distributed.run``) every rank runs this same program: it makes
the same global requests from the seed, submits its block of each in
the same order from one thread, and position 0's drainer decides every
pass for all the ranks' engines (see ``repro_torch.serve.fft_engine``).
Rank 0 prints.

    PYTHONPATH=src python examples/torch_serve_fft.py --n 32 --requests 12
    PYTHONPATH=src python examples/torch_serve_fft.py --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        examples/torch_serve_fft.py --mesh 2x2 --device cpu
"""
import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_fft_mesh
from repro_torch.serve import FFTEngine
from repro_torch.weights import from_numpy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=32)
    ap.add_argument('--requests', type=int, default=12)
    ap.add_argument('--deadline-ms', type=float, default=5.0)
    ap.add_argument('--mesh', default='1x1')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args()
    rows, cols = (int(t) for t in args.mesh.split('x'))
    if rows * cols > 1:
        if 'LOCAL_RANK' not in os.environ:
            raise SystemExit(f'--mesh {args.mesh}: run under python -m torch.distributed.run '
                             f'--standalone --nproc-per-node {rows * cols}')
        if args.device == 'cuda':
            torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
        dist.init_process_group('nccl' if args.device == 'cuda' else 'gloo')
    mesh = make_fft_mesh(rows, cols, device=args.device)
    n = args.n
    shapes = [(n, n, n), (n // 2, n // 2, n // 2), (n, n)]
    rng = np.random.default_rng(0)

    # a mixed request stream: three shapes interleaved, half real fields
    # (rfft plans, half the wire a request), half complex
    reqs = []
    for i in range(args.requests):
        shape = shapes[i % len(shapes)]
        x = rng.standard_normal(shape).astype(np.float32)
        if i % 2:
            x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
        reqs.append(x)

    # watermark 2: full pairs dispatch at once; odd remainders in any
    # (shape, kind) queue ride the deadline — both triggers live
    with FFTEngine(mesh=mesh, max_wait_ms=args.deadline_ms, watermark=2,
                   schedule_table=None) as eng:
        # this rank's block of each request (the whole array on one rank)
        blocks = [mesh.shard(from_numpy(x, mesh.device),
                             eng.plan_for(not np.iscomplexobj(x), shape=x.shape).in_layout)
                  for x in reqs]
        for _ in range(2):                       # a warm pass, then the timed one
            if mesh.device.type == 'cuda':
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            tickets = [eng.submit(b, shape=x.shape) for b, x in zip(blocks, reqs)]
            outs = [t.result(timeout=600) for t in tickets]
            if mesh.device.type == 'cuda':
                torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / len(reqs) * 1e6
        schedules = {(shape, real): eng.schedule(real, shape)
                     for shape, real in eng.serving_shapes()}
    # per-request plans, bit-identical by contract (every rank together,
    # once the engine is closed; on a mesh the plans position 0's passes
    # set, as served)
    for b, x, y in zip(blocks, reqs, outs):
        assert torch.equal(y, eng.plan_for(not np.iscomplexobj(x), shape=x.shape).forward(b))

    if mesh.position == 0:
        print(f'[serve_fft] {args.requests} mixed requests ({len(shapes)} shapes) on '
              f'{args.mesh} ({args.device}): {dt:.0f} us/request, zero flush() calls')
        for (shape, real), (w, c) in schedules.items():
            print(f"  {'x'.join(map(str, shape))}{' real' if real else ' complex'}: "
                  f"coalesce={w} overlap_chunks={c}")
        print('  outputs bit-identical to per-request plans; engine closed cleanly')
        print('serve_fft OK')
    if rows * cols > 1:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
