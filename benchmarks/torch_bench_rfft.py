"""Complex against real (rfft) plans: dispatches and wire bytes counted on
the fake 4 x 4, and wall time on the card, for each comm strategy.

Port of ``benchmarks/bench_rfft.py``. Three plan kinds of an n^3
round trip (forward then inverse) a strategy:

* ``complex``: the complex plan fed the real field as complex64;
* ``real``: ``fft.rplan``, ``np.fft.rfftn``'s layout (the truncated
  axis's boundary gather included);
* ``real_padded``: ``fft.rplan(..., padded_spectrum=True)``, the native
  distributed half spectrum.

Counted (``--count``, a subprocess of its own, ``torch_bench_util``):
rank 0's round trip on ``meta`` tensors of the fake group's 4 x 4 mesh
(``launch.hlostats``: dispatched operations, kernel launches on the
card's bodies, collective operand bytes as the reference's
``wire_bytes``), deterministic and with no card. Timed: the median of
``--iters`` round trips, CUDA events on the card (``--device cuda``,
the default) on 1 x 1, or under ``torch.distributed.run`` on ``--mesh
2x2|1x4`` (the slowest rank's); ``--device cpu`` times the plain tier
on the host. Each real plan's wire bytes over the complex plan's are
printed (the reference's claim is about half); they are not asserted.
The cost model's wire cycles (``plan_cost('fp32', measured=None)``)
stand beside them.

Writes ``--out`` (default ``results/bench_torch_rfft.json``).

    python3 benchmarks/torch_bench_rfft.py [--n 32] [--smoke] [--device cuda|cpu]
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 -- \\
        benchmarks/torch_bench_rfft.py --mesh 2x2 [--n 256]

(``--``: the launcher would read a bare ``--n`` as its own option.)

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_util as U  # noqa: E402

from repro_torch import comm, fft  # noqa: E402

KINDS = ('complex', 'real', 'real_padded')


def make_plan(shape, mesh, strategy: str, kind: str):
    if kind == 'complex':
        return fft.plan(shape, mesh, comm=strategy)
    return fft.rplan(shape, mesh, comm=strategy, padded_spectrum=kind == 'real_padded')


def operand(p, kind: str, x: torch.Tensor, mesh):
    """This rank's block of the real field, complex64 for the complex plan."""
    xl = mesh.shard(x, p.in_layout)
    return xl.to(torch.complex64) if kind == 'complex' else xl


def count_rows(n: int, strategies) -> dict:
    """Each (strategy, kind)'s round trip counted on the fake 4 x 4."""
    mesh = U.count_mesh()
    out = {}
    for strategy in strategies:
        for kind in KINDS:
            p = make_plan((n, n, n), mesh, strategy, kind)
            shape = p.local_shape(p.in_layout)
            x = torch.empty(shape, dtype=torch.complex64 if kind == 'complex' else torch.float32,
                            device='meta')
            rec = U.count_call(lambda: p.inverse(p.forward(x)))
            rec['model_wire_cycles'] = p.plan_cost('fp32', measured=None).wire_cycles
            out[f'{strategy}/{kind}'] = rec
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=32)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--smoke', action='store_true', help='n = 16, one strategy, 3 iterations')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--mesh', default='1x1', help='the timed mesh (RxC under '
                    'torch.distributed.run); the counted one is always 4 x 4')
    ap.add_argument('--out', default=os.path.join('results', 'bench_torch_rfft.json'))
    ap.add_argument('--count', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    n = 16 if args.smoke else args.n
    iters = 3 if args.smoke else args.iters
    strategies = ('all_to_all',) if args.smoke else comm.names()
    if args.count:
        with open(args.count, 'w') as fh:
            json.dump(count_rows(n, strategies), fh)
        return
    U.need_device(args.device)
    mesh = U.timing_mesh(args.mesh, args.device)
    lead = mesh.position == 0
    counts = U.counted(os.path.abspath(__file__),
                       ['--n', str(n)] + (['--smoke'] if args.smoke else [])) if lead else {}
    say = print if lead else (lambda *a, **k: None)
    say(f'# torch_bench_rfft: fwd+inv round trip, {n}^3; counted on the fake 4x4 (meta), '
        f'timed on {args.mesh} ({U.card(args.device)})')
    say('kind,strategy,us,dispatches,launches,wire_bytes,model_wire_cycles')
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((n, n, n)).astype(np.float32),
                        device=mesh.device)
    results = []
    for strategy in strategies:
        rows = {}
        for kind in KINDS:
            p = make_plan((n, n, n), mesh, strategy, kind)
            xl = operand(p, kind, x, mesh)
            us = U.slowest(U.time_us(lambda: p.inverse(p.forward(xl)), args.device,
                                     iters=iters))
            if not lead:
                continue
            c = counts[f'{strategy}/{kind}']
            rows[kind] = r = dict(kind=kind, strategy=strategy, us=us, dispatches=c['ops'],
                                  **{k: c[k] for k in ('launches', 'kernels', 'wire_bytes',
                                                       'wire_ring_bytes', 'collectives',
                                                       'model_wire_cycles')})
            results.append(dict(shape=[n] * 3, counted_mesh='4x4', timed_mesh=args.mesh, **r))
            say(f"{kind},{strategy},{us:.3f},{c['ops']},{c['launches']},"
                f"{c['wire_bytes']:.0f},{c['model_wire_cycles']:.6g}")
        if not lead:
            continue
        cb = rows['complex']
        for kind in ('real', 'real_padded'):
            rb = rows[kind]
            say(f"#   {strategy}/{kind}: wire {rb['wire_bytes'] / max(cb['wire_bytes'], 1):.2f}x"
                f"  wall {rb['us'] / cb['us']:.2f}x"
                f"  model-wire {rb['model_wire_cycles'] / cb['model_wire_cycles']:.2f}x"
                " (vs complex)")
    if lead:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(dict(benchmark='rfft', device=U.card(args.device), results=results), f,
                      indent=1)
        say(f'wrote {args.out} ({len(results)} rows)')


if __name__ == '__main__':
    main()
