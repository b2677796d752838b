"""The fused operator plan against its unfused composition at the FFT-conv
mixer's shape: dispatches and wire bytes counted on the fake 4 x 4, and
wall time on the card, for each comm strategy.

Port of ``benchmarks/bench_fftconv.py``. Three ways to run the same
causal convolution (``models/ssd.py:fftconv_apply``'s workload: a
(B, d, n) batch of rank-1 real transforms of length n = 2 S):

* ``unfused``: ``rplan`` forward of x, forward of k, the pointwise
  product (``fft.spectral_mul``), inverse: four calls, the spectrum
  crossing the rfft boundary gather between them;
* ``fused``: ``fft.plan_op(..., n_spectra=1)``, the training path, the
  kernel's spectrum a runtime operand of the same call;
* ``fused_baked``: ``fft.plan_op(..., spectra=(k,))``, the eval path,
  the kernel transformed once (its bake outside the timed calls).

Counted (``--count``, a subprocess of its own, ``torch_bench_util``):
rank 0's call of each on ``meta`` tensors of the fake group's 4 x 4
mesh (``launch.hlostats``): ``dispatches`` (the operations dispatched,
the port's eager counterpart of the reference's four executables
against one), kernel launches on the card's bodies and collective
operand bytes (``wire_bytes``), with ``calls`` the reference's count of
separate calls (4, 1, 1). Asserted on every run, as the reference
asserts: each fused kind's wire bytes at or below the unfused
composition's, strictly fewer dispatches, and one bake
(``bake_count == 1``). Timed: the median of ``--iters`` calls, CUDA
events on the card (``--device cuda``, the default) on 1 x 1, or under
``torch.distributed.run`` on ``--mesh 2x2|1x4`` (the slowest rank's);
``--device cpu`` times the plain tier on the host.

Writes ``--out`` (default ``results/bench_torch_fftconv.json``).

    python3 benchmarks/torch_bench_fftconv.py [--seq 512] [--smoke] [--device cuda|cpu]
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        benchmarks/torch_bench_fftconv.py --mesh 2x2

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

from repro_torch import fft  # noqa: E402

STRATEGIES = ('all_to_all', 'ppermute', 'hierarchical')
KINDS = ('unfused', 'fused', 'fused_baked')
#: the separate calls of each kind (the reference's ``dispatches``)
CALLS = {'unfused': 4, 'fused': 1, 'fused_baked': 1}


def _pointwise(y, k):
    return torch.complex(*fft.spectral_mul(y.real, y.imag, (k.real, k.imag)))


def make_calls(mesh, n: int, strategy: str, x, k, kg):
    """{kind: a no-argument call} on this rank's blocks ``x`` (B, d, n/p)
    and ``k`` (d, n/p); ``kg`` the whole kernel (d, n) the baked plan
    keeps its block of. Also returns the baked operator."""
    rp = fft.rplan((n,), mesh, comm=strategy)
    op = fft.plan_op((n,), mesh, op=fft.spectral_mul, real=True, n_spectra=1, comm=strategy)
    opb = fft.plan_op((n,), mesh, op=fft.spectral_mul, real=True, spectra=(kg,),
                      comm=strategy)
    opb.apply(x)                                   # the bake, outside every counted call
    return {'unfused': lambda: rp.inverse(_pointwise(rp.forward(x), rp.forward(k))),
            'fused': lambda: op.apply(x, k),
            'fused_baked': lambda: opb.apply(x)}, opb


def count_rows(n: int, batch, strategies) -> dict:
    """Each (strategy, kind)'s call counted on the fake 4 x 4."""
    mesh = U.count_mesh()
    out = {}
    for strategy in strategies:
        local = fft.rplan((n,), mesh, comm=strategy).local_shape(
            fft.rplan((n,), mesh, comm=strategy).in_layout)
        x = torch.empty(tuple(batch) + tuple(local), device='meta')
        k = torch.empty((batch[-1],) + tuple(local), device='meta')
        kg = torch.empty((batch[-1], n), device='meta')
        calls, opb = make_calls(mesh, n, strategy, x, k, kg)
        for kind in KINDS:
            out[f'{strategy}/{kind}'] = U.count_call(calls[kind])
        out[f'{strategy}/bake_count'] = opb.bake_count
    return out


def check(rows: dict, strategy: str) -> None:
    """The reference's claims: fusion never adds wire bytes and always
    removes dispatches; the baked kernel is transformed once."""
    un = rows['unfused']
    for kind in ('fused', 'fused_baked'):
        fb = rows[kind]
        assert fb['wire_bytes'] <= un['wire_bytes'], (strategy, kind, fb, un)
        assert fb['dispatches'] < un['dispatches'], (strategy, kind, fb, un)
    assert rows['bake_count'] == 1, (strategy, rows['bake_count'])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seq', type=int, default=512, help='sequence length S; n = 2 S')
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--smoke', action='store_true',
                    help='S = 128, batch (2, 4), one strategy, 3 iterations')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--mesh', default='1x1', help='the timed mesh (RxC under '
                    'torch.distributed.run); the counted one is always 4 x 4')
    ap.add_argument('--out', default=os.path.join('results', 'bench_torch_fftconv.json'))
    ap.add_argument('--count', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    S = 128 if args.smoke else args.seq
    iters = 3 if args.smoke else args.iters
    strategies = STRATEGIES[:1] if args.smoke else STRATEGIES
    n = 2 * S
    batch = (2, 4) if args.smoke else (4, 8)          # (B, d)
    if args.count:
        with open(args.count, 'w') as fh:
            json.dump(count_rows(n, batch, strategies), fh)
        return
    U.need_device(args.device)
    mesh = U.timing_mesh(args.mesh, args.device)
    lead = mesh.position == 0
    counts = U.counted(os.path.abspath(__file__),
                       ['--seq', str(S)] + (['--smoke'] if args.smoke else [])) if lead else {}
    say = print if lead else (lambda *a, **k: None)
    say(f'# torch_bench_fftconv: causal conv len n={n}, batch {batch}; counted on the fake '
        f'4x4 (meta), timed on {args.mesh} ({U.card(args.device)})')
    say('kind,strategy,us,calls,dispatches,launches,wire_bytes')
    rng = np.random.default_rng(0)
    xg = torch.as_tensor(rng.standard_normal(batch + (n,)).astype(np.float32),
                         device=mesh.device)
    kg = torch.as_tensor(rng.standard_normal((batch[-1], n)).astype(np.float32),
                         device=mesh.device)
    results = []
    for strategy in strategies:
        lay = fft.rplan((n,), mesh, comm=strategy).in_layout
        x, k = mesh.shard(xg, lay, batch_ndim=2), mesh.shard(kg, lay, batch_ndim=1)
        calls, _ = make_calls(mesh, n, strategy, x, k, kg)
        rows = {'bake_count': counts.get(f'{strategy}/bake_count')}
        for kind in KINDS:
            us = U.slowest(U.time_us(calls[kind], args.device, iters=iters))
            if not lead:
                continue
            c = counts[f'{strategy}/{kind}']
            rows[kind] = r = dict(kind=kind, strategy=strategy, us=us, calls=CALLS[kind],
                                  dispatches=c['ops'],
                                  **{k: c[k] for k in ('launches', 'kernels', 'wire_bytes',
                                                       'wire_ring_bytes', 'collectives')})
            results.append(dict(n=n, batch=list(batch), counted_mesh='4x4',
                                timed_mesh=args.mesh, **r))
            say(f"{kind},{strategy},{us:.3f},{CALLS[kind]},{c['ops']},{c['launches']},"
                f"{c['wire_bytes']:.0f}")
        if not lead:
            continue
        check(rows, strategy)
        un = rows['unfused']
        for kind in ('fused', 'fused_baked'):
            fb = rows[kind]
            say(f"#   {strategy}/{kind}: wire {fb['wire_bytes'] / max(un['wire_bytes'], 1):.2f}x"
                f"  dispatches {fb['dispatches']}/{un['dispatches']}"
                f"  wall {fb['us'] / un['us']:.2f}x (vs unfused)")
    if lead:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(dict(benchmark='fftconv', device=U.card(args.device), results=results),
                      f, indent=1)
        say(f'wrote {args.out} ({len(results)} rows; claims held)')


if __name__ == '__main__':
    main()
