"""Time the default plan of a non-power-of-two cube on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 benchmarks/torch_direct_plan.py [--n 768] [--reps 5] [--chunks 8] [--src DIR]

At a non-power-of-two n, ``repro_torch.fft.plan((n,)*3, make_fft_mesh(1, 1))``
resolves to ``method='direct'``, the dense DFT, which runs as plain
PyTorch matrix products on the card (there is no hand-written kernel for
it). The script makes a complex64 operand from one seed on the card,
then prints one JSON line with:

* ``fwd_inv_ms``: fwd+inv by CUDA events, median of ``--reps`` (after
  ``--warmup`` calls), and ``fwd_ms`` likewise;
* ``peak_gib_over_operand``: the most memory allocated during one fwd+inv
  beyond what was allocated before it (the operand and the reference);
* ``fwd_rel_l2`` against ``torch.fft.fftn`` and ``roundtrip_rel_l2``
  (each <= 1e-5);
* with ``--chunks c`` > 0: whether the plan with ``overlap_chunks=c``
  gives the unchunked plan's forward and inverse bit for bit.

``--src`` imports ``repro_torch`` from another tree's ``src`` (an older
commit, unpacked), so that two versions are compared in one run. A
``torch.cuda.OutOfMemoryError`` is reported in the line, not raised. The
card's name and power limit are printed before it. It imports neither jax
nor the JAX package, and fails without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
RTOL = 1e-5


def time_ms(fn, reps: int, warmup: int) -> float:
    """Median device time of one call by CUDA events."""
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
    ms = sorted(a.elapsed_time(b) for a, b in events)
    return ms[len(ms) // 2]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def measure(n: int, reps: int, warmup: int, chunks: int) -> dict:
    import repro_torch.fft as fft
    from repro_torch.launch.mesh import make_fft_mesh
    p = fft.plan((n, n, n), make_fft_mesh(1, 1))
    out = dict(n=n, method=p.method, comm=p.comm,
               overlap_chunks=getattr(p, 'overlap_chunks', 1))
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    x = torch.complex(torch.randn((n, n, n), generator=gen, device='cuda'),
                      torch.randn((n, n, n), generator=gen, device='cuda'))
    want = torch.fft.fftn(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        y = p.forward(x)
        x2 = p.inverse(y)
        torch.cuda.synchronize()
        out['peak_gib_over_operand'] = (torch.cuda.max_memory_allocated() - base) / 2**30
        out['fwd_rel_l2'] = rel_l2(y, want)
        out['roundtrip_rel_l2'] = rel_l2(x2, x)
        if chunks > 0:
            q = p.with_options(overlap_chunks=chunks)
            yc = q.forward(x)
            out['chunks'] = chunks
            out['bitwise_vs_unchunked'] = (torch.equal(yc, y)
                                           and torch.equal(q.inverse(yc), x2))
            del yc
        del y, x2, want
        out['fwd_inv_ms'] = time_ms(lambda: p.inverse(p.forward(x)), reps, warmup)
        out['fwd_ms'] = time_ms(lambda: p.forward(x), reps, warmup)
    except torch.cuda.OutOfMemoryError as e:
        out['out_of_memory'] = str(e).splitlines()[0]
        out['peak_gib_over_operand'] = (torch.cuda.max_memory_allocated() - base) / 2**30
    out['ok'] = ('out_of_memory' not in out and out['fwd_rel_l2'] <= RTOL
                 and out['roundtrip_rel_l2'] <= RTOL
                 and out.get('bitwise_vs_unchunked', True))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=768)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--warmup', type=int, default=2)
    ap.add_argument('--chunks', type=int, default=8,
                    help='also check overlap_chunks=CHUNKS bitwise (0: skip)')
    ap.add_argument('--src', default=os.path.join(ROOT, 'src'),
                    help='the tree whose repro_torch is timed')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_direct_plan: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    out = measure(args.n, args.reps, args.warmup, args.chunks)
    out['src'] = os.path.relpath(os.path.abspath(args.src), ROOT)
    print(json.dumps(out), flush=True)
    if not out['ok']:
        sys.exit("torch_direct_plan: a check failed (see the line above)")


if __name__ == '__main__':
    main()
