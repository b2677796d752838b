"""Roofline dry run of the paper's own artifact: the distributed 3-D FFT
on the production meshes, counted with no card.

Port of ``benchmarks/roofline_fft.py``. The paper's 512^3 on 512 x 512
PEs maps to 512^3 on 16 x 16 cards: each card owns 32^2 = 1024 pencils
of 512 a superstep, the §4.4 multi-pencil regime the paper analyzes but
never runs. The multi-pod mesh (2 x 16 x 16) folds a batch of
independent transforms over 'pod' (``batch_spec='pod'``): no swap
crosses pods.

The reference compiles the plan for 256 or 512 fake XLA devices and
reads the HLO. The port runs rank 0's forward and inverse of
``fft.plan((n,)*3, mesh, mesh_axes=('x', 'y'), overlap_chunks=1)`` once
on ``meta`` tensors, on ``make_fft_mesh(16, 16, pods=, device='meta')``
under ``dryrun.init_fake_world`` (collectives move nothing), counted by
``launch.hlostats``: the swaps' collectives, and the hand-written
kernels' launches (``kernels``, each on the body the card runs, with its
bytes and flops), which a ``meta`` tensor reports as the card does.
``$REPRO_TORCH_MEASURED_COSTS`` is set to '' here, so ``comm='auto'``
prices every swap with the analytic model, as the parity tests do.

Each record is the reference's, ``<mesh>__wsfft__<n>__<method>[__tag].json``
under ``--out`` (default ``results/dryrun_torch``), with ``build_s`` and
``step_s`` in place of ``compile_s``, the ``kernels`` entry, no
``cost_flops``/``cost_bytes`` (no compiler to ask), and the H100
datasheet constants of ``launch.dryrun`` (not measurements).
``transpose_bytes_min`` is the bytes a card must send for the four
swaps of a forward and an inverse, ``4 * pods * n^3 * 8 / cards``
(the reference's formula leaves out ``pods``).

    python3 benchmarks/torch_roofline_fft.py            # the reference's sweep
    python3 benchmarks/torch_roofline_fft.py --n 512 [--method stockham]
        [--pods 2] [--mesh 16x16] [--tag T] [--out DIR]

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ['REPRO_TORCH_MEASURED_COSTS'] = ''

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'src'))

import torch  # noqa: E402

from repro_torch import fft  # noqa: E402
from repro_torch.core import wse_model as wm  # noqa: E402
from repro_torch.launch import dryrun, hlostats  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402

#: the reference's sweep: (n, method, pods, tag)
SWEEP = [(256, 'auto', 1, ''), (512, 'auto', 1, ''), (512, 'stockham', 1, 'faithful'),
         (512, 'auto', 2, '')]


def mesh_tag(rows: int, cols: int, pods: int) -> str:
    return f'multipod_{pods}x{rows}x{cols}' if pods > 1 else f'pod_{rows}x{cols}'


def fft_model_flops(n: int, *, pods: int = 1, loop: int = 2) -> float:
    """Useful flops: the paper's 3 n^2 * 5 n log2 n a transform (x2 for
    forward and inverse, x pods transforms)."""
    return wm.fft_flops_3d(n) * loop * pods


def count_fft(n: int, *, rows: int = 16, cols: int = 16, pods: int = 1,
              method: str = 'auto', overlap_chunks: int = 1):
    """Rank 0's forward and inverse of the plan on ``meta``, counted:
    ``(plan, build seconds, step seconds, counter, argument bytes)``."""
    dryrun.init_fake_world(rows * cols * pods)
    t0 = time.time()
    mesh = make_fft_mesh(rows, cols, pods=pods, device='meta')
    p = fft.plan((n, n, n), mesh, method=method, mesh_axes=('x', 'y'),
                 overlap_chunks=overlap_chunks, batch_spec='pod' if pods > 1 else None)
    shape = ((1,) if pods > 1 else ()) + tuple(p.local_shape(p.in_layout))
    re, im = (torch.empty(shape, dtype=torch.float32, device='meta') for _ in range(2))
    t1 = time.time()
    with hlostats.count() as st:
        p.inverse(p.forward((re, im)))
    t2 = time.time()
    return p, t1 - t0, t2 - t1, st, 2 * re.numel() * re.element_size()


def run(n: int, *, rows: int = 16, cols: int = 16, pods: int = 1, method: str = 'auto',
        overlap_chunks: int = 1, out_dir: str = 'results/dryrun_torch', tag: str = '') -> dict:
    p, build_s, step_s, st, arg_bytes = count_fft(n, rows=rows, cols=cols, pods=pods,
                                                  method=method,
                                                  overlap_chunks=overlap_chunks)
    n_chips = rows * cols * pods
    stats = st.analyze()
    stats['num_partitions'] = n_chips
    stats['collective_wire_by_link'] = dryrun.wire_by_link(st)
    roof = dryrun.roofline_terms(stats)
    mf = fft_model_flops(n, pods=pods)
    ideal = mf / (n_chips * dryrun.PEAK_FLOPS['float32'])
    rec = {
        'arch': f'wsfft-{n}cubed' + (f'-x{pods}pods' if pods > 1 else ''),
        'shape': f'fft_{n}', 'mesh': mesh_tag(rows, cols, pods),
        'kind': 'fft', 'method': method, 'resolved_method': p.method,
        'comm': p.comm, 'dtype': 'float32',
        'overlap_chunks': overlap_chunks, 'status': 'ok', 'n_chips': n_chips,
        'build_s': round(build_s, 2), 'step_s': round(step_s, 2),
        'hlo': stats, 'kernels': stats['kernels'], 'model_flops': mf, 'roofline': roof,
        'roofline_fraction': ideal / roof['bound_s'] if roof['bound_s'] else 0.0,
        'memory': {'temp_size_in_bytes': st.peak_live_bytes,
                   'argument_size_in_bytes': arg_bytes},
        'transpose_bytes_min': 4 * pods * n ** 3 * 8 / n_chips,
        'constants': 'NVIDIA H100 SXM5 80 GB datasheet, 700 W: not measured',
    }
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{rec['mesh']}__wsfft__{n}__{method}"
                      + (f'__{tag}' if tag else '') + '.json')
    with open(fn, 'w') as f:
        json.dump(rec, f, indent=1)
    launches = ' '.join(f'{k}={v["launches"]}' for k, v in sorted(stats['kernels'].items()))
    print(f"[fft-roofline] n={n} pods={pods} method={method} dtype=float32 "
          f"chips={n_chips}: compute={roof['compute_s'] * 1e6:.1f}us "
          f"memory={roof['memory_s'] * 1e6:.1f}us "
          f"collective={roof['collective_s'] * 1e6:.1f}us dom={roof['dominant']} "
          f"frac={rec['roofline_fraction']:.4f} build={rec['build_s']}s "
          f"step={rec['step_s']}s {launches}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=0, help='0 = the reference sweep')
    ap.add_argument('--method', default='auto')
    ap.add_argument('--pods', type=int, default=1)
    ap.add_argument('--mesh', default='16x16', help='rows x cols of each pod')
    ap.add_argument('--overlap', type=int, default=1)
    ap.add_argument('--tag', default='')
    ap.add_argument('--out', default='results/dryrun_torch')
    args = ap.parse_args(argv)
    rows, cols = (int(v) for v in args.mesh.split('x'))
    if args.n:
        run(args.n, rows=rows, cols=cols, pods=args.pods, method=args.method,
            overlap_chunks=args.overlap, out_dir=args.out, tag=args.tag)
        return
    dryrun.init_fake_world(rows * cols * max(p for *_, p, _ in SWEEP))
    for n, method, pods, tag in SWEEP:
        run(n, rows=rows, cols=cols, pods=pods, method=method, out_dir=args.out, tag=tag)


if __name__ == '__main__':
    main()
