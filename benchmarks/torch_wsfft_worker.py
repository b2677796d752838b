"""Time one distributed 3-D forward of the port's wsFFT and print its row.

Port of ``benchmarks/_wsfft_worker.py``: ``fft.plan((n,)*3, mesh,
method=<method>)`` (``donate=False``: the loop re-feeds the same
planar block) on a ``rows x cols`` mesh, the median us of its forward
(CUDA events on the card; the slowest rank's on a mesh) and GFLOP/s at
``wse_model.fft_flops_3d(n)``. It prints the card's name and power
limit, then one CSV row, ``wsfft/fft3d_n<n>_<method>_<rows>x<cols>``.
The operand is complex n^3 from a seed, each rank making its own block
(``FFT.in_layout``) on its device.

    python3 benchmarks/torch_wsfft_worker.py 1 1 512 auto [--device cuda|cpu]
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 -- \\
        benchmarks/torch_wsfft_worker.py 2 2 512 auto

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_util as U  # noqa: E402

import repro_torch.fft as fft  # noqa: E402
from repro_torch.core import wse_model as wm  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('rows', type=int)
    ap.add_argument('cols', type=int)
    ap.add_argument('n', type=int)
    ap.add_argument('method', nargs='?', default='auto')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)
    U.need_device(args.device)
    n, method = args.n, args.method
    mesh = U.timing_mesh(f'{args.rows}x{args.cols}', args.device)
    p = fft.plan((n, n, n), mesh, method=method, donate=False)
    gen = torch.Generator(device=mesh.device).manual_seed(mesh.position)
    shape = tuple(p.local_shape(p.in_layout))
    re, im = (torch.randn(shape, generator=gen, device=mesh.device) for _ in range(2))
    us = U.slowest(U.time_us_synced(lambda: p.forward((re, im)), args.device))
    gf = wm.fft_flops_3d(n) / (us * 1e-6) / 1e9
    if mesh.position == 0:
        print(f"# torch_wsfft_worker: {U.card(args.device)}")
        U.emit(f"wsfft/fft3d_n{n}_{method}_{args.rows}x{args.cols}", us,
               f"gflops={gf:.2f} ({p.method}, {p.comm}, {p.overlap_chunks} chunks)")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
