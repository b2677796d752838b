"""Paper Figure 3: single-PE pencil FFT throughput (flops/cycle) for
n = 16..4096, FP16 and FP32, and the port's own pencils timed.

The counterpart of ``benchmarks/paper_fig3.py``:

(a) the paper's cycle model, flops/cycle on the CS-2, with the published
    asymptotes (5/3 FP16, 5/6.5 FP32) and measured endpoints (0.89 at
    4096 FP16, 0.57 at 2048 FP32), line for line the reference's, from
    ``repro_torch.core.wse_model``;
(b) the port's ``stockham`` and ``four_step`` pencils through
    ``repro_torch.fft.methods.apply`` on ``--batch`` pencils of n = 256,
    1024 and 4096 (planar fp32, from one seed): the median microseconds
    of a call (CUDA events on the card, the host clock with ``--device
    cpu``) and GFLOP/s at 5 n log2 n flops a pencil. On the card
    ``method='stockham'`` launches ``fft_pencil`` and ``'four_step'``
    ``fft_matmul``; the card's name and power limit head the lines.

At the default batch of 64 the card measures launch latency; ``--batch
32768`` fills it. Part (b) numbers are the port's on the device named,
not the CS-2's.

    python3 benchmarks/torch_paper_fig3.py [--batch 32768] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'src'))

from repro_torch.core import twiddle as tw, wse_model as wm  # noqa: E402
from repro_torch.fft import methods as fftm  # noqa: E402


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.3f},{derived}")


def time_us(fn, device: str, warmup: int = 2, iters: int = 5) -> float:
    """Median microseconds of one call: CUDA events around each call on
    the card, the host clock around each call and its synchronize on the
    CPU."""
    for _ in range(warmup):
        fn()
    if device == 'cuda':
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for a, b in events:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) * 1e3 for a, b in events)
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        times.sort()
    return times[len(times) // 2]


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card in use."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader', f'--id={torch.cuda.current_device()}'],
                          check=True, capture_output=True, text=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args()
    if args.device == 'cuda' and not torch.cuda.is_available():
        sys.exit("torch_paper_fig3: --device cuda needs an NVIDIA GPU (--device cpu runs "
                 "the plain versions)")

    print("# paper_fig3a: WSE model flops/cycle")
    print("n,fp16_flops_per_cycle,fp32_flops_per_cycle")
    for lg in range(4, 13):
        n = 1 << lg
        f16 = wm.pencil_flops_per_cycle(n, 'fp16')
        f32 = wm.pencil_flops_per_cycle(n, 'fp32')
        print(f"{n},{f16:.3f},{f32:.3f}")
    print(f"# asymptotes: fp16={wm.PAPER_PENCIL_ASYMPTOTE['fp16']:.3f} "
          f"fp32={wm.PAPER_PENCIL_ASYMPTOTE['fp32']:.3f}")
    n16, v16 = wm.PAPER_PENCIL_FLOPS_PER_CYCLE['fp16']
    n32, v32 = wm.PAPER_PENCIL_FLOPS_PER_CYCLE['fp32']
    print(f"# paper measured: fp16@{n16}={v16} (model "
          f"{wm.pencil_flops_per_cycle(n16, 'fp16'):.3f}), fp32@{n32}={v32} "
          f"(model {wm.pencil_flops_per_cycle(n32, 'fp32'):.3f})")

    where = card() if args.device == 'cuda' else 'the host CPU (plain versions)'
    print(f"# paper_fig3b: the port's pencils on {where}, batch {args.batch}")
    rng = np.random.default_rng(0)
    batch = args.batch
    for n in (256, 1024, 4096):
        x = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
        re, im = tw.to_planar(x, device=args.device)
        del x
        for meth in ('stockham', 'four_step'):
            us = time_us(lambda m=meth: fftm.apply(re, im, method=m), args.device)
            gf = batch * wm.fft_flops_1d(n) / (us * 1e-6) / 1e9
            emit(f"fig3/pencil_{meth}_n{n}", us, f"gflops={gf:.2f}")


if __name__ == "__main__":
    main()
