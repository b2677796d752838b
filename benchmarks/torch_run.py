"""The port's benchmark runner: one section a paper table or figure, the
wsFFT rows, the card benchmarks, and the roofline summary of the dry-run
records where there are any.

Port of ``benchmarks/run.py``, section for section: the five
``torch_paper_*.py`` (the paper's model; fig3's part (b) times the
port's pencils on ``--device``); the wsFFT rows
(``torch_wsfft_worker.py`` on 1 x 1: n = 256 and 512 on the card, the
reference's 32 and 64 on the CPU, ``auto`` and at the larger n also
``stockham``); ``torch_bench_rfft.py``, ``torch_bench_fftconv.py``,
``torch_bench_serve_fft.py``, ``torch_bench_serve_service.py``,
``torch_bench_kernels.py``; and ``torch_roofline.py``. Each runs in a
subprocess; a script that fails prints ``<name>,nan,FAILED`` and the
end of its errors, and the runner exits non-zero. ``--smoke`` skips the
paper sections and the wsFFT rows and runs the benchmarks at their CI
sizes. Records go under the checkout's ``results/``. As ``run.py`` does
not, it does not run the swap benchmark, which needs four ranks
(``torch_bench_redistribute.py``, README).

    python3 benchmarks/torch_run.py [--smoke] [--device cuda|cpu]

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

PAPER = [('Paper Table 1 (cycle counts, model vs measured)', 'torch_paper_table1.py'),
         ('Paper Figure 3 (pencil throughput)', 'torch_paper_fig3.py'),
         ('Paper Figure 4 (comm/compute breakdown)', 'torch_paper_fig4.py'),
         ('Paper Figures 5/6/7 (weak/strong scaling, bandwidth)', 'torch_paper_fig567.py'),
         ('Paper Table 2 (cross-machine comparison)', 'torch_paper_table2.py')]


def _section(title: str) -> None:
    print(f"\n==== {title} " + "=" * max(0, 60 - len(title)), flush=True)


def _script(name: str, *args: str) -> bool:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))
    r = subprocess.run([sys.executable, os.path.join(HERE, name), *args],
                       capture_output=True, text=True, env=env)
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        sys.stdout.write(f"{os.path.splitext(name)[0]},nan,FAILED\n")
        sys.stderr.write(r.stderr[-2000:])
    sys.stdout.flush()
    return r.returncode == 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--smoke', action='store_true',
                    help='no paper sections; the benchmarks at their CI sizes')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)
    dev = ['--device', args.device]
    ok = True
    if not args.smoke:
        for title, name in PAPER:
            _section(title)
            ok &= _script(name, *(dev if name == 'torch_paper_fig3.py' else ()))
        _section('Distributed wsFFT on 1x1 (wall clock on the device)')
        sizes = (256, 512) if args.device == 'cuda' else (32, 64)
        for n, method in ((sizes[0], 'auto'), (sizes[1], 'auto'), (sizes[1], 'stockham')):
            ok &= _script('torch_wsfft_worker.py', '1', '1', str(n), method, *dev)
    size = ['--smoke'] if args.smoke else ['--n', '32']
    smoke = ['--smoke'] if args.smoke else []
    results = os.path.join(ROOT, 'results')
    _section('rfft vs complex plans (counted on the fake 4x4, timed on the device)')
    ok &= _script('torch_bench_rfft.py', *size, *dev,
                  '--out', os.path.join(results, 'bench_torch_rfft.json'))
    _section('FFT-conv operator plans: fused vs unfused (counted on the fake 4x4)')
    ok &= _script('torch_bench_fftconv.py', *smoke, *dev,
                  '--out', os.path.join(results, 'bench_torch_fftconv.json'))
    _section('FFT serving: sequential loop vs batched engine (1x1)')
    ok &= _script('torch_bench_serve_fft.py', *smoke, *dev,
                  '--out', os.path.join(results, 'bench_torch_serve_fft.json'))
    _section('FFT service: socket overhead + adaptive drainer policy')
    ok &= _script('torch_bench_serve_service.py', *smoke, *dev,
                  '--out', os.path.join(results, 'bench_torch_serve_service.json'))
    _section('Kernel tier: local methods + fused superstep A/B')
    ok &= _script('torch_bench_kernels.py', *smoke, *dev,
                  '--out', os.path.join(results, 'bench_torch_kernels.json'))
    records = os.path.join(results, 'dryrun_torch')
    if glob.glob(os.path.join(records, '*.json')):
        _section('Roofline summary (from the dry-run records)')
        ok &= _script('torch_roofline.py', '--dir', records,
                      '--out', os.path.join(results, 'roofline_torch_summary.csv'))
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
