"""The port's benchmark runner: one section a paper table or figure, the
rfft and FFT-conv benchmarks, and the roofline summary of the dry-run
records where there are any.

Port of ``benchmarks/run.py`` for the scripts that exist: the five
``torch_paper_*.py`` (the paper's model; fig3's part (b) times the
port's pencils on ``--device``), ``torch_bench_rfft.py``,
``torch_bench_fftconv.py`` and ``torch_roofline.py``. Each runs in a
subprocess; a script that fails prints ``<name>,nan,FAILED`` and the
end of its errors, and the runner exits non-zero. ``--smoke`` skips the
paper sections and runs the two benchmarks at their CI sizes. Records
go under the checkout's ``results/``.

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
    size = ['--smoke'] if args.smoke else ['--n', '32']
    results = os.path.join(ROOT, 'results')
    _section('rfft vs complex plans (counted on the fake 4x4, timed on the device)')
    ok &= _script('torch_bench_rfft.py', *size, *dev,
                  '--out', os.path.join(results, 'bench_torch_rfft.json'))
    _section('FFT-conv operator plans: fused vs unfused (counted on the fake 4x4)')
    ok &= _script('torch_bench_fftconv.py', *(['--smoke'] if args.smoke else []), *dev,
                  '--out', os.path.join(results, 'bench_torch_fftconv.json'))
    records = os.path.join(results, 'dryrun_torch')
    if glob.glob(os.path.join(records, '*.json')):
        _section('Roofline summary (from the dry-run records)')
        ok &= _script('torch_roofline.py', '--dir', records,
                      '--out', os.path.join(results, 'roofline_torch_summary.csv'))
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
