"""Run the port's 2 x 2 mesh cases on four NVIDIA GPUs over NCCL.

Run from the root of a checkout, on a machine with four cards:

    python3 benchmarks/torch_multirank_cuda.py [--out build/multirank_cuda.json]

It builds the CUDA kernels once, runs ``tests/_torch_multirank_worker.py``
with ``cuda`` (four NCCL ranks, one card each, so every pencil runs the
hand-written kernels on a mesh), and holds each case's record to the
checks of ``tests/test_torch_multirank.py`` (the same functions, the
same bounds: bitwise where they are bitwise). Printed: the cards' names
and power limits, one line per case, and a last line
``[multirank] cuda: P of N cases passed``. It exits non-zero if a case
fails, and imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, 'tests')
sys.path.insert(0, os.path.join(ROOT, 'src'))
sys.path.insert(0, TESTS)

import test_torch_multirank as checks  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

WORLD = 4


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'build', 'multirank_cuda.json'))
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        sys.exit(f"torch_multirank_cuda: needs {WORLD} CUDA devices")
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
    subprocess.run([sys.executable, os.path.join(TESTS, '_torch_multirank_worker.py'),
                    args.out, str(port), 'cuda'], check=True, timeout=900)
    with open(args.out) as fh:
        results = json.load(fh)
    groups = ((checks.test_multirank_case, checks.CASES),
              (checks.test_multirank_real_case, checks.REAL_CASES),
              (checks.test_multirank_overlap_case,
               checks.OVERLAP_CASES + checks.REAL_OVERLAP_CASES))
    passed = total = 0
    for check, cases in groups:
        for name, shape, kw in cases:
            total += 1
            try:
                check(results, name, shape, kw)
            except AssertionError as e:
                print(f"[case] {name} FAILED {e!r} {json.dumps(results[name])}", flush=True)
                continue
            passed += 1
            print(f"[case] {name} passed {json.dumps(results[name])}", flush=True)
    print(f"[multirank] cuda: {passed} of {total} cases passed", flush=True)
    if passed != total:
        sys.exit(1)


if __name__ == '__main__':
    main()
