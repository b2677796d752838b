"""Run the port's mesh cases on four NVIDIA GPUs over NCCL.

Run from the root of a checkout, on a machine with four cards:

    python3 benchmarks/torch_multirank_cuda.py [--out build/multirank_cuda]
        [--suite base|strategies|pod|op|serve|lm ...] [--lm-rows ARCH:DTYPE[:LAYERS] ...]

It builds the CUDA kernels once, runs ``tests/_torch_multirank_worker.py``
with ``cuda`` (four NCCL ranks, one card each, so every pencil runs the
hand-written kernels on a mesh): the ``base`` suite on 2 x 2 (the
pencil, real, overlap and rank-1 cases), the ``strategies`` suite on
2 x 2 and 1 x 4 (every plan on ppermute, hierarchical and the mesh's pod
tree, held against all_to_all; the bare swaps), the ``pod`` suite on
1 x 2 x 2 pods (``batch_spec='pod'``), the ``op`` suite (``plan_op``)
on 2 x 2 and 1 x 4, and the ``serve`` suite on 2 x 2 at 512^3 (one
``FFTEngine`` a rank, 8 complex requests, ``flush()``: every result
bitwise equal to the rank's per-request ``plan.forward``, and the
slowest rank's time a request, the engine's beside the sequential
calls'). The ``lm`` suite runs ``tests/_torch_lm_multirank_worker.py``'s
``bench`` rows (the sharded LM server at published widths and depths,
64 new tokens after 8 prompts of 2048): qwen1.5-32b whole in fp32 and
dbrx-132b's 40 layers in bf16 on 1 x 4, dbrx-132b's first 16 layers in
fp32 on 2 prompts (its routing checked free), internlm2-1.8b in fp32 on
2 x 2 held against one card (``--lm-rows`` picks rows by name, as
``dbrx-132b:float32:16``); each row (``[lm4]``) is the slowest
rank's times and the largest peak, the bounds of ``chip_smoke.py``'s
``_lm_bounds`` over four cards, and its self-check against its own
sharded full forward at ``chip_smoke.py``'s limits. ``--suite`` runs
only the named suites (``lm`` runs only when named). Each case's record is
held to the checks of ``tests/test_torch_multirank.py`` (the same
functions, the same bounds: bitwise where they are bitwise). Printed:
the cards' names and power limits, one line per case, and a last line
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

import _torch_lm_multirank_worker as lm_worker  # noqa: E402
import _torch_multirank_worker as worker  # noqa: E402
import test_torch_multirank as checks  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

WORLD = 4
#: the serve suite's transform: 8 complex SERVE_N^3 requests
SERVE_N = 512


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'build', 'multirank_cuda'),
                    help='directory of the per-run JSON records')
    ap.add_argument('--suite', nargs='+', default=None,
                    choices=('base', 'strategies', 'pod', 'op', 'serve', 'lm'),
                    help='run only these suites')
    ap.add_argument('--lm-rows', nargs='+', default=None,
                    help='the lm suite: only these rows (arch:dtype[:layers])')
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        sys.exit(f"torch_multirank_cuda: needs {WORLD} CUDA devices")
    cards = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], check=True, capture_output=True,
                           text=True).stdout.strip().splitlines()
    for c in cards:
        print(f"[card] {c}", flush=True)
    if not args.suite or set(args.suite) - {'lm'}:
        _build.build()       # once, before the ranks start (the LM path runs no kernel)
    os.makedirs(args.out, exist_ok=True)
    passed = total = 0
    runs = (('2x2', 'base', 1), ('2x2', 'strategies', 1), ('1x4', 'strategies', 1),
            ('1x2', 'pod', 2), ('2x2', 'op', 1), ('1x4', 'op', 1), ('2x2', 'serve', 1))
    for mesh, suite, pods in runs:
        if args.suite and suite not in args.suite:
            continue
        out = os.path.join(args.out, f'{suite}_{mesh}.json')
        with socket.socket() as s:
            s.bind(('localhost', 0))
            port = s.getsockname()[1]
        extra = ['--serve-n', str(SERVE_N)] if suite == 'serve' else []
        subprocess.run([sys.executable, os.path.join(TESTS, '_torch_multirank_worker.py'),
                        out, str(port), 'cuda', '--mesh', mesh, '--suite', suite,
                        '--pods', str(pods), *extra], check=True, timeout=900)
        with open(out) as fh:
            results = json.load(fh)
        for name, check in _checks(mesh, suite):
            total += 1
            try:
                check(results[name])
            except AssertionError as e:
                print(f"[case] {mesh} {name} FAILED {e!r} {json.dumps(results[name])}",
                      flush=True)
                continue
            passed += 1
            print(f"[case] {mesh} {name} passed {json.dumps(results[name])}", flush=True)
    if args.suite and 'lm' in args.suite:
        for mesh, rows in lm_worker.BENCH_ROWS.items():
            if args.lm_rows and not {lm_worker.row_name(a, d, n) for a, d, _, n in rows} \
                    & set(args.lm_rows):
                continue
            total += 1
            passed += _lm_rows(args.out, mesh, args.lm_rows)
    print(f"[multirank] cuda: {passed} of {total} cases passed", flush=True)
    if passed != total:
        sys.exit(1)


def _lm_rows(out_dir: str, mesh: str, only=None) -> int:
    """The worker's ``bench`` rows on ``mesh`` (those ``only`` names,
    where given); 1 if every row held its checks (the worker raises where
    one does not), else 0."""
    out = os.path.join(out_dir, f'lm_{mesh}.json')
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    proc = subprocess.run([sys.executable, os.path.join(TESTS, '_torch_lm_multirank_worker.py'),
                           out, str(port), 'cuda', '--mesh', mesh, '--suite', 'bench',
                           *(['--rows', *only] if only else [])],
                          timeout=1500)
    if proc.returncode != 0:
        print(f"[case] {mesh} lm FAILED: the worker exited {proc.returncode}", flush=True)
        return 0
    with open(out) as fh:
        rows = json.load(fh)
    ok = all(r['self_check'] == 'ok' for r in rows)
    for r in rows:
        print(f"[case] {mesh} lm/{r['arch']} {'passed' if ok else 'FAILED'} {json.dumps(r)}",
              flush=True)
    return int(ok)


def _checks(mesh: str, suite: str):
    """(case name, check of its record) of one worker run."""
    if suite == 'pod':
        for name, _, _ in worker.POD_CASES:
            yield name, checks.check_pod
        return
    if suite == 'op':
        for name, _, _ in worker.OP_CASES[mesh]:
            yield name, checks.check_op
        return
    if suite == 'serve':
        yield f'serve_{SERVE_N}', check_serve
        return
    if suite == 'strategies':
        for comm in worker.strategies_for(mesh):
            for name, _, kw in worker.STRATEGY_PLANS:
                yield (f'{comm}/{name}',
                       lambda r, kw=kw, comm=comm: checks.check_strategy_plan(r, kw, comm))
            yield f'swap/{comm}', lambda r: _true(r)
        return
    groups = ((checks.test_multirank_case, checks.CASES),
              (checks.test_multirank_real_case, checks.REAL_CASES),
              (checks.test_multirank_overlap_case,
               checks.OVERLAP_CASES + checks.REAL_OVERLAP_CASES))
    for check, cases in groups:
        for name, shape, kw in cases:
            yield name, lambda r, c=check, n=name, s=shape, k=kw: c({n: r}, n, s, k)
    for name, _, kw in checks.RANK1_CASES:
        yield name, lambda r, n=name, k=kw: checks.check_rank1(r, k, checks.RANK1_PICKS[n])


def check_serve(r):
    """The timed serve suite: every coalesced result on every rank
    bitwise equal to its per-request call, groups of 4 (the model's pick
    under the cap) in 2 groups."""
    assert r['bitwise'] is True and r['shape_ok']
    (w, _), _, _, groups = r['resolved']
    assert w == 4 and groups == 2


def _true(r):
    assert r is True


if __name__ == '__main__':
    main()
