"""Run the port's mesh cases on four NVIDIA GPUs over NCCL.

Run from the root of a checkout, on a machine with four cards:

    python3 benchmarks/torch_multirank_cuda.py [--out build/multirank_cuda]
        [--suite base|strategies|pod|op|unfused|serve|lm|train ...]
        [--lm-rows ARCH:DTYPE[:LAYERS] ...] [--lm-meshes 1x4 2x2 1x3]

It builds the CUDA kernels once, runs ``tests/_torch_multirank_worker.py``
with ``cuda`` (four NCCL ranks, one card each, so every pencil runs the
hand-written kernels on a mesh): the ``base`` suite on 2 x 2 (the
pencil, real, overlap and rank-1 cases), the ``strategies`` suite on
2 x 2 and 1 x 4 (every plan on ppermute, hierarchical and the mesh's pod
tree, held against all_to_all; the bare swaps), the ``pod`` suite on
1 x 2 x 2 pods (``batch_spec='pod'``), the ``op`` suite (``plan_op``)
on 2 x 2 and 1 x 4, the ``unfused`` suite (``fused=False`` rank-3 and
rank-1 functions against their fused selves) on 2 x 2 and 1 x 4, and
the ``serve`` suite on 2 x 2 and 1 x 4 at 512^3:
one ``FFTEngine`` a rank, 8 complex requests through ``flush()`` and
through a background engine with no ``flush()`` (position 0's drainer
leading), every result bitwise equal to the rank's per-request
``plan.forward``, each group's ``fft_matmul`` launches those of one call
of the plan on it, all on the tensor-core body, and the slowest rank's
time a request beside the sequential calls'; then
``tests/_torch_serve_mesh_worker.py``'s cases on 2 x 2 (the drainer and
the service at small shapes, on NCCL) and its ``bench`` on 2 x 2 and
1 x 4 (``[serve4]``: ``FFTService`` at the client, real 512^3 requests
from two tenants over a unix socket on position 0, the host split with
the scatter and the gather, each card's peak; 3 ``fft_matmul`` a group on
every rank; every result bitwise equal to the ranks' per-request calls
and to a one-card service's frame). The ``lm`` suite runs ``tests/_torch_lm_multirank_worker.py``'s
``bench`` rows (the sharded LM server at published widths and depths,
64 new tokens after 8 prompts of 2048): qwen1.5-32b whole in fp32 and
dbrx-132b's 40 layers in bf16 on 1 x 4, dbrx-132b's first 16 layers in
fp32 on 2 prompts (its routing checked free), internlm2-1.8b in fp32 on
2 x 2 held against one card, and on 1 x 3 (three of the cards, which
divide no head count: each rank its head range) internlm2-1.8b in fp32
held against one card and qwen1.5-32b whole in bf16 on 2 prompts
(``--lm-rows`` picks rows by name, as ``dbrx-132b:float32:16``;
``--lm-meshes 1x3`` the meshes); each row (``[lm4]``) is the slowest
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
import _torch_serve_mesh_worker as mesh_worker  # noqa: E402
import test_torch_multirank as checks  # noqa: E402
import test_torch_serve_mesh as serve_checks  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

WORLD = 4
#: the serve suite's transform: 8 complex SERVE_N^3 requests
SERVE_N = 512


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'build', 'multirank_cuda'),
                    help='directory of the per-run JSON records')
    ap.add_argument('--suite', nargs='+', default=None,
                    choices=('base', 'strategies', 'pod', 'op', 'unfused', 'serve', 'lm',
                             'train'),
                    help='run only these suites')
    ap.add_argument('--lm-rows', nargs='+', default=None,
                    help='the lm suite: only these rows (arch:dtype[:layers])')
    ap.add_argument('--lm-meshes', nargs='+', default=None,
                    choices=tuple(lm_worker.BENCH_ROWS),
                    help='the lm suite: only the rows of these meshes')
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        sys.exit(f"torch_multirank_cuda: needs {WORLD} CUDA devices")
    cards = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], check=True, capture_output=True,
                           text=True).stdout.strip().splitlines()
    for c in cards:
        print(f"[card] {c}", flush=True)
    if not args.suite or set(args.suite) - {'lm'}:
        _build.build()       # once, before the ranks start (the LM server runs no kernel)
    os.makedirs(args.out, exist_ok=True)
    passed = total = 0
    runs = (('2x2', 'base', 1), ('2x2', 'strategies', 1), ('1x4', 'strategies', 1),
            ('1x2', 'pod', 2), ('2x2', 'op', 1), ('1x4', 'op', 1), ('2x2', 'unfused', 1),
            ('1x4', 'unfused', 1), ('2x2', 'serve', 1), ('1x4', 'serve', 1))
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
    if not args.suite or 'serve' in args.suite:
        ok, n = _serve_mesh_rows(args.out)
        passed, total = passed + ok, total + n
    if args.suite and 'lm' in args.suite:
        for mesh, rows in lm_worker.BENCH_ROWS.items():
            if args.lm_rows and not {lm_worker.row_name(a, d, n) for a, d, _, n in rows} \
                    & set(args.lm_rows):
                continue
            if args.lm_meshes and mesh not in args.lm_meshes:
                continue
            total += 1
            passed += _lm_rows(args.out, mesh, args.lm_rows)
    if args.suite and 'train' in args.suite:
        ok, n = _train_rows(args.out)
        passed, total = passed + ok, total + n
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


#: recurrentgemma-9b's 2 x 2 run against its 1 x 4 run: each step's loss
#: and grad norm, relative
TRAIN_MESH_REL = 1e-5


def _train_rows(out_dir: str) -> tuple:
    """The worker's ``trainbench`` rows on 2 x 2, then 1 x 4: (cases
    passed, cases). A mesh's run is a case (the worker raises where a row
    misses its checks), and so is recurrentgemma-9b's 2 x 2 run against
    its 1 x 4 run."""
    rows, passed = {}, 0
    for mesh in lm_worker.TRAIN_BENCH_ROWS:
        out = os.path.join(out_dir, f'train_{mesh}.json')
        with socket.socket() as s:
            s.bind(('localhost', 0))
            port = s.getsockname()[1]
        proc = subprocess.run([sys.executable,
                               os.path.join(TESTS, '_torch_lm_multirank_worker.py'), out,
                               str(port), 'cuda', '--mesh', mesh, '--suite', 'trainbench'],
                              timeout=1500)
        if proc.returncode != 0:
            print(f"[case] {mesh} train FAILED: the worker exited {proc.returncode}",
                  flush=True)
            continue
        with open(out) as fh:
            rows[mesh] = {r['arch']: r for r in json.load(fh)}
        passed += 1
        for r in rows[mesh].values():
            print(f"[case] {mesh} train/{r['arch']} passed {json.dumps(r)}", flush=True)
    try:
        a, b = rows['2x2']['recurrentgemma-9b'], rows['1x4']['recurrentgemma-9b']
        gaps = {k: max(abs(x - y) / abs(y) for x, y in zip(a[k], b[k]))
                for k in ('loss', 'grad_norm')}
        ok = all(v <= TRAIN_MESH_REL for v in gaps.values())
    except KeyError:
        gaps, ok = 'a mesh did not run', False
    print(f"[case] train/recurrentgemma-9b 2x2_vs_1x4 {'passed' if ok else 'FAILED'} "
          f"{json.dumps(gaps)} tol={TRAIN_MESH_REL}", flush=True)
    return passed + int(ok), len(lm_worker.TRAIN_BENCH_ROWS) + 1


#: tests/_torch_serve_mesh_worker.py's runs: (mesh, --cases)
SERVE_MESH_RUNS = (('2x2', 'all'), ('2x2', 'bench'), ('1x4', 'bench'))


def _serve_mesh_rows(out_dir: str) -> tuple:
    """The serving worker's runs on NCCL: (cases passed, cases). Each
    case of the 2 x 2 'all' run is held to its test's checks; each bench
    to :func:`check_service_bench`."""
    passed = total = 0
    for mesh, cases in SERVE_MESH_RUNS:
        out = os.path.join(out_dir, f'serve_mesh_{cases}_{mesh}.json')
        with socket.socket() as s:
            s.bind(('localhost', 0))
            port = s.getsockname()[1]
        proc = subprocess.run([sys.executable, os.path.join(TESTS, '_torch_serve_mesh_worker.py'),
                               out, str(port), 'cuda', '--mesh', mesh, '--cases', cases],
                              timeout=1200)
        named = _serve_mesh_checks(cases)
        if proc.returncode != 0:
            total += len(named)
            print(f"[case] {mesh} serve_mesh/{cases} FAILED: the worker exited "
                  f"{proc.returncode}", flush=True)
            continue
        with open(out) as fh:
            rec = json.load(fh)
        for name, check in named:
            total += 1
            try:
                check(rec)
            except AssertionError as e:
                print(f"[case] {mesh} serve_mesh/{name} FAILED {e!r}", flush=True)
                continue
            passed += 1
            print(f"[case] {mesh} serve_mesh/{name} passed", flush=True)
        if cases == 'bench':
            print(f"[serve4] mesh={mesh} {json.dumps(rec['bench'])}", flush=True)
    return passed, total


def _serve_mesh_checks(cases: str):
    """(name, check of the worker's record) of one serving worker run."""
    if cases == 'bench':
        return [('bench', lambda rec: check_service_bench(rec['bench']))]
    runs = lambda rec: {'2x2': (rec, None)}  # noqa: E731
    c = serve_checks
    return [('stream', lambda r: c.test_drainer_stream_is_bitwise_per_request(runs(r), '2x2')),
            ('groups', lambda r: c.test_drainer_groups_pair_on_every_rank(runs(r), '2x2')),
            ('deadline', c.test_deadline_only_load_dispatches),
            ('watermark', c.test_watermark_only_load_dispatches),
            ('fault', c.test_dispatch_fault_is_retried_on_every_rank),
            ('persistent_fault', c.test_persistent_dispatch_fault_surfaces_on_every_rank),
            ('stall', c.test_drainer_stall_delays_but_serves),
            ('multi_tenant', c.test_service_multi_tenant_bit_identity),
            ('quota', c.test_service_quota_isolation),
            ('slo', c.test_service_slo_ordering),
            ('one_rank_bytes', c.test_service_bytes_equal_the_one_rank_service),
            ('close', c.test_close_drain_ends_every_process)]


def check_service_bench(r):
    """The timed service: every request served to its tenant, none
    rejected; on every rank 3 fft_matmul launches a group, all on the
    tensor-core body, the groups in one order; every result bitwise equal
    to the ranks' per-request calls and, where the method is the same, to
    the one-card service's frame."""
    lead = r[0]
    assert not lead['errors'] and lead['rejected'] == 0, lead['errors']
    # the stream and three requests one at a time
    assert sum(lead['tenants'].values()) == mesh_worker.BENCH_REQUESTS + 3, lead['tenants']
    assert all(x['launches_ok'] is True and x['bitwise'] is True for x in r)
    assert len({x['digest'] for x in r}) == 1 and len({x['groups'] for x in r}) == 1
    if lead['one_card_method'] == lead['method']:
        assert lead['one_card_bytes'] is True, lead.get('one_card_max_abs')


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
    if suite == 'unfused':
        for name, _, kw in worker.UNFUSED_CASES[mesh]:
            yield name, lambda r, k=kw: checks.check_unfused(r, k)
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
    bitwise equal to its per-request call, through flush() and through
    the drainer, groups of 4 (the model's pick under the cap) in 2
    groups, each launching what one call of the plan on it launches, all
    on the tensor-core body, in one order on every rank."""
    assert r['bitwise'] is True and r['shape_ok']
    assert r['drainer_bitwise'] is True and r['drainer_paired'] is True
    assert r['launches_ok'] is True
    (w, _), _, _, groups, (dw, _), dgroups, _ = r['resolved']
    assert w == 4 and groups == 2 and dw == 4 and dgroups == 2


def _true(r):
    assert r is True


if __name__ == '__main__':
    main()
