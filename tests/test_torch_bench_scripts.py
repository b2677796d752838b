"""The port's card benchmarks (``benchmarks/torch_bench_redistribute.py``,
``torch_bench_serve_fft.py``, ``torch_bench_serve_service.py``,
``torch_bench_kernels.py``) and ``torch_wsfft_worker.py``, each run on
the CPU at its CI size in a subprocess, records in ``tmp_path``: their
rows carry the reference scripts' keys, their checks hold, and what
they write is what ``comm/cost.py`` and ``FFTEngine`` read back. The
cost-model columns are held against the JAX package's
``wse_model`` / ``comm`` on the same arguments."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'src'))

from repro_torch.comm import cost  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402
from repro_torch.serve import FFTEngine  # noqa: E402

ENV = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
SCRIPTS = ('torch_bench_redistribute.py', 'torch_bench_serve_fft.py',
           'torch_bench_serve_service.py', 'torch_bench_kernels.py', 'torch_wsfft_worker.py')
CSV = re.compile(r'[\w/.*:-]+,(nan|[\d.]+),.*')


def _run(args, cwd, timeout=240, ok=True):
    """Run ``args`` under this Python from ``cwd`` (so a default
    ``results/`` lands there); nothing may appear at the repo root."""
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=ENV,
                          cwd=cwd, timeout=timeout)
    if ok:
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert not list(ROOT.glob('BENCH_torch_*.json')) and not (ROOT / 'BENCHMARK.json').exists()
    return proc


def _script(name):
    return str(ROOT / 'benchmarks' / name)


def _rows(path):
    with open(path) as fh:
        return json.load(fh)['results']


@pytest.mark.parametrize('name', SCRIPTS)
def test_cuda_without_a_card_exits(name, tmp_path):
    """``--device cuda`` (the default) on a machine with no card exits
    non-zero and prints no row: no silent fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: --device cuda runs')
    args = ['1', '1', '16'] if name == 'torch_wsfft_worker.py' else ['--smoke']
    proc = _run([_script(name), *args, '--device', 'cuda'], tmp_path, ok=False)
    assert proc.returncode != 0 and 'no CUDA device' in proc.stderr
    assert not any(CSV.fullmatch(ln) for ln in proc.stdout.splitlines())


def test_redistribute_smoke_on_four_gloo_ranks(tmp_path):
    """Four gloo ranks on 2 x 2: every swap bitwise all_to_all's (the
    script's own check), rows with the reference's keys, each answered
    by ``MeasuredTable.swap_us``, the model column the JAX package's."""
    from repro import comm as jcomm
    out = tmp_path / 'red.json'
    proc = _run(['-m', 'torch.distributed.run', '--standalone', '--nproc-per-node', '4', '--',
                 _script('torch_bench_redistribute.py'), '--smoke', '--device', 'cpu',
                 '--meshes', '2x2', '--out', str(out)], tmp_path)
    rows = _rows(out)
    assert {(r['strategy'], r['dtype']) for r in rows} == {
        (s, d) for s in ('all_to_all', 'pod_tree:x.2*y.2') for d in ('c64', 'f16')}
    table = cost.MeasuredTable(rows)
    for r in rows:
        assert {'mesh', 'group', 'strategy', 'p', 'local_elems', 'dtype', 'us',
                'model_cycles', 'card', 'backend'} <= set(r)
        assert (r['mesh'], r['group'], r['p'], r['local_elems'], r['backend']) == (
            '2x2', 'x*y', 4, 2048, 'cpu')
        assert table.swap_us(r['strategy'], {'x': 2, 'y': 2}, ('x', 'y'), r['local_elems'],
                             dtype=r['dtype']) == r['us'] > 0
        prec = 'fp16' if r['dtype'] == 'f16' else 'fp32'
        want = jcomm.get(r['strategy']).cost(('x', 'y'), {'x': 2, 'y': 2},
                                             r['local_elems'] / 2.0, prec).cycles
        assert r['model_cycles'] == pytest.approx(want, rel=1e-12)
        assert f"redistribute/2x2/x*y/{r['strategy']}/{r['dtype']}/e2048," in proc.stdout
    sel = json.loads(out.read_text())['selector']
    assert [s['mesh'] for s in sel] == ['2x2'] and proc.stdout.count('# selector 512^3') == 1


@pytest.mark.parametrize('fast', ('all_to_all', 'ppermute', 'hierarchical'))
def test_measured_table_drives_the_selector(fast):
    """A hand-built table in the script's schema in which ``fast`` swaps
    100x faster than the other strategies makes ``cost.select`` pick it."""
    rows = [dict(mesh='2x2', group=g, strategy=s, p=4 if g == 'x*y' else 2,
                 local_elems=e, dtype='c64', us=(1.0 if s == fast else 100.0) * e / 1024)
            for s in ('all_to_all', 'ppermute', 'hierarchical') for g in ('x', 'y', 'x*y')
            for e in (1024, 16384, 262144)]
    sel = cost.select((32,) * 3, ('x', 'y', None), {'x': 2, 'y': 2},
                      measured=cost.MeasuredTable(rows))
    assert sel.strategy == fast


def test_serve_fft_smoke_persists_its_schedules(tmp_path):
    """Every served result bitwise its per-request call; ``--refresh``
    persists ``autotune``'s (width, chunks), and a new engine on that
    table adopts them."""
    out, sched = tmp_path / 'serve.json', tmp_path / 'sched.json'
    proc = _run([_script('torch_bench_serve_fft.py'), '--smoke', '--refresh', '--device', 'cpu',
                 '--out', str(out), '--schedule-out', str(sched)], tmp_path)
    rows = _rows(out)
    assert all(r['bit_identical'] is True and r['backend'] == 'cpu' for r in rows)
    assert sorted((r['mode'], r['kind']) for r in rows) == [
        ('batch', 'complex'), ('batch', 'real'), ('drainer', 'mixed'),
        ('drainer', 'per_shape'), ('drainer', 'per_shape')]
    assert 'serve_fft/16/all_to_all/complex/engine,' in proc.stdout
    persisted = _rows(sched)
    assert len(persisted) == 2
    for r in (r for r in rows if r['mode'] == 'batch'):
        assert r['seq_us_per_req'] > 0 and r['engine_us_per_req'] > 0
        eng = FFTEngine((16, 16, 16), make_fft_mesh(1, 1, device='cpu'),
                        schedule_table=str(sched))
        real = r['kind'] == 'real'
        assert eng.schedule(real=real) == (r['coalesce_width'], r['overlap_chunks'])
        row = next(p for p in persisted if p['kind'] == r['kind'])
        assert (row['coalesce_width'], row['overlap_chunks'], row['mesh'], row['shape']) == (
            r['coalesce_width'], r['overlap_chunks'], '1x1', '16x16x16')
        eng.close()


def test_serve_service_smoke_has_every_cell(tmp_path):
    """The overhead row, every trace x policy cell and the summary."""
    out = tmp_path / 'svc.json'
    proc = _run([_script('torch_bench_serve_service.py'), '--smoke', '--device', 'cpu',
                 '--out', str(out)], tmp_path)
    rows = _rows(out)
    cells = {(r['trace'], r['config']) for r in rows if r['mode'] == 'policy'}
    assert cells == {(t, c) for t in ('steady_slow', 'steady_fast', 'bursty')
                     for c in ('fixed_w1_1ms', 'fixed_w4_5ms', 'fixed_w8_20ms', 'adaptive')}
    (over,) = [r for r in rows if r['mode'] == 'overhead']
    assert over['service_us_per_req'] > 0 and over['engine_us_per_req'] > 0
    assert over['overhead_ratio'] == pytest.approx(
        over['service_us_per_req'] / over['engine_us_per_req'], rel=1e-2)
    (summary,) = [r for r in rows if r['mode'] == 'summary']
    assert set(summary['adaptive_beats_all_fixed_on']) <= {t for t, _ in cells}
    for r in rows:
        if r['mode'] == 'policy':
            assert 0 < r['mean_ms'] <= r['p99_ms'] and r['shape'] == [8, 8, 8]
    assert 'serve_service/overhead/8x8x8,' in proc.stdout


def test_serve_service_chaos_delivers_exactly_once(tmp_path):
    """The degraded cell: faults fired, no request lost (the script
    asserts both), beside the clean run."""
    out = tmp_path / 'chaos.json'
    _run([_script('torch_bench_serve_service.py'), '--smoke', '--chaos', '--device', 'cpu',
          '--out', str(out)], tmp_path)
    rows = {r['config']: r for r in _rows(out)}
    assert rows['degraded']['faults_fired'] > 0 and rows['clean']['faults_fired'] == 0
    assert rows['degraded']['n_requests'] == rows['clean']['n_requests'] == 24


def test_kernels_smoke_rows(tmp_path):
    """The model rows are the JAX package's ``pencil_cycles_backend`` for
    every backend x tier; the local row's model column too; the kernel
    tier is skipped on the CPU with a line; the superstep counted on the
    fake 4 x 4 for both fused values."""
    from repro.core import wse_model as jwm
    out = tmp_path / 'kernels.json'
    proc = _run([_script('torch_bench_kernels.py'), '--smoke', '--device', 'cpu',
                 '--out', str(out)], tmp_path)
    rows = _rows(out)
    model = {(r['backend'], r['kernel']): r['model_cycles'] for r in rows
             if r['section'] == 'model'}
    assert model == {(b, t): jwm.pencil_cycles_backend(4096, 'fp32', 'stockham', backend=b,
                                                       kernel=t)
                     for b in jwm.BACKEND_COMPUTE for t in ('reference', 'pallas')}
    (local,) = [r for r in rows if r['section'] == 'local']
    assert (local['method'], local['kernel'], local['n'], local['b']) == (
        'stockham', 'reference', 128, 16)
    assert local['model_cycles'] == jwm.pencil_cycles_backend(128, 'fp32', 'stockham',
                                                              backend='cpu', kernel='reference')
    assert 'kernels/local/cpu/stockham/pallas/n128b16: skipped' in proc.stdout
    sup = {r['fused']: r for r in rows if r['section'] == 'superstep'}
    assert set(sup) == {True, False}
    assert sup[True]['kernels'] == {'fft_fused': {'radix8': 2}, 'fft_pencil': {'radix8': 1}}
    assert sup[False]['kernels'] == {'fft_pencil': {'radix8': 3}}
    for r in sup.values():
        assert r['launches'] == 3 and r['hlo_ops'] > 0 and r['us'] is None
        assert (r['counted_mesh'], r['counted_n'], r['kernel']) == ('4x4', 32, 'pallas')
    assert sup[True]['hbm_bytes_proxy'] == sup[False]['hbm_bytes_proxy'] > 0


def test_wsfft_worker_row(tmp_path):
    """One row, its GFLOP/s the JAX package's ``fft_flops_3d`` over its
    time."""
    from repro.core import wse_model as jwm
    proc = _run([_script('torch_wsfft_worker.py'), '1', '1', '16', 'auto', '--device', 'cpu'],
                tmp_path)
    (row,) = [ln for ln in proc.stdout.splitlines() if CSV.fullmatch(ln)]
    m = re.fullmatch(r'wsfft/fft3d_n16_auto_1x1,([\d.]+),gflops=([\d.]+) \(.*\)', row)
    assert m, row
    us, gf = float(m.group(1)), float(m.group(2))
    assert gf == pytest.approx(jwm.fft_flops_3d(16) / (us * 1e-6) / 1e9, abs=0.01)
