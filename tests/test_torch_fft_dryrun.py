"""The FFT's dry run with no card: the hand-written kernels on ``meta``,
their launches counted by ``launch.hlostats``, the paper's 512^3 cell
(``benchmarks/torch_roofline_fft.py``), the summary
(``benchmarks/torch_roofline.py``) and the two benchmarks that count
(``benchmarks/torch_bench_rfft.py``, ``torch_bench_fftconv.py``).

* each kernel wrapper on ``meta`` runs the card's checks, returns the
  card's shapes, launches nothing (the modules' ``launches`` stay) and
  is counted once by ``hlostats.count()`` with the body the card runs at
  that n, 8 bytes an element read and 8 written (twiddle planes read
  too), and 5 n log2 n flops a pencil; ``resolve_kernel('auto')`` on
  ``meta`` picks the card's tier; a CPU tensor still runs the plain
  version, which reports no launch; with no count open the hook list is
  empty;
* ``torch_roofline_fft.py --n 64 --mesh 4x4`` (a subprocess on the fake
  group of 16): 6 ``fft_matmul`` launches on the tensor-core body, four
  swaps, and wire bytes by hand: each swap moves (g - 1)/g of the rank's
  64^3 * 8 / 16 bytes within its group of g = 4; ``analyze`` and the
  roofline's terms carry the kernels' bytes and flops;
* the script's default sweep writes the reference's four records
  (256 and 512 with ``auto``, 512 ``stockham`` tagged ``faithful``, 512
  on 2 x 16 x 16), each counting the card's kernels (``mma`` or
  ``radix8`` bodies), the 512^3 cell collective-bound with the hand
  count over InfiniBand: four swaps of 15/16 of 4 MiB at 50 GB/s;
* ``torch_roofline.py`` writes the reference's ``COLS`` from records in
  a temporary directory, its LM rows equal to the reference
  ``benchmarks/roofline.py``'s ``rows`` of the same records;
* both benchmarks pass ``--smoke --device cpu`` with their claims
  asserted on the counted 4 x 4.
"""
import csv
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import kernels
from repro_torch.fft import methods
from repro_torch.kernels import fft_block, fft_fused, fft_matmul, fft_pencil
from repro_torch.launch import dryrun, hlostats

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = os.path.join(ROOT, 'benchmarks')
sys.path.insert(0, BENCH)

import torch_roofline  # noqa: E402

ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))


def _planes(shape, device='meta'):
    return tuple(torch.zeros(shape, device=device) for _ in range(2))


#: (kernel module, call on planar meta operands of (8, n) -> output planes, n)
CASES = [('fft_matmul', lambda r, i: fft_matmul.fft_matmul(r, i), 512),
         ('fft_matmul', lambda r, i: fft_matmul.fft_matmul(r, i, inverse=True), 32),
         ('fft_pencil', lambda r, i: fft_pencil.fft_pencil(r, i), 512),
         ('fft_pencil', lambda r, i: fft_pencil.fft_pencil(r, i), 8192),
         ('fft_fused', lambda r, i: fft_fused.fft_twiddle_transpose(r, i), 512),
         ('fft_block', lambda r, i: tuple(fft_block.fft_block(torch.stack([r, i]))), 2048),
         ('fft_block', lambda r, i: fft_block.fft_block_planar(r, i), 16)]


@pytest.mark.parametrize('name,call,n', CASES, ids=[f'{c[0]}-{c[2]}' for c in CASES])
def test_a_kernel_on_meta_is_counted_once(name, call, n):
    mod = {'fft_matmul': fft_matmul, 'fft_pencil': fft_pencil, 'fft_fused': fft_fused,
           'fft_block': fft_block}[name]
    before = mod.launches
    re, im = _planes((8, n))
    with hlostats.count() as st:
        yr, yi = call(re, im)
    want = (n, 8) if name == 'fft_fused' else (8, n)
    assert tuple(yr.shape) == tuple(yi.shape) == want and yr.device.type == 'meta'
    assert mod.launches == before                       # nothing launched
    k = st.analyze()['kernels']
    assert list(k) == [name]
    assert k[name] == {'launches': 1, 'launches_by_body': {mod.variant(n): 1},
                       'bytes_read': 8 * 8 * n, 'bytes_written': 8 * 8 * n,
                       'flops': 5.0 * 8 * n * math.log2(n)}
    assert st.analyze()['kernel_flops'] == k[name]['flops']


def test_twiddle_planes_are_read_and_the_hook_is_free():
    re, im = _planes((2, 4, 64))
    wr, wi = _planes((4, 64))
    with hlostats.count() as st:
        fft_fused.fft_twiddle_transpose(re, im, wr, wi)
    k = st.analyze()['kernels']['fft_fused']
    assert k['bytes_read'] == 8 * 2 * 4 * 64 + 2 * 4 * (4 * 64)   # one (b, n) plane, each
    assert kernels.HOOKS == []                      # no count open: one list check a launch


def test_meta_runs_the_card_checks_and_tier():
    re, im = _planes((8, 512))
    with pytest.raises(ValueError, match='runs the split'):
        fft_matmul.fft_matmul(re, im, factors=(16, 32))
    st = methods.get('stockham')
    assert methods.resolve_kernel('auto', st, 'meta') == 'pallas'
    assert methods.resolve_kernel('pallas', st, 'meta') == 'pallas'
    assert methods.resolve_kernel('auto', st, 'cpu') == 'reference'
    cr, ci = _planes((8, 64), 'cpu')
    with hlostats.count() as c:
        fft_matmul.fft_matmul(cr, ci)
    assert c.analyze()['kernels'] == {}             # the plain version launches nothing


def test_roofline_terms_add_the_kernels():
    stats = {'dot_flops_by_dtype': {}, 'kernel_flops': 67e12 * 0.5, 'hbm_bytes_proxy': 0.0,
             'collective_wire_by_link': {}}
    assert dryrun.roofline_terms(stats)['compute_s'] == pytest.approx(0.5)


def _run(*args, timeout=300):
    r = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=ENV,
                       timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope='module')
def fft_records(tmp_path_factory):
    """The n = 64 record on the fake 4 x 4 and the default sweep's four."""
    out = tmp_path_factory.mktemp('fft_dryrun')
    script = os.path.join(BENCH, 'torch_roofline_fft.py')
    log = _run(script, '--n', '64', '--mesh', '4x4', '--out', str(out))
    log += _run(script, '--out', str(out))
    recs = {}
    for name in os.listdir(out):
        with open(out / name) as fh:
            recs[name] = json.load(fh)
    return out, recs, log


def test_the_64_cube_on_4x4_is_the_hand_count(fft_records):
    _, recs, log = fft_records
    rec = recs['pod_4x4__wsfft__64__auto.json']
    assert '[fft-roofline] n=64 pods=1 method=auto' in log
    assert rec['n_chips'] == 16 and rec['status'] == 'ok'
    assert rec['kernels'] == {'fft_matmul': {
        'launches': 6, 'launches_by_body': {'mma': 6}, 'bytes_read': 6 * 8 * 64 ** 3 // 16,
        'bytes_written': 6 * 8 * 64 ** 3 // 16, 'flops': 6 * 5.0 * 64 ** 3 / 16 * 6}}
    hlo = rec['hlo']
    block, g = 64 ** 3 * 8 // 16, 4
    assert hlo['collective_wire_total'] == 4 * block * (g - 1) / g       # four swaps
    kinds = hlo['collective_counts']
    if rec['comm'] == 'all_to_all':
        assert kinds == {'all-to-all': 4 * 2}                       # a swap: both planes
    else:
        assert rec['comm'] == 'ppermute' and kinds == {'collective-permute': 4 * (g - 1) * 2}
    assert hlo['kernel_flops'] == rec['kernels']['fft_matmul']['flops']
    assert hlo['hbm_bytes_proxy'] >= 2 * rec['kernels']['fft_matmul']['bytes_read']
    assert rec['roofline']['compute_s'] == pytest.approx(hlo['kernel_flops'] / 67e12)
    assert 'cost_flops' not in rec and 'compile_s' not in rec


def test_the_default_sweep_counts_the_card_kernels(fft_records):
    _, recs, _ = fft_records
    names = {'pod_16x16__wsfft__256__auto.json', 'pod_16x16__wsfft__512__auto.json',
             'pod_16x16__wsfft__512__stockham__faithful.json',
             'multipod_2x16x16__wsfft__512__auto.json'}
    assert names <= set(recs)
    for name in names:
        rec = recs[name]
        bodies = {b for k in rec['kernels'].values() for b in k['launches_by_body']}
        assert bodies <= {'mma', 'radix8'} and rec['kernels'], name
        assert sum(k['launches'] for k in rec['kernels'].values()) == 6, name
        assert rec['hlo']['dot_flops'] == 0, name        # no plain products
    cell = recs['pod_16x16__wsfft__512__auto.json']
    assert set(cell['kernels']) == {'fft_matmul'}
    assert set(recs['pod_16x16__wsfft__512__stockham__faithful.json']['kernels']) == {
        'fft_pencil', 'fft_fused'}
    block = 512 ** 3 * 8 // 256                          # 4 MiB a card
    assert cell['hlo']['collective_wire_total'] == 4 * block * 15 / 16
    roof = cell['roofline']
    assert roof['dominant'] == 'collective_s'
    assert roof['collective_s'] == pytest.approx(4 * block * 15 / 16 / dryrun.IB_BW)
    assert cell['transpose_bytes_min'] == 4 * 512 ** 3 * 8 / 256
    assert recs['multipod_2x16x16__wsfft__512__auto.json']['n_chips'] == 512


def test_the_summary_writes_the_reference_columns(fft_records, tmp_path):
    out, recs, _ = fft_records
    sys.path.insert(0, ROOT)
    from benchmarks import roofline as ref
    lm = {'arch': 'qwen1.5-32b', 'shape': 'decode_32k', 'mesh': 'pod_16x16', 'status': 'ok',
          'kind': 'decode', 'model_flops': 9e12, 'useful_flop_ratio': 0.7,
          'roofline_fraction': 1e-4, 'memory': {'temp_size_in_bytes': 2e9},
          'roofline': {'dominant': 'collective_s', 'compute_s': 2.9e-4, 'memory_s': 0.078,
                       'collective_s': 0.25, 'bound_s': 0.25},
          'heads': {'rank0': {'q_heads': 3}, 'most': {'q_heads': 3}}}
    skipped = {'arch': 'hubert-xlarge', 'shape': 'decode_32k', 'mesh': 'multipod_2x16x16',
               'status': 'skipped', 'skip_reason': 'encoder-only'}
    for name, rec in [('a.json', lm), ('b.json', skipped),
                      ('c.json', recs['pod_16x16__wsfft__512__auto.json'])]:
        with open(tmp_path / name, 'w') as fh:
            json.dump(rec, fh)
    csv_path = tmp_path / 'summary.csv'
    log = _run(os.path.join(BENCH, 'torch_roofline.py'), '--dir', str(tmp_path),
               '--out', str(csv_path))
    assert '3 cells: 2 ok, 1 skipped, 0 failed' in log
    with open(csv_path) as fh:
        rows = list(csv.reader(fh))
    assert tuple(rows[0]) == ref.COLS == torch_roofline.COLS
    assert torch_roofline.rows(str(tmp_path)) == ref.rows(str(tmp_path))
    assert [r[1] for r in rows[1:]] == ['qwen1.5-32b', 'hubert-xlarge', 'wsfft-512cubed']


@pytest.mark.parametrize('script', ['torch_bench_rfft.py', 'torch_bench_fftconv.py'])
def test_the_benchmarks_count_on_the_fake_4x4(script, tmp_path):
    out = tmp_path / 'rec.json'
    log = _run(os.path.join(BENCH, script), '--smoke', '--device', 'cpu', '--out', str(out))
    with open(out) as fh:
        rows = json.load(fh)['results']
    assert len(rows) == 3 and all(r['counted_mesh'] == '4x4' for r in rows)
    by = {r['kind']: r for r in rows}
    if script == 'torch_bench_rfft.py':
        assert by['real']['wire_bytes'] < by['complex']['wire_bytes']
        assert '#   all_to_all/real: wire' in log
    else:
        assert 'claims held' in log
        for kind in ('fused', 'fused_baked'):
            assert by[kind]['wire_bytes'] <= by['unfused']['wire_bytes']
            assert by[kind]['dispatches'] < by['unfused']['dispatches']
    for r in rows:
        assert r['launches'] > 0 and r['us'] > 0
        assert set(b for k in r['kernels'].values() for b in k) <= {'mma', 'radix8'}
