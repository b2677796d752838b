"""The port's distributed FFT on 4 gloo CPU ranks (a 2 x 2 mesh, 16^3
and 16 x 32 with comm='all_to_all'; 64^3 planned by the selector or with
overlap_chunks=2; rank 1 at n = 4096, complex and real, planned by the
selector), run by ``_torch_multirank_worker.py`` in a subprocess.

Tolerances, each a max gap over all ranks divided by the largest
magnitude of its reference:
* against the port's single-process result: 0 (bitwise) for Stockham,
  whose pencils are independent of how they are batched, and for the
  block four-step, whose contractions are too; <= 1e-6 for the
  four-step, whose matmuls may block the batch differently;
* against np.fft.fftn and for the round trip: <= 1e-5 (three fp32 pencil
  passes);
* fp16 / bf16 wire against the native wire of the same plan, against
  np.fft.fftn and for the round trip: <= 1.5e-3 / 1.2e-2, the bounds of
  ``tests/_wire_accuracy_worker.py`` (11- and 8-bit significands, one
  cast per swap);
* a pipelined plan against the same plan with overlap_chunks=1, forward
  and inverse: 0 (bitwise), for every method and wire: chunking only
  regroups pencils whose arithmetic is independent of one another;
* a plan on another strategy against the same plan on all_to_all: 0
  (bitwise), the swaps being pure data movement.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from _torch_multirank_worker import (  # noqa: E402
    CASES, OVERLAP_CASES, RANK1_CASES, REAL_CASES, REAL_OVERLAP_CASES)

WIRE_BOUNDS = {'fp16': 1.5e-3, 'bf16': 1.2e-2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run_worker(out, *args) -> dict:
    """``_torch_multirank_worker.py`` on gloo CPU ranks with ``args``
    (``--mesh``, ``--suite``); its records by case name."""
    subprocess.run([sys.executable, os.path.join(HERE, '_torch_multirank_worker.py'),
                    str(out), str(_free_port()), *args], check=True, timeout=300)
    with open(out) as fh:
        return json.load(fh)


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp('multirank') / 'results.json')


@pytest.mark.parametrize("name, shape, kw", CASES, ids=[c[0] for c in CASES])
def test_multirank_case(results, name, shape, kw):
    r = results[name]
    assert r['shape_ok']
    wire = kw.get('wire_dtype', 'native')
    if wire != 'native':
        # the forward and the round trip (twice the casts) both hold
        for key in ('fwd_vs_native_wire', 'fwd_vs_numpy', 'roundtrip'):
            assert r[key] <= WIRE_BOUNDS[wire], key
        assert r['fwd_vs_native_wire'] > 0          # the cast did happen
        return
    assert r['fwd_vs_numpy'] <= 1e-5
    assert r['roundtrip'] <= 1e-5
    if kw['method'] in ('stockham', 'block'):
        assert r['fwd_vs_single'] == 0.0
    else:
        assert r['fwd_vs_single'] <= 1e-6


@pytest.mark.parametrize("name, shape, kw", REAL_CASES, ids=[c[0] for c in REAL_CASES])
def test_multirank_real_case(results, name, shape, kw):
    """rplan on the 2 x 2 mesh: each rank's block of the (padded or
    trimmed) half spectrum against the same bins of np.fft.rfftn and of
    the single-process spectrum, and the round trip. The reference
    cannot run the trimmed form on a multi-rank mesh, so numpy is the
    oracle there."""
    r = results[name]
    assert r['shape_ok']
    assert r['fwd_vs_numpy'] <= 1e-5
    assert r['roundtrip'] <= 1e-5
    if kw['method'] in ('stockham', 'block'):
        assert r['fwd_vs_single'] == 0.0
    else:
        assert r['fwd_vs_single'] <= 1e-6


#: the reference selector's pick at 64^3 on 2 x 2 (measured=None)
DEFAULT_PICK = {False: ['all_to_all', 8, 'four_step'], True: ['all_to_all', 1, 'auto']}


@pytest.mark.parametrize("name, shape, kw", OVERLAP_CASES + REAL_OVERLAP_CASES,
                         ids=[c[0] for c in OVERLAP_CASES + REAL_OVERLAP_CASES])
def test_multirank_overlap_case(results, name, shape, kw):
    """64^3 on the 2 x 2 mesh: a plan with no options resolves to the
    selector's pick and runs it; explicit overlap_chunks=2 for stockham,
    block, the real split-combine and an fp16 wire. Each pipelined plan
    is bitwise equal to its unchunked self, and to one process where the
    serial cases are (stockham, block)."""
    r = results[name]
    real = name.startswith('real_')
    assert r['shape_ok']
    assert r['resolved'] == (DEFAULT_PICK[real] if not kw
                             else ['all_to_all', 2, kw['method']])
    if r['resolved'][1] > 1:
        assert r['fwd_vs_unchunked'] == 0.0 and r['inv_vs_unchunked'] == 0.0
    wire = kw.get('wire_dtype', 'native')
    if wire != 'native':
        for key in ('fwd_vs_native_wire', 'fwd_vs_numpy', 'roundtrip'):
            assert r[key] <= WIRE_BOUNDS[wire], key
        assert r['fwd_vs_native_wire'] > 0
        return
    assert r['fwd_vs_numpy'] <= 1e-5
    assert r['roundtrip'] <= 1e-5
    if r['resolved'][2] in ('stockham', 'block'):
        assert r['fwd_vs_single'] == 0.0
    else:
        assert r['fwd_vs_single'] <= 1e-6


#: the reference's rank-1 picks at n = 4096 on 2 x 2 (``repro.fft.api.
#: _resolve_comm_1d``, no measured table): (strategy, chunks, method)
RANK1_PICKS = {
    'r1_default': ['hierarchical', 1, 'four_step'],
    'r1_stockham': ['hierarchical', 1, 'stockham'],
    'r1_overlap': ['hierarchical', 2, 'stockham'],
    'r1_fp16': ['all_to_all', 1, 'stockham'],
    'r1_real_default': ['hierarchical', 1, 'auto'],
    'r1_real_stockham': ['hierarchical', 1, 'stockham'],
}


@pytest.mark.parametrize("name, shape, kw", RANK1_CASES, ids=[c[0] for c in RANK1_CASES])
def test_multirank_rank1_case(results, name, shape, kw):
    """Rank-1 plans on the 2 x 2 mesh resolve to the reference's pick
    (the default one to ``hierarchical``) and run it: each rank's run of
    the signal (or, real, the whole spectrum on every rank) against
    np.fft.fft / rfft and the single-process result, bitwise where the
    method is Stockham; bitwise equal to the same plan on all_to_all and
    to its own unchunked self."""
    check_rank1(results[name], kw, RANK1_PICKS[name])


def check_rank1(r, kw, pick):
    assert r['shape_ok']
    assert r['resolved'] == pick
    if pick[0] != 'all_to_all':
        assert r['fwd_vs_all_to_all'] == 0.0 and r['inv_vs_all_to_all'] == 0.0
    if pick[1] > 1:
        assert r['fwd_vs_unchunked'] == 0.0 and r['inv_vs_unchunked'] == 0.0
    wire = kw.get('wire_dtype', 'native')
    if wire != 'native':
        for key in ('fwd_vs_native_wire', 'fwd_vs_numpy', 'roundtrip'):
            assert r[key] <= WIRE_BOUNDS[wire], key
        assert r['fwd_vs_native_wire'] > 0
        return
    assert r['fwd_vs_numpy'] <= 1e-5
    assert r['roundtrip'] <= 1e-5
    if pick[2] in ('stockham', 'block'):
        assert r['fwd_vs_single'] == 0.0
    else:
        assert r['fwd_vs_single'] <= 1e-6


def check_strategy_plan(r, kw, comm):
    """A plan of the strategies suite (``STRATEGY_PLANS``, Stockham) on
    ``comm``: bitwise equal to all_to_all's, to its unchunked self and to
    one process; within 1e-5 of numpy (a 16-bit wire within its bound)."""
    assert r['shape_ok']
    assert r['resolved'][:2] == [comm, kw.get('overlap_chunks', 1)]
    assert r['fwd_vs_all_to_all'] == 0.0 and r['inv_vs_all_to_all'] == 0.0
    if r['resolved'][1] > 1:
        assert r['fwd_vs_unchunked'] == 0.0 and r['inv_vs_unchunked'] == 0.0
    wire = kw.get('wire_dtype', 'native')
    if wire != 'native':
        for key in ('fwd_vs_native_wire', 'fwd_vs_numpy', 'roundtrip'):
            assert r[key] <= WIRE_BOUNDS[wire], key
        assert r['fwd_vs_native_wire'] > 0
        return
    assert r['fwd_vs_numpy'] <= 1e-5
    assert r['roundtrip'] <= 1e-5
    assert r['fwd_vs_single'] == 0.0
