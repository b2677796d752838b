"""The port's distributed FFT on 4 gloo CPU ranks (a 2 x 2 mesh, 16^3
and 16 x 32, comm='all_to_all'), run by ``_torch_multirank_worker.py``
in a subprocess.

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
  cast per swap).
"""
import json
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from _torch_multirank_worker import CASES, REAL_CASES  # noqa: E402

WIRE_BOUNDS = {'fp16': 1.5e-3, 'bf16': 1.2e-2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp('multirank') / 'results.json'
    subprocess.run([sys.executable, os.path.join(HERE, '_torch_multirank_worker.py'),
                    str(out), str(_free_port())], check=True, timeout=300)
    with open(out) as fh:
        return json.load(fh)


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
