"""The port's FFT serving on a mesh of gloo CPU ranks: the multi-rank
drainer (position 0 decides every pass for all the ranks' engines) and
``FFTService`` on a mesh (position 0 holds the sockets and scatters and
gathers the ranks' blocks).

``tests/_torch_serve_mesh_worker.py`` runs the cases of the reference's
``tests/_serve_drainer_worker.py`` and ``tests/_serve_service_worker.py``
(16 fake devices, one process) on 2 x 2, and its stream case on 1 x 4,
each once, in a subprocess. The served results, put together into
global arrays, are held within ``RTOL`` relative L2 of the JAX package's
plans on a 2 x 2 Auto-axes mesh (``tests/_torch_serve_mesh_reference.py``,
four fake host devices, in a subprocess beside the workers): fp32
pencils, and XLA contracts products into FMAs where eager PyTorch does
not. Against the port's own per-request calls and a one-rank service's
result frames they are held bitwise: serving only queues, coalesces,
cuts and carries requests. The launcher's ``--smoke`` and
``examples/torch_serve_fft.py`` run under ``torch.distributed.run``.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RTOL = 1e-5
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _worker(tmp, mesh, cases):
    out, npz = tmp / f'{mesh}.json', tmp / f'{mesh}.npz'
    subprocess.run([sys.executable, os.path.join(HERE, '_torch_serve_mesh_worker.py'),
                    str(out), str(_free_port()), '--mesh', mesh, '--cases', cases,
                    '--npz', str(npz)], check=True, timeout=TIMEOUT)
    with open(out) as fh:
        return json.load(fh), dict(np.load(npz))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The worker on 2 x 2 (every case) and on 1 x 4 (the stream), with
    the JAX package's results made beside them."""
    tmp = tmp_path_factory.mktemp('serve_mesh')
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, '_torch_serve_mesh_reference.py'),
                            str(tmp / 'reference.npz')])
    try:
        out = {'2x2': _worker(tmp, '2x2', 'all'), '1x4': _worker(tmp, '1x4', 'stream')}
        assert ref.wait(timeout=TIMEOUT) == 0
    finally:
        if ref.poll() is None:
            ref.kill()
    out['reference'] = dict(np.load(tmp / 'reference.npz'))
    return out


@pytest.fixture(scope='module')
def two(runs):
    return runs['2x2'][0]


def _same(values):
    return len(set(json.dumps(v, sort_keys=True) for v in values)) == 1


@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
def test_drainer_stream_is_bitwise_per_request(runs, mesh):
    """One producer thread a rank, a mixed stream of three shapes
    (complex and real, forward and inverse, planar, an operator), no
    flush(): every result on every rank bitwise equal to that rank's
    per-request call, and the engine closed."""
    rec = runs[mesh][0]['stream']
    assert rec['bitwise'] is True and rec['closed'] is True
    assert rec['requests'] == [18] * 4


@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
def test_drainer_groups_pair_on_every_rank(runs, mesh):
    """The groups are equal in number, width and order on every rank,
    and some coalesced (the schedule's width is 4)."""
    rec = runs[mesh][0]['stream']
    assert _same(rec['digest']) and _same(rec['groups'])
    widths = rec['widths']
    assert all(_same(v) for v in widths.values())
    assert sum(int(w) * v[0] for w, v in widths.items()) == 18
    assert max(int(w) for w in widths) > 1


def test_deadline_only_load_dispatches(two):
    """A watermark that never trips: the 50 ms deadline alone serves."""
    rec = two['deadline']
    assert rec['bitwise'] is True and _same(rec['digest'])
    assert rec['groups'][0] >= 1


def test_watermark_only_load_dispatches(two):
    """No deadline at all: the width watermark alone serves."""
    rec = two['watermark']
    assert rec['bitwise'] is True and _same(rec['digest'])
    assert rec['groups'][0] >= 2


def test_dispatch_fault_is_retried_on_every_rank(two):
    """An ``engine.dispatch`` fault drawn on position 0 (twice) fails the
    group on every rank; every rank re-queues it and the third dispatch
    serves it bitwise. Only position 0 draws."""
    rec = two['fault']
    assert rec['bitwise'] is True
    assert rec['fired'] == [2, 0, 0, 0]
    assert rec['groups'] == [3] * 4 and _same(rec['digest'])


def test_persistent_dispatch_fault_surfaces_on_every_rank(two):
    rec = two['fault']
    assert rec['persistent_surfaced'] is True
    assert rec['persistent_groups'] == [2] * 4 and _same(rec['persistent_digest'])


def test_drainer_stall_delays_but_serves(two):
    rec = two['stall']
    assert rec['bitwise'] is True and _same(rec['digest'])
    assert rec['stalls'][0] >= 1 and rec['stalls'][1:] == [0, 0, 0]
    assert min(rec['seconds']) >= 0.2


def test_service_multi_tenant_bit_identity(two):
    """Three tenants stream 10 mixed requests each at once to position 0's
    socket: all served, none rejected, every result bitwise equal to the
    ranks' per-request calls put together."""
    rec = two['service']['multi_tenant']
    lead = rec[0]
    assert lead['clients_ok'] and lead['counts_ok'], lead['failures']
    assert all(r['bitwise'] is True and r['served_closed'] is True for r in rec)
    assert lead['mesh_metrics']['ranks'] == 4 and lead['mesh_metrics']['requests'] == 30


def test_service_quota_isolation(two):
    """A tenant flooding past its quota of 2 meets typed RetryAfter while
    the good tenant serves with no rejection and an undegraded p99."""
    rec = two['service']['quota']
    assert rec[0]['isolated'] is True, rec[0]
    assert all(r['bitwise'] is True for r in rec)


def test_service_slo_ordering(two):
    """Three batch-class requests sit out their 30 s wait until one
    rush-class request's deadline ripens the shared queue."""
    rec = two['service']['slo']
    assert rec[0]['ordered'] is True, rec[0]
    assert all(r['bitwise'] is True for r in rec)


def test_service_bytes_equal_the_one_rank_service(two):
    """Every result frame of the mesh service carries the bytes a
    one-rank service (the same method, Stockham) sends for the request."""
    assert two['service']['one_rank_bytes'] is True


@pytest.mark.parametrize('mesh, prefix', [('2x2', 'stream_'), ('1x4', 'stream_'),
                                          ('2x2', 'service_')],
                         ids=['stream-2x2', 'stream-1x4', 'service-2x2'])
def test_served_results_match_the_jax_package(runs, mesh, prefix):
    served, ref = runs[mesh][1], runs['reference']
    keys = [k for k in served if k.startswith(prefix)]
    assert len(keys) == (18 if prefix == 'stream_' else 30)
    for k in keys:
        got, want = served[k], ref[k]
        assert got.shape == want.shape, k
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= RTOL, k


def test_close_drain_ends_every_process(two):
    """``close(drain=True)`` on position 0 ended every rank's service and
    engine; the worker's four processes exited (within the fixture's
    timeout)."""
    assert two['service']['engine_closed'] is True
    assert all(r['served_closed'] is True for r in two['service']['multi_tenant'])


def _distributed(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))
    return subprocess.run([sys.executable, '-m', 'torch.distributed.run', '--standalone',
                           '--nproc-per-node', '4', *args], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=timeout)


def test_launcher_smoke_on_a_mesh():
    proc = _distributed(['-m', 'repro_torch.launch.fft_service', '--smoke', '--mesh', '2x2',
                         '--device', 'cpu'])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert 'fft_service smoke OK' in proc.stdout and 'mesh 2x2' in proc.stdout


def test_example_on_a_mesh():
    proc = _distributed([os.path.join(ROOT, 'examples', 'torch_serve_fft.py'), '--mesh', '2x2',
                         '--device', 'cpu', '--n', '16'])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert 'serve_fft OK' in proc.stdout and 'zero flush() calls' in proc.stdout
