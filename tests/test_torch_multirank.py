"""The port's distributed FFT on 4 gloo CPU ranks (a 2 x 2 mesh, 16^3
and 16 x 32 with comm='all_to_all'; 64^3 planned by the selector or with
overlap_chunks=2; rank 1 at n = 4096, complex and real, planned by the
selector), run by ``_torch_multirank_worker.py`` in a subprocess; and
its suites 'pod' (``batch_spec='pod'`` on a 1 x 2 x 2-pod mesh, rank 3
and rank 1, complex and real) and 'op' (``plan_op`` on 2 x 2 at rank 3
and on 1 x 4 at rank 1, real and complex), each also held against the
JAX package's results of ``_torch_jax_reference.py`` (four fake devices,
Auto axes).

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
  (bitwise), the swaps being pure data movement;
* the unfused supersteps (``make_fft``, ``make_fft1d_large`` and
  ``make_fourstep_op`` with ``fused=False``) against the same functions
  built fused: 0 (bitwise) for the four-step, one kernel (or one plain
  pencil) on the same pencils either way; <= 1e-6 for Stockham, whose
  fused superstep runs another CUDA kernel on the card (bitwise on these
  gloo ranks, the plain tier); against the JAX package's ``fused=False``
  functions: <= 1e-6;
* a pod plan's or an operator's blocks against the JAX package's: <=
  1e-6 (XLA contracts products into FMAs); an operator against its
  unfused composition on the mesh, and a baked factor against the
  runtime one: 0 (bitwise).
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
    CASES, OP_CASES, OVERLAP_CASES, POD_CASES, RANK1_CASES, REAL_CASES, REAL_OVERLAP_CASES,
    UNFUSED_CASES)

WIRE_BOUNDS = {'fp16': 1.5e-3, 'bf16': 1.2e-2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run_worker(out, *args) -> dict:
    """``_torch_multirank_worker.py`` on gloo CPU ranks with ``args``
    (``--mesh``, ``--pods``, ``--suite``, ``--ref``); its records by case
    name."""
    subprocess.run([sys.executable, os.path.join(HERE, '_torch_multirank_worker.py'),
                    str(out), str(_free_port()), *args], check=True, timeout=300)
    with open(out) as fh:
        return json.load(fh)


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp('multirank') / 'results.json')


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """The JAX package's global results of the pod and op cases, from
    ``_torch_jax_reference.py`` on four fake devices (a subprocess)."""
    out = tmp_path_factory.mktemp('reference') / 'reference.npz'
    subprocess.run([sys.executable, os.path.join(HERE, '_torch_jax_reference.py'), str(out)],
                   check=True, timeout=300)
    return out


@pytest.fixture(scope='module')
def mesh_suites(tmp_path_factory, reference):
    """Suite 'pod' on 1 x 2 x 2 pods and suite 'op' on 2 x 2 and 1 x 4,
    each held against the reference's results."""
    tmp = tmp_path_factory.mktemp('mesh_suites')
    merged = run_worker(tmp / 'pod.json', '--mesh', '1x2', '--pods', '2', '--suite', 'pod',
                        '--ref', str(reference))
    for mesh in OP_CASES:
        merged.update(run_worker(tmp / f'op_{mesh}.json', '--mesh', mesh, '--suite', 'op',
                                 '--ref', str(reference)))
    return merged


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


def check_pod(r):
    """A ``batch_spec='pod'`` plan's blocks: bitwise equal to the single
    process's (Stockham), within 1e-5 of numpy and for the round trip,
    and within 1e-6 of the JAX package's where it ran."""
    assert r['shape_ok']
    assert r['fwd_vs_single'] == 0.0
    assert r['fwd_vs_numpy'] <= 1e-5 and r['roundtrip'] <= 1e-5
    if 'fwd_vs_reference' in r:
        assert r['fwd_vs_reference'] <= 1e-6


def check_op(r):
    """An operator plan's blocks: bitwise equal to the single-process
    operator, to its unfused composition on the mesh and, baked in either
    form (transformed once), to the runtime factor; within 1e-5 of numpy
    and within 1e-6 of the JAX package's executors where they ran."""
    assert r['shape_ok']
    assert r['resolved'][3] == 1
    for key in ('vs_single', 'vs_unfused', 'baked_vs_runtime', 'spectrum_vs_runtime'):
        assert r[key] == 0.0, key
    assert r['vs_numpy'] <= 1e-5
    if 'vs_reference' in r:
        assert r['vs_reference'] <= 1e-6


@pytest.mark.parametrize("name, shape, kw", POD_CASES, ids=[c[0] for c in POD_CASES])
def test_pod_batch_spec_case(mesh_suites, name, shape, kw):
    """``batch_spec='pod'`` on ``make_fft_mesh(1, 2, pods=2)``: each pod
    transforms its half of a batch of 4 over its own ('x', 'y') group."""
    assert 'fwd_vs_reference' in mesh_suites[name]
    check_pod(mesh_suites[name])


OP_CASE_LIST = [c for cases in OP_CASES.values() for c in cases]


@pytest.mark.parametrize("name, shape, kw", OP_CASE_LIST, ids=[c[0] for c in OP_CASE_LIST])
def test_op_case(mesh_suites, name, shape, kw):
    """``plan_op`` on 2 x 2 (rank 3) and 1 x 4 (rank 1), real and complex."""
    assert 'vs_reference' in mesh_suites[name]
    check_op(mesh_suites[name])


@pytest.fixture(scope='module')
def unfused_suites(tmp_path_factory, reference):
    """Suite 'unfused' on 2 x 2 and 1 x 4, held against the reference's
    ``fused=False`` functions."""
    tmp = tmp_path_factory.mktemp('unfused_suites')
    merged = {}
    for mesh in UNFUSED_CASES:
        merged.update(run_worker(tmp / f'unfused_{mesh}.json', '--mesh', mesh, '--suite',
                                 'unfused', '--ref', str(reference)))
    return merged


UNFUSED_CASE_LIST = [c for cases in UNFUSED_CASES.values() for c in cases]


@pytest.mark.parametrize("name, shape, kw", UNFUSED_CASE_LIST,
                         ids=[c[0] for c in UNFUSED_CASE_LIST])
def test_multirank_unfused_case(unfused_suites, name, shape, kw):
    """``make_fft(fused=False)`` (rank 3, complex and real),
    ``make_fft1d_large(fused=False)`` and ``make_fourstep_op(fused=False)``
    (rank 1) on 2 x 2 and 1 x 4, against the JAX package's ``fused=False``
    functions on the same global operand."""
    assert 'fwd_vs_reference' in unfused_suites[name]
    check_unfused(unfused_suites[name], kw)


def test_multirank_hlostats_gloo(unfused_suites):
    """``launch.hlostats`` on gloo 2 x 2, every rank: ten products of a
    (64, 256) ``c`` with a (256, 128) block, each gathered over 'y' (2
    ranks) to (64, 256); a backward through ``comm.enter`` over 'y' and
    one product: the forward's and the cotangent's products, and one
    all-reduce of the (64, 256) fp32 cotangent."""
    r = unfused_suites['hlostats_gloo']
    assert r['n_group'] == [2] * 4 and r['n_partitions'] == [4] * 4
    assert r['n_dot_flops'] == [10 * 2 * 64 * 256 * 128] * 4
    assert r['n_ag_bytes'] == [10 * 64 * 128 * 4] * 4
    assert r['n_ag_count'] == [10] * 4
    assert r['n_bwd_kinds'] == [['all-reduce']] * 4
    assert r['n_bwd_ar_count'] == [1] * 4
    assert r['n_bwd_ar_bytes'] == [64 * 256 * 4] * 4
    assert r['n_bwd_dot_flops'] == [2 * 2 * 64 * 256 * 128] * 4


def check_unfused(r, kw):
    """An unfused function on the mesh: bitwise its fused self for the
    four-step (one kernel, or one plain pencil, on the same pencils) and
    for a real rank-1 operator (whose bodies have no fused form); within
    1e-6 for the others (the fused Stockham superstep runs another CUDA
    kernel on the card; bitwise on gloo ranks, the plain tier). Against
    numpy and for the round trip <= 1e-5; against the JAX package's
    ``fused=False`` functions, where they ran, <= 1e-6."""
    real, op = kw.get('real', False), kw.get('op', False)
    assert r['shape_ok']
    assert r['resolved'] == [kw['method'], real, op]
    fused_keys = [k for k in ('fwd_vs_fused', 'inv_vs_fused') if k in r]
    if kw['method'] == 'four_step' or (op and real):
        assert all(r[k] == 0.0 for k in fused_keys), fused_keys
    else:
        assert all(r[k] <= 1e-6 for k in fused_keys), fused_keys
    for key in ('fwd_vs_numpy', 'roundtrip', 'inv_vs_numpy'):
        if key in r:
            assert r[key] <= 1e-5, key
    # a D-form case has no round trip: its inverse is held against numpy's
    assert ('roundtrip' in r) != (op or 'inv_vs_numpy' in r) and ('fwd_vs_numpy' in r or real)
    assert ('inv_vs_numpy' in r) == (kw.get('natural_order', True) is False)
    for key in ('fwd_vs_reference', 'inv_vs_reference', 'fwd_fused_vs_reference',
                'inv_fused_vs_reference'):
        if key in r:
            assert r[key] <= 1e-6, key
    if kw.get('natural_order', True) is False:
        assert 'fwd_fused_vs_reference' in r and 'inv_fused_vs_reference' in r
