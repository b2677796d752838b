"""The port's comm surface (``repro_torch.comm``: ``swap_axes``,
``apply_swap``, ``redistribute``, ``pod_fold``, ``group_size``,
``group_index``, ``register``) and the ``repro_torch.fft`` helpers,
against the JAX package's.

On 4 gloo ranks (``_torch_lm_multirank_worker.py --suite comm``, meshes
2 x 2 and 1 x 4): each swap, layout change and fold under every
registered strategy, each rank's block bitwise equal to its block of the
reference's result under ``shard_map`` (``_torch_lm_jax_reference.py``,
four fake devices, Auto axes): they only move bytes. ``group_index`` and
``group_size`` of each axis equal the reference's. Autograd through
``swap_axes`` gives the explicit reverse swap, bitwise. The real rank-1
plan's spectrum gather differentiates: its gradient within relative L2
1e-5 of the one-rank plan's.
"""
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fft as rfft
from repro import comm as rcomm
from repro.core import plan as rplan
from repro_torch import comm
from repro_torch import fft
from repro_torch.comm import strategies
from repro_torch.core import plan as planlib
from repro_torch.launch.mesh import make_fft_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import _torch_lm_multirank_worker as W  # noqa: E402

MESHES = ('2x2', '1x4')
STRATEGIES = comm.names()
SWAP_NAMES = [c[0] for c in W.SWAP_CASES]
REDIST_NAMES = [c[0] for c in W.REDIST_CASES]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def surface(tmp_path_factory):
    """The worker's records by mesh, each held against the reference's
    results of one ``_torch_lm_jax_reference.py comm`` run."""
    tmp = tmp_path_factory.mktemp('comm_surface')
    ref = tmp / 'reference.npz'
    subprocess.run([sys.executable, os.path.join(HERE, '_torch_lm_jax_reference.py'), str(ref),
                    'comm'], check=True, timeout=300)
    out = {}
    for mesh in MESHES:
        path = tmp / f'{mesh}.json'
        subprocess.run([sys.executable, os.path.join(HERE, '_torch_lm_multirank_worker.py'),
                        str(path), str(_free_port()), '--mesh', mesh, '--suite', 'comm',
                        '--ref', str(ref)], check=True, timeout=300)
        with open(path) as fh:
            out[mesh] = json.load(fh)
    return out


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('strategy', STRATEGIES)
@pytest.mark.parametrize('case', SWAP_NAMES)
@pytest.mark.parametrize('what', ['swap_axes', 'apply_swap', 'grad'])
def test_swap_bitwise_against_the_reference(surface, mesh, strategy, case, what):
    key = f'{strategy}/{case}' + ('' if what == 'swap_axes' else f'/{what}')
    assert surface[mesh][key] is True


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('strategy', STRATEGIES)
@pytest.mark.parametrize('case', REDIST_NAMES)
def test_redistribute_bitwise_against_the_reference(surface, mesh, strategy, case):
    assert surface[mesh][f'{strategy}/{case}'] is True


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('case', [c[0] for c in W.FOLD_CASES])
def test_pod_fold_bitwise_against_the_reference(surface, mesh, case):
    assert surface[mesh][case] is True


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('axis', ['x', 'y', 'x+y'])
def test_group_size_and_index_match_the_reference(surface, mesh, axis):
    assert surface[mesh][f'group/{axis}'] is True


@pytest.mark.parametrize('mesh', MESHES)
def test_gather_rows_gradient_matches_the_one_rank_plan(surface, mesh):
    assert surface[mesh]['gather_rows_grad'] <= 1e-5


@pytest.mark.parametrize('src, dst', [(c[1], c[2]) for c in W.REDIST_CASES]
                         + [(('x', 'y', None), ('y', None, 'x'))])
def test_swap_plans_and_layouts_match_the_reference(src, dst):
    assert planlib.plan_swaps(src, dst) == rplan.plan_swaps(src, dst)
    for ax, mem in planlib.plan_swaps(src, dst):
        assert planlib.swap(src, ax, mem) == rplan.swap(src, ax, mem)
        src = planlib.swap(src, ax, mem)


def test_one_rank_surface_is_the_identity():
    """A 1 x 1 mesh: every swap, fold and gather is the identity; the
    group helpers read 1 and 0."""
    mesh = make_fft_mesh(1, 1, device='cpu')
    x = torch.as_tensor(W.comm_operand())
    for st in STRATEGIES:
        assert torch.equal(comm.swap_axes(x, mesh, 'x', shard_pos=0, mem_pos=2, strategy=st), x)
        y, lay = comm.apply_swap(x, ('x', 'y', None), mesh, 'y', 2, strategy=st)
        assert torch.equal(y, x) and lay == ('x', None, 'y')
    assert torch.equal(comm.redistribute(x, ('x', 'y', None), (None, 'x', 'y'), mesh), x)
    assert comm.pod_fold(x, mesh, 'x') is x
    assert comm.group_size(mesh, ('x', 'y')) == 1 and comm.group_index(mesh, 'y') == 0
    assert comm.DEFAULT_STRATEGY == rcomm.DEFAULT_STRATEGY


def test_register_and_the_registry_match_the_reference():
    assert comm.names() == rcomm.names()
    with pytest.raises(ValueError, match='already registered'):
        comm.register(comm.get('all_to_all'))

    class Mirror(strategies.AllToAllStrategy):
        name = 'mirror_a2a'
    try:
        assert comm.register(Mirror()).name == 'mirror_a2a'
        assert 'mirror_a2a' in comm.names() and comm.get('mirror_a2a').name == 'mirror_a2a'
    finally:
        strategies._REGISTRY.pop('mirror_a2a')
    assert set(comm.__all__) == set(rcomm.__all__) | {'all_gather', 'all_reduce'}


def test_fft_helpers_match_the_reference():
    assert fft.available_methods() == rfft.available_methods()
    assert fft.available_comm_strategies() == rfft.available_comm_strategies()
    rng = np.random.default_rng(3)
    re, im = (rng.standard_normal((4, 64)).astype(np.float32) for _ in range(2))
    for method in ('stockham', 'four_step', 'direct'):
        got = fft.apply_method(torch.as_tensor(re), torch.as_tensor(im), method=method,
                               kernel='reference')
        want = rfft.apply_method(jnp.asarray(re), jnp.asarray(im), method=method,
                                 kernel='reference')
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    got = fft.apply_real_method(torch.as_tensor(re), method='four_step', kernel='reference')
    want = rfft.apply_real_method(jnp.asarray(re), method='four_step')
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
