"""The swaps of every registered strategy: ``ppermute`` (a ring of
point-to-point rounds), ``hierarchical`` and ``pod_tree:<spec>`` (one
exchange a level of a factorization, then one local digit reversal).

A swap is pure data movement, so every strategy must give the bits of
``all_to_all``. ``_torch_multirank_worker.py --suite strategies`` runs,
on gloo CPU ranks of a 2 x 2, a 1 x 4 and a 2 x 4 mesh (8 ranks, one
subprocess), each plan of ``STRATEGY_PLANS`` (rank 3, complex and real;
rank 2 over ('x', 'y'); rank 1, complex and real; ``overlap_chunks=2``
at ranks 3 and 1; an fp16 wire) under ``ppermute``, ``hierarchical``
and the mesh's pod tree (``x.2*y.2``, ``y.2*y.2``, ``x.2*y.2*y.2``), and
the bare swap of each strategy on random blocks. Tolerances, each a max
gap over all ranks divided by the largest magnitude of its reference:

* against the same plan on ``all_to_all``, forward and inverse, and a
  bare swap against the all-to-all's: 0 (bitwise);
* against the single-process plan: 0 (bitwise; Stockham pencils are
  independent of how they are batched); a pipelined plan against its
  unchunked self: 0;
* against numpy and for the round trip: <= 1e-5; with an fp16 wire
  <= 1.5e-3 (``test_torch_multirank.check_strategy_plan``).
"""
import itertools
import os
import sys

import pytest
import torch

from repro.comm import strategies as rstrat
import repro_torch.fft as tfft
from repro_torch.comm import strategies as tstrat
from repro_torch.launch.mesh import make_fft_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from _torch_multirank_worker import POD_TREES, STRATEGY_PLANS, strategies_for  # noqa: E402
from test_torch_multirank import check_strategy_plan, run_worker  # noqa: E402

MESHES = ('2x2', '1x4', '2x4')

_RESULTS = {}


@pytest.fixture(scope='module')
def suite(tmp_path_factory):
    """``suite(mesh)``: the strategies suite's records on that gloo mesh,
    run once a module."""
    def get(mesh):
        if mesh not in _RESULTS:
            out = tmp_path_factory.mktemp(f'strategies_{mesh}') / 'results.json'
            _RESULTS[mesh] = run_worker(out, '--mesh', mesh, '--suite', 'strategies')
        return _RESULTS[mesh]
    return get


PLAN_CASES = [(mesh, comm, plan) for mesh in MESHES for comm in strategies_for(mesh)
              for plan in STRATEGY_PLANS]


@pytest.mark.parametrize("mesh, comm, plan", PLAN_CASES,
                         ids=[f"{m}-{c}-{p[0]}" for m, c, p in PLAN_CASES])
def test_strategy_plan_matches_all_to_all(suite, mesh, comm, plan):
    name, _, kw = plan
    check_strategy_plan(suite(mesh)[f'{comm}/{name}'], kw, comm)


SWAP_CASES = [(mesh, comm) for mesh in MESHES for comm in strategies_for(mesh)]


@pytest.mark.parametrize("mesh, comm", SWAP_CASES, ids=[f"{m}-{c}" for m, c in SWAP_CASES])
def test_bare_swap_matches_all_to_all(suite, mesh, comm):
    """Over 'x', 'y' and ('x', 'y'), for (shard_pos, mem_pos) in
    ``SWAPS``, on every rank."""
    assert suite(mesh)[f'swap/{comm}'] is True


class _StubMesh:
    """Extents and group lookups of a 1 x 4 mesh, no process group: a
    swap that must raise before it communicates."""
    shape = {'x': 1, 'y': 4}

    def group(self, mesh_axis):
        return None, (0, 1, 2, 3)

    def group_index(self, mesh_axis):
        return 0


@pytest.mark.parametrize("comm", ['ppermute', 'pod_tree:y.2*y.2'])
def test_indivisible_mem_axis_raises(comm):
    """A mem axis the group (or the digit ring's factor) does not divide
    raises, as the reference's ring does, rather than truncating."""
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match='not divisible'):
        tstrat.get(comm).swap_start(x, _StubMesh(), 'y', shard_pos=1, mem_pos=0)


@pytest.mark.parametrize("comm", ['ppermute', 'hierarchical'])
def test_one_rank_swaps_are_the_identity(comm):
    """On a 1 x 1 mesh no strategy moves anything: a plan on each gives
    the all-to-all plan's bits, ranks 3 and 1."""
    mesh = make_fft_mesh(1, 1, device='cpu')
    gen = torch.Generator().manual_seed(5)
    for shape in ((8, 8, 8), (256,)):
        x = torch.complex(torch.randn((2,) + shape, generator=gen),
                          torch.randn((2,) + shape, generator=gen))
        p = tfft.plan(shape, mesh, comm=comm, method='stockham')
        q = tfft.plan(shape, mesh, comm='all_to_all', method='stockham')
        assert p.comm == comm
        assert torch.equal(p.forward(x), q.forward(x))


def test_every_strategy_can_swap():
    """``check_runnable`` accepts every registered name and pod trees;
    no strategy keeps the base class's swap."""
    for name in tstrat.names() + ('pod_tree:x.2*y.2', 'pod_tree:x.4*y.2*y.2'):
        assert tstrat.check_runnable(name) == name
        assert type(tstrat.get(name)).swap_start is not tstrat.Strategy.swap_start


@pytest.mark.parametrize("name", ['hierarchical', 'pod_tree:x.2*y.2', 'pod_tree:y.2*y.2',
                                  'pod_tree:x.2*y.2*y.2', 'pod_tree:x.4*y.2*y.2'])
def test_levels_match_reference(name):
    """The (axis, factor, stride) phases of each group on several meshes
    equal the reference's, or both raise."""
    for (rows, cols), axis in itertools.product(((2, 2), (1, 4), (2, 4), (4, 4)),
                                                ('x', 'y', ('x', 'y'))):
        ms = {'x': rows, 'y': cols}
        try:
            want = rstrat.get(name)._levels(axis, lambda a: ms[a])
        except ValueError:
            with pytest.raises(ValueError):
                tstrat.get(name)._levels(axis, ms)
            continue
        assert tstrat.get(name)._levels(axis, ms) == want


def test_pod_trees_of_the_suite_are_well_formed():
    for mesh, tree in POD_TREES.items():
        rows, cols = (int(v) for v in mesh.split('x'))
        assert tstrat.validate(tree) == rstrat.validate(tree) == tree
        tstrat.get(tree)._levels(('x', 'y'), {'x': rows, 'y': cols})
