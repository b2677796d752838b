"""Port parity for the cost model, the ``comm='auto'`` selector and the
overlap helpers: ``repro_torch.comm.cost`` / ``strategies`` / ``overlap``
and ``repro_torch.core.wse_model`` against their ``repro`` originals.

All pure Python on both sides (no jax program runs). The oracle is
``repro.comm.cost`` called directly, with ``measured=None`` or one table
given to both packages: the reference's facade route through
``jax.sharding.AbstractMesh`` fails on the installed jax, and its
``measured='auto'`` reads the JAX package's own measurements, which the
port deliberately never reads. Cycle counts agree to 1e-9 relative (the
same float operations in the same order; observed equal), picks and
report text exactly.
"""
import itertools
import json
import math
import os
from dataclasses import astuple

import pytest
import torch

from repro.comm import cost as rcost
from repro.comm import overlap as rov
from repro.comm import strategies as rstrat
from repro.core import wse_model as rwm
import repro_torch.fft as tfft
from repro_torch.comm import cost as tcost
from repro_torch.comm import overlap as tov
from repro_torch.comm import strategies as tstrat
from repro_torch.core import wse_model as twm
from repro_torch.launch.mesh import abstract_fft_mesh

REL = 1e-9

SHAPES = [(16,) * 3, (32,) * 3, (64,) * 3, (512,) * 3, (8, 16, 32), (16, 32), (512, 512)]
MESHES = [(1, 1), (2, 2), (1, 4), (2, 4), (4, 4), (512, 512)]


@pytest.fixture(autouse=True)
def _analytic(monkeypatch):
    """Every plan here prices with the analytic model, whatever
    measured table the checkout may hold."""
    monkeypatch.setenv(tcost.MEASURED_ENV, '')


def _layout(shape):
    return ('x', 'y', None) if len(shape) == 3 else (('x', 'y'), None)


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _same_cost(a, b):
    """Two PlanCosts: the same steps (kind, detail, cycles) and fields."""
    assert (a.strategy, a.method, a.precision, a.overlap_chunks, a.wire_dtype, a.kernel) == (
        b.strategy, b.method, b.precision, b.overlap_chunks, b.wire_dtype, b.kernel)
    assert [(s.kind, s.detail) for s in a.steps] == [(s.kind, s.detail) for s in b.steps]
    for s, t in zip(a.steps, b.steps):
        assert _close(s.cycles, t.cycles), (s, t)
    assert _close(a.cycles, b.cycles) and _close(a.serial_cycles, b.serial_cycles)
    assert _close(a.wire_cycles, b.wire_cycles)
    assert a.overlapped_steps() == b.overlapped_steps()


def _both(fn_ref, fn_port):
    """(ref result, port result), or the exception types where either raises."""
    out = []
    for fn in (fn_ref, fn_port):
        try:
            out.append(fn())
        except Exception as exc:  # noqa: BLE001 - the type is compared below
            out.append(exc)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_select_matches_reference(shape, mesh):
    """Same pick, same prices, same report, complex and real, every wire
    format, with and without the pod-tree search; where the reference
    raises, the port raises the same type."""
    ms = {'x': mesh[0], 'y': mesh[1]}
    for real, wire, trees in itertools.product((False, True), ('native', 'fp16', 'bf16'),
                                               (None, True)):
        kw = dict(real=real, wire_dtype=wire, pod_trees=trees, measured=None)
        ref, got = _both(lambda: rcost.select(shape, _layout(shape), ms, **kw),
                         lambda: tcost.select(shape, _layout(shape), ms, **kw))
        if isinstance(ref, Exception) or isinstance(got, Exception):
            assert type(ref) is type(got), (kw, ref, got)
            continue
        assert (got.strategy, got.overlap_chunks, got.method) == (
            ref.strategy, ref.overlap_chunks, ref.method), kw
        assert list(got.costs) == list(ref.costs)
        for name in ref.costs:
            _same_cost(got.costs[name], ref.costs[name])
            assert (tcost.format_report(got.costs[name], shape, ms)
                    == rcost.format_report(ref.costs[name], shape, ms))


#: the reference selector's picks (measured=None): (shape, mesh) ->
#: (complex pick, real pick), each (strategy, overlap_chunks, method)
PICKS = {
    ((64,) * 3, (2, 2)): (('all_to_all', 8, 'four_step'), ('all_to_all', 1, 'auto')),
    ((512,) * 3, (1, 1)): (('all_to_all', 1, 'four_step'), ('all_to_all', 1, 'four_step')),
    ((512,) * 3, (2, 2)): (('all_to_all', 8, 'four_step'), ('all_to_all', 1, 'four_step')),
    ((512,) * 3, (1, 4)): (('ppermute', 8, 'four_step'), ('ppermute', 1, 'four_step')),
    ((512,) * 3, (512, 512)): (('all_to_all', 1, 'four_step'),
                               ('all_to_all', 1, 'four_step')),
    ((32,) * 3, (2, 2)): (('all_to_all', 4, 'stockham'), ('all_to_all', 1, 'stockham')),
}


@pytest.mark.parametrize("shape, mesh", list(PICKS), ids=lambda v: str(v))
def test_default_plans_resolve_to_the_pick(shape, mesh):
    """``plan``/``rplan`` with no options on an abstract mesh resolve to
    the selector's pick, or raise naming 'Other strategies' where the
    pick is a strategy the port cannot run; nothing falls back."""
    am = abstract_fft_mesh(*mesh)
    for make, want in zip((tfft.plan, tfft.rplan), PICKS[(shape, mesh)]):
        sel = rcost.select(shape, _layout(shape), dict(am.shape), measured=None,
                           real=make is tfft.rplan)
        assert (sel.strategy, sel.overlap_chunks, sel.method) == want
        if want[0] != 'all_to_all':
            with pytest.raises(NotImplementedError, match='Other strategies'):
                make(shape, am)
            continue
        p = make(shape, am)
        assert (p.comm, p.overlap_chunks, p.method) == want
        with pytest.raises(RuntimeError, match='cannot run'):
            p.forward(torch.zeros(shape))


@pytest.mark.parametrize("mesh", [(512, 512), (2, 2)], ids=['512x512', '2x2'])
@pytest.mark.parametrize("real", [False, True], ids=['complex', 'real'])
def test_plan_cost_matches_reference(mesh, real):
    """``FFT.plan_cost``/``cost_report`` on an abstract mesh equal the
    reference's ``pencil_plan_cost``/``format_report`` with the same
    arguments, for the default plan and a few explicit ones."""
    am = abstract_fft_mesh(*mesh)
    shape = (512,) * 3
    make = tfft.rplan if real else tfft.plan
    plans = [make(shape, am), make(shape, am, method='stockham', overlap_chunks=2),
             make(shape, am, comm='all_to_all', wire_dtype='bf16'),
             make(shape, am, padded_spectrum=True) if real else make(shape, am,
                                                                     restore_layout=True)]
    for p in plans:
        for prec in ('fp32', 'fp16'):
            want = rcost.pencil_plan_cost(
                shape, ('x', 'y', None), dict(am.shape), precision=prec, method=p.method,
                strategy=p.comm, overlap_chunks=p.overlap_chunks, real=real,
                padded_spectrum=p.padded_spectrum or not real, measured=None,
                wire_dtype=p.wire_dtype, kernel=p.resolved_kernel)
            _same_cost(p.plan_cost(prec, measured=None), want)
            assert p.cost_report(prec) == rcost.format_report(want, shape, dict(am.shape))
    assert 'paper Table 1 measured' in plans[0].cost_report() or mesh != (512, 512)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_feasible_overlap_and_steps_match_reference(mesh):
    ms = {'x': mesh[0], 'y': mesh[1]}
    for shape, real in itertools.product(SHAPES, (False, True)):
        lay = _layout(shape)
        ref, got = _both(lambda: rcost.feasible_overlap(shape, lay, ms, real=real),
                         lambda: tcost.feasible_overlap(shape, lay, ms, real=real))
        if isinstance(ref, Exception) or isinstance(got, Exception):
            assert type(ref) is type(got)
            continue
        assert got == ref, (shape, real)
        for strategy, padded, oc in itertools.product(
                ('all_to_all', 'ppermute', 'hierarchical'), (False, True), ref):
            kw = dict(strategy=strategy, real=real, padded_spectrum=padded,
                      overlap_chunks=oc, measured=None, method='auto')
            _same_cost(tcost.pencil_plan_cost(shape, lay, ms, **kw),
                       rcost.pencil_plan_cost(shape, lay, ms, **kw))


def test_pipeline_model_matches_reference():
    ms = {'x': 4, 'y': 4}
    kw = dict(measured=None, overlap_chunks=4)
    ref = rcost.pencil_plan_cost((64,) * 3, ('x', 'y', None), ms, **kw)
    got = tcost.pencil_plan_cost((64,) * 3, ('x', 'y', None), ms, **kw)
    for batch, oc in itertools.product((1, 3, 8), (None, 1, 2, 8)):
        assert _close(got.pipeline_cycles(batch, oc), ref.pipeline_cycles(batch, oc))
        assert _close(got.pipeline_us(batch, oc), ref.pipeline_us(batch, oc))
        assert _close(got.pipeline_latency_us(batch, oc), ref.pipeline_latency_us(batch, oc))
    assert _close(got.runtime_us(), ref.runtime_us())


def _rows():
    """A measured table: dtype-tagged and legacy rows, a pod tree, two meshes."""
    rows = []
    for mesh, group, strategy, dtype in [
            ('2x2', 'x', 'all_to_all', 'c64'), ('2x2', 'y', 'all_to_all', None),
            ('2x2', 'x', 'ppermute', 'c64'), ('2x2', 'y', 'ppermute', 'f16'),
            ('2x2', 'x', 'pod_tree:x.2', 'c64'), ('2x2', 'y', 'all_to_all', 'bf16'),
            ('4x4', 'x*y', 'hierarchical', 'c128'), ('4x4', 'x', 'all_to_all', 'c64')]:
        for k, elems in enumerate((64, 512, 4096, 32768)):
            row = dict(mesh=mesh, group=group, strategy=strategy, local_elems=elems,
                       us=20.0 + 3.0 * k * k + len(strategy))
            if dtype is not None:
                row['dtype'] = dtype
            rows.append(row)
    return rows


def test_measured_table_matches_reference(tmp_path):
    path = tmp_path / 'measured.json'
    path.write_text(json.dumps({'results': _rows()}))
    ref, got = rcost.measured_table(str(path)), tcost.measured_table(str(path))
    assert len(got) == len(ref) == 32
    for ms in ({'x': 2, 'y': 2}, {'x': 4, 'y': 4}, {'x': 1, 'y': 1}):
        assert got.strategies_for(ms) == ref.strategies_for(ms)
    for (strategy, axis, dtype), elems in itertools.product(
            [('all_to_all', 'x', 'c64'), ('all_to_all', 'y', 'c64'),
             ('all_to_all', 'y', 'c128'), ('ppermute', 'y', 'f16'),
             ('all_to_all', 'y', 'bf16'), ('hierarchical', ('x', 'y'), 'c128'),
             ('pod_tree:x.2', 'x', 'c64'), ('ppermute', 'x', 'f16')],
            (10, 32, 64, 100, 512, 1000, 4096, 30000, 32768, 65536, 70000)):
        ms = {'x': 4, 'y': 4} if strategy == 'hierarchical' else {'x': 2, 'y': 2}
        a = ref.swap_us(strategy, ms, axis, elems, dtype=dtype)
        b = got.swap_us(strategy, ms, axis, elems, dtype=dtype)
        assert (a is None and b is None) or _close(a, b), (strategy, axis, dtype, elems)
    # the selector and the pricing with that table on both sides
    for shape, real, wire in itertools.product([(16,) * 3, (32, 32, 64), (16, 32)],
                                               (False, True), ('native', 'fp16', 'bf16')):
        ms = {'x': 2, 'y': 2}
        a = rcost.select(shape, _layout(shape), ms, real=real, wire_dtype=wire, measured=ref)
        b = tcost.select(shape, _layout(shape), ms, real=real, wire_dtype=wire, measured=got)
        assert (b.strategy, b.overlap_chunks, b.method) == (a.strategy, a.overlap_chunks,
                                                            a.method)
        assert list(b.costs) == list(a.costs) and 'pod_tree:x.2' in b.costs
        for name in a.costs:
            _same_cost(b.costs[name], a.costs[name])


def test_measured_auto_reads_the_ports_own_file(tmp_path, monkeypatch):
    """'auto' reads ``REPRO_TORCH_MEASURED_COSTS`` ('' disables), else
    ``BENCH_torch_redistribute.json`` at the repo root; never the JAX
    package's file or variable. With no file, 'auto' prices as None."""
    assert tcost._default_measured_path().endswith('BENCH_torch_redistribute.json')
    path = tmp_path / 'mine.json'
    path.write_text(json.dumps({'results': _rows()}))
    monkeypatch.setenv('REPRO_MEASURED_COSTS', str(path))     # the JAX package's
    monkeypatch.delenv(tcost.MEASURED_ENV)
    if not os.path.exists(tcost._default_measured_path()):
        assert tcost.measured_table() is None
        shape, ms = (32,) * 3, {'x': 4, 'y': 4}
        a = tcost.select(shape, _layout(shape), ms)
        b = tcost.select(shape, _layout(shape), ms, measured=None)
        assert (a.strategy, a.overlap_chunks) == (b.strategy, b.overlap_chunks)
    monkeypatch.setenv(tcost.MEASURED_ENV, str(path))
    assert len(tcost.measured_table()) == 32
    monkeypatch.setenv(tcost.MEASURED_ENV, '')
    assert tcost.measured_table() is None


@pytest.mark.parametrize("spec", ['x.2', 'x.4*y.2*y.2', 'y.2*x.8', 'y.3*x.2*y.5', 'pod.2*x.4'])
def test_tree_spec_round_trips(spec):
    tree = tstrat.parse_tree_spec(spec)
    assert tree == rstrat.parse_tree_spec(spec)
    assert tstrat.format_tree_spec(tree) == rstrat.format_tree_spec(tree)
    assert tstrat.parse_tree_spec(tstrat.format_tree_spec(tree)) == tree
    name = tstrat.POD_TREE_PREFIX + spec
    assert tstrat.validate(name) == rstrat.validate(name)


@pytest.mark.parametrize("spec", ['', 'x', 'x.1', 'x.a', '.2', 'x.2*'])
def test_bad_tree_specs_raise_as_the_reference(spec):
    with pytest.raises(ValueError):
        rstrat.parse_tree_spec(spec)
    with pytest.raises(ValueError):
        tstrat.parse_tree_spec(spec)


def test_enumerate_trees_matches_reference():
    for ms in ({'x': 2, 'y': 2}, {'x': 4, 'y': 4}, {'x': 1, 'y': 8}, {'x': 512, 'y': 512},
               {'x': 12, 'y': 6}):
        for depth in (1, 2, 3):
            assert (tcost.enumerate_trees(tuple(ms), ms, max_depth=depth)
                    == rcost.enumerate_trees(tuple(ms), ms, max_depth=depth))
        for extent in ms.values():
            assert (tcost.enumerate_axis_factorizations(extent)
                    == rcost.enumerate_axis_factorizations(extent))


def test_strategy_costs_match_reference():
    """Every strategy's swap price, single and tuple axes, weighted links."""
    names = list(rstrat.names()) + ['pod_tree:x.2*x.2*y.4', 'pod_tree:y.2*y.2']
    assert tstrat.names() == rstrat.names() == ('all_to_all', 'ppermute', 'hierarchical')
    ms = {'x': 4, 'y': 4}
    for name, axis, prec, bw, elems in itertools.product(
            names, ('x', 'y', ('x', 'y'), ('y', 'x')), ('fp32', 'fp16'),
            (None, {'x': 3.0}, {'y': 1.5, 'x': 1.0}), (16.0, 1e6)):
        a = rstrat.get(name).cost(axis, ms, elems, prec, axis_bw=bw)
        b = tstrat.get(name).cost(axis, ms, elems, prec, axis_bw=bw)
        assert (b.strategy, b.p, b.elems) == (a.strategy, a.p, a.elems)
        assert _close(b.wire_cycles, a.wire_cycles) and _close(b.fixed_cycles, a.fixed_cycles)


def test_only_all_to_all_can_swap():
    assert tstrat.check_runnable('all_to_all') == 'all_to_all'
    for name in ('ppermute', 'hierarchical', 'pod_tree:x.2*y.2'):
        with pytest.raises(NotImplementedError, match='Other strategies'):
            tstrat.check_runnable(name)
        with pytest.raises(NotImplementedError, match='Other strategies'):
            tstrat.get(name).swap_start(torch.zeros(4, 4), abstract_fft_mesh(2, 2), 'x',
                                        shard_pos=0, mem_pos=1)
    with pytest.raises(ValueError, match='unknown comm strategy'):
        tstrat.get('ring')


def test_wse_model_matches_reference():
    for n, m, prec in itertools.product((32, 64, 512), (1, 2, 4), ('fp32', 'fp16')):
        assert twm.total_cycles_model(n, m, prec) == rwm.total_cycles_model(n, m, prec)
        assert twm.tt_comm(n, m, prec) == rwm.tt_comm(n, m, prec)
    for name in ('CLOCK_HZ', 'LOCAL_REORDER_CPE', 'POINTWISE_CPE', 'RFFT_COMBINE_CPE',
                 'TABLE1_CYCLES', 'RING_ROUND_OVERHEAD', 'ROUTER_RECONFIG',
                 'BACKEND_COMPUTE', 'PALLAS_FUSED_SPEEDUP', 'MXU_MACS_PER_CYCLE'):
        assert getattr(twm, name) == getattr(rwm, name), name
    for n, prec, method, backend, kernel in itertools.product(
            (2, 8, 64, 512, 100), ('fp32', 'fp16'), ('stockham', 'four_step', 'direct'),
            ('wse', 'cpu', 'cuda', 'tpu', 'other'), ('reference', 'pallas')):
        assert twm.pencil_cycles_backend(n, prec, method, backend=backend, kernel=kernel) \
            == rwm.pencil_cycles_backend(n, prec, method, backend=backend, kernel=kernel)
        assert (twm.rfft_pencil_cycles_method(n, prec, method)
                == rwm.rfft_pencil_cycles_method(n, prec, method))
    for p, elems, prec in itertools.product((1, 2, 5, 512), (3.0, 4096.0), ('fp32', 'fp16')):
        for fn in ('swap_cost_a2a', 'swap_cost_ring'):
            assert (astuple(getattr(twm, fn)(p, elems, prec))
                    == astuple(getattr(rwm, fn)(p, elems, prec)))
        assert (astuple(twm.swap_cost_hierarchical(p, 3, elems, prec))
                == astuple(rwm.swap_cost_hierarchical(p, 3, elems, prec)))
        assert twm.swap_cycles_hierarchical(p, 4, elems, prec) == \
            rwm.swap_cycles_hierarchical(p, 4, elems, prec)
    assert twm.runtime_us(815_371) == rwm.runtime_us(815_371)
    assert twm.tt_comm_single(64, 'fp16') == rwm.tt_comm_single(64, 'fp16')


def test_pick_chunk_axis_matches_reference():
    for shape in ((1, 512, 512, 512), (2, 32, 32, 64), (4, 8, 257), (3, 6, 12)):
        for exclude in ((), (1, 3), (0, 1, 2), (2,)):
            for c in (1, 2, 3, 4, 8):
                assert (tov.pick_chunk_axis(shape, exclude, c)
                        == rov.pick_chunk_axis(shape, exclude, c))


def test_pipelined_joins_the_chunks_in_order():
    x = torch.arange(48.0).reshape(4, 3, 4)
    y = torch.arange(48.0, 96.0).reshape(4, 3, 4)
    seen = []

    def fn(a, b):
        seen.append(a.shape)
        return a * 2, (a + b).sum(-1, keepdim=True)
    got = tov.pipelined(2, 0, fn, x, y)
    assert seen == [(2, 3, 4), (2, 3, 4)]
    assert torch.equal(got[0], x * 2) and torch.equal(got[1], (x + y).sum(-1, keepdim=True))
    assert torch.equal(tov.pipelined(1, 0, lambda a: a + 1, x), x + 1)


def test_pipelined_pair_orders_starts_before_waits():
    """Forward: every chunk's swap starts before any finishes, each right
    after its chunk's compute; mirrored: all starts, then wait and
    compute chunk by chunk. The join is the unchunked result."""
    log = []

    def start(t):
        k = len([e for e in log if e[0] == 'start'])
        log.append(('start', k))

        def finish():
            log.append(('wait', k))
            return t.flip(-1)
        return tstrat.PendingSwap(finish)

    def compute(a):
        log.append(('compute',))
        return (a + 1, a - 1)
    x = torch.arange(24.0).reshape(4, 6)
    re, im = tov.pipelined_pair(2, 0, compute=compute, swap_start=start, arrays=(x,))
    assert torch.equal(re, (x + 1).flip(-1)) and torch.equal(im, (x - 1).flip(-1))
    assert [e[0] for e in log] == ['compute', 'start', 'start', 'compute', 'start', 'start',
                                   'wait', 'wait', 'wait', 'wait']
    log.clear()
    y = tov.pipelined_pair(2, 0, compute=lambda a, b: a * b, swap_start=start,
                           swap_first=True, arrays=(x, x + 1))
    assert torch.equal(y, (x * (x + 1)).flip(-1))
    assert [e[0] for e in log] == ['start'] * 4 + ['wait', 'wait', 'wait', 'wait']


def test_stream_pipeline_window():
    """At most ``depth`` in flight; results forced and reported in push
    order; a failing dispatch names its own call."""
    events = []
    pipe = tov.StreamPipeline(depth=2)
    for i in range(5):
        pipe.push(lambda i=i: events.append(('run', i)) or torch.tensor(i),
                  on_result=lambda r: events.append(('done', int(r))))
        assert len(pipe) <= 2
    pipe.drain()
    assert [e for e in events if e[0] == 'done'] == [('done', i) for i in range(5)]
    assert events.index(('done', 0)) < events.index(('run', 2))
    failed = []
    with pytest.raises(ZeroDivisionError):
        pipe.push(lambda: 1 / 0, on_error=failed.append)
    assert isinstance(failed[0], ZeroDivisionError)
    pipe.push(lambda: torch.zeros(1))
    assert pipe.abort() == 1 and len(pipe) == 0
    assert tov.pipelined_stream(lambda v: v * 3, [1, 2, 3], depth=1) == [3, 6, 9]
    with pytest.raises(ValueError):
        tov.StreamPipeline(depth=0)


def test_wire_elem_bytes_match_reference():
    for wire, nb in itertools.product(('native', 'fp16', 'bf16'), (1, 2, 4, 8)):
        assert tstrat.wire_elem_bytes(wire, nb) == rstrat.wire_elem_bytes(wire, nb)
    assert math.isclose(tcost.OVERLAP_CHUNK_OVERHEAD, rcost.OVERLAP_CHUNK_OVERHEAD)
