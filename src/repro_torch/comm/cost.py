"""Plan costing and the ``comm='auto'`` selector.

Port of ``repro.comm.cost``. Given (shape, layout, mesh extents,
precision) it prices every superstep of the pencil schedule under each
registered redistribution strategy with the paper's cycle model
(:mod:`repro_torch.core.wse_model`), and picks the cheapest strategy, a
pipelining depth (``overlap_chunks``) and, for ``method='auto'``, the
local pencil algorithm. Costing works on a plain ``{axis_name: extent}``
mapping, never on a process group, so the paper's 512^3 on a 512 x 512
mesh is priced exactly (``abstract_fft_mesh``).

The prices are WSE cycles, and a "runtime" is those cycles at the CS-2
clock: the model ranks schedules exactly as the reference does and
predicts no time on a GPU.

Deliberate difference: ``measured='auto'`` reads the port's own table
of measured swap times (``BENCH_torch_redistribute.json`` at the repo
root, or the file named by ``REPRO_TORCH_MEASURED_COSTS``), never the
JAX package's ``BENCH_redistribute.json``; absent, the analytic model
prices every swap.

Not here yet: ``ScheduleTable`` and its persistence (ROADMAP queue 1,
'FFT serving'), ``large1d_plan_cost`` ('Rank 1') and
``spectral_op_cost`` ('Operator plans').
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.comm import strategies as strat
from repro_torch.core import plan as planlib
from repro_torch.core import wse_model as wm
from repro_torch.core.plan import Layout

#: per-chunk dispatch overhead of the overlap pipeline (cycles)
OVERLAP_CHUNK_OVERHEAD = 1000.0
#: real flops per complex element of the four-step inter-factor twiddle
TWIDDLE_FLOPS_PER_ELEM = 8.0

_OVERLAP_CANDIDATES = (1, 2, 4, 8)


# ---------------------------------------------------------------------------
# Pod-tree factorization search
# ---------------------------------------------------------------------------

#: at most this many factors per mesh axis in the search
POD_TREE_MAX_DEPTH = 3
#: candidate cap of :func:`enumerate_trees` (the all-full tree is first)
POD_TREE_MAX_TREES = 64


@functools.lru_cache(maxsize=256)
def enumerate_axis_factorizations(
        extent: int,
        max_depth: int = POD_TREE_MAX_DEPTH) -> Tuple[Tuple[int, ...], ...]:
    """Every ordered factor sequence (factors >= 2, at most ``max_depth``
    long) whose product is ``extent``, ``(extent,)`` first; extent 1 has
    the empty factorization only."""
    def rec(rem: int, depth_left: int):
        if rem == 1:
            return [()]
        if depth_left == 0:
            return []
        out = []
        for f in range(2, rem + 1):
            if rem % f == 0:
                for tail in rec(rem // f, depth_left - 1):
                    out.append((f,) + tail)
        return out

    seqs = rec(int(extent), max(int(max_depth), 1))
    seqs.sort(key=lambda s: (len(s), s))
    return tuple(seqs)


def enumerate_trees(mesh_axes: Sequence[str], mesh_shape: Mapping[str, int],
                    *, max_depth: int = POD_TREE_MAX_DEPTH,
                    max_trees: int = POD_TREE_MAX_TREES) -> Tuple[str, ...]:
    """Candidate ``'pod_tree:<spec>'`` names factoring each of
    ``mesh_axes`` within the depth bound (cross product over axes, capped
    at ``max_trees``), the all-full tree (the two-phase split) first."""
    per_axis = []
    for a in mesh_axes:
        facts = enumerate_axis_factorizations(mesh_shape[a], max_depth)
        per_axis.append([(a, f) for f in facts])
    names = []
    for combo in itertools.product(*per_axis):
        tree = {a: f for a, f in combo if f}   # extent-1 axes drop out
        if not tree:
            continue
        names.append(strat.POD_TREE_PREFIX + strat.format_tree_spec(tree))
        if len(names) >= max_trees:
            break
    return tuple(dict.fromkeys(names))


def select_method(n: int, precision: wm.Precision = 'fp32') -> str:
    """Cheapest of the butterfly and matmul cycle models for a length-n
    pencil (dense DFT for non-pow2 lengths)."""
    if n & (n - 1):
        return 'direct'
    stock = wm.pencil_cycles_method(n, precision, 'stockham')
    mxu = wm.pencil_cycles_method(n, precision, 'four_step')
    return 'stockham' if stock <= mxu else 'four_step'


# ---------------------------------------------------------------------------
# Measured swap times
# ---------------------------------------------------------------------------

#: environment override for the port's measured table ('' disables it)
MEASURED_ENV = 'REPRO_TORCH_MEASURED_COSTS'

#: measured-grid dtype tag per costing precision
PRECISION_WIRE_DTYPE = {'fp16': 'c64', 'fp32': 'c64', 'fp64': 'c128'}
#: measured-grid dtype tag per compact wire format
WIRE_MEASURED_DTYPE = {'fp16': 'f16', 'bf16': 'bf16'}


def _default_measured_path() -> str:
    return os.path.join(os.path.dirname(__file__), '..', '..', '..',
                        'BENCH_torch_redistribute.json')


class MeasuredTable:
    """Measured swap timings: (mesh, group, strategy, dtype) -> sorted
    (per-device elems, us) samples. Rows without a ``dtype`` key on None
    and answer 'c64' queries only."""

    def __init__(self, rows):
        table: Dict[Tuple[str, str, str, Optional[str]], list] = {}
        for r in rows:
            dt = r.get('dtype')
            key = (str(r['mesh']), str(r['group']), str(r['strategy']),
                   None if dt is None else str(dt))
            table.setdefault(key, []).append(
                (float(r['local_elems']), float(r['us'])))
        self._table = {k: sorted(v) for k, v in table.items()}

    def __len__(self):
        return sum(len(v) for v in self._table.values())

    def strategies_for(self, mesh_shape: Mapping[str, int]) -> Tuple[str, ...]:
        """Strategy names with any measured row on this mesh."""
        mesh_key = 'x'.join(str(v) for v in mesh_shape.values())
        return tuple(sorted({k[2] for k in self._table if k[0] == mesh_key}))

    def swap_us(self, strategy: str, mesh_shape: Mapping[str, int],
                mesh_axis, elems: float, *,
                dtype: str = 'c64') -> Optional[float]:
        """Interpolated us for ONE array of ``elems`` per-device elements,
        or None when this (mesh, group, strategy) was never measured or
        ``elems`` lies beyond twice the measured range."""
        mesh_key = 'x'.join(str(v) for v in mesh_shape.values())
        group = '*'.join(strat.axis_tuple(mesh_axis))
        pts = self._table.get((mesh_key, group, strategy, dtype))
        if pts is None and dtype == 'c64':
            pts = self._table.get((mesh_key, group, strategy, None))
        if not pts:
            return None
        if not pts[0][0] / 2.0 <= elems <= pts[-1][0] * 2.0:
            return None
        if elems <= pts[0][0]:
            return pts[0][1]
        if elems >= pts[-1][0]:
            return pts[-1][1]
        for (e0, u0), (e1, u1) in zip(pts, pts[1:]):
            if e0 <= elems <= e1:
                t = (math.log(elems) - math.log(e0)) / (
                    math.log(e1) - math.log(e0))
                return math.exp(math.log(u0) * (1 - t) + math.log(u1) * t)
        return None  # pragma: no cover


@functools.lru_cache(maxsize=8)
def _load_measured(path: str) -> Optional[MeasuredTable]:
    try:
        with open(path) as f:
            data = json.load(f)
        tbl = MeasuredTable(data.get('results', ()))
        return tbl if len(tbl) else None
    except (OSError, ValueError, KeyError, TypeError):
        return None


def measured_table(path: Optional[str] = None) -> Optional[MeasuredTable]:
    """The active measured table: explicit ``path``, else
    ``REPRO_TORCH_MEASURED_COSTS`` ('' disables), else the repo root's
    ``BENCH_torch_redistribute.json``. None when nothing usable exists."""
    if path is None:
        path = os.environ.get(MEASURED_ENV)
        if path == '':
            return None
        if path is None:
            path = _default_measured_path()
    return _load_measured(os.path.abspath(path))


def _resolve_measured(measured):
    """'auto' -> the default table; None -> disabled; else as given."""
    return measured_table() if measured == 'auto' else measured


# ---------------------------------------------------------------------------
# Step-by-step plan costing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepCost:
    kind: str                 # 'fft' | 'rfft' | 'swap' | 'gather'
    detail: str
    cycles: float
    swap: Optional[wm.SwapCost] = None


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Predicted cycles for one direction of a distributed FFT plan."""
    steps: Tuple[StepCost, ...]
    strategy: str
    method: str
    precision: wm.Precision
    overlap_chunks: int = 1
    wire_dtype: str = 'native'
    kernel: str = 'reference'

    @property
    def serial_cycles(self) -> float:
        return sum(s.cycles for s in self.steps)

    @property
    def wire_cycles(self) -> float:
        """Cycles of inter-device data movement (swaps and any boundary
        gather)."""
        return sum(s.cycles for s in self.steps
                   if s.kind in ('swap', 'gather'))

    def overlapped_steps(self) -> Tuple[int, ...]:
        """Indices of steps inside a compute/comm overlap pair: every
        adjacent (fft|rfft, swap) pair the executor pipelines."""
        out, i, steps = [], 0, self.steps
        while i < len(steps):
            nxt = steps[i + 1] if i + 1 < len(steps) else None
            if (steps[i].kind in ('fft', 'rfft') and nxt is not None
                    and nxt.kind == 'swap'):
                out += [i, i + 1]
                i += 2
                continue
            i += 1
        return tuple(out)

    @property
    def cycles(self) -> float:
        """Total with the overlap pipeline applied to every paired step:
        (Tf+Ts)/c + (c-1)/c * max(Tf, Ts) + c * overhead a pair."""
        c = self.overlap_chunks
        if c <= 1:
            return self.serial_cycles
        total, i, steps = 0.0, 0, self.steps
        paired = set(self.overlapped_steps())
        while i < len(steps):
            s = steps[i]
            if i in paired:
                tf, ts = s.cycles, steps[i + 1].cycles
                total += ((tf + ts) / c + (c - 1) / c * max(tf, ts)
                          + c * OVERLAP_CHUNK_OVERHEAD)
                i += 2
                continue
            total += s.cycles
            i += 1
        return total

    def runtime_us(self) -> float:
        """:attr:`cycles` at the CS-2 clock (not a GPU time)."""
        return wm.runtime_us(self.cycles)

    # -- serving throughput model (batched request coalescing) --------------

    def pipeline_cycles(self, batch: int,
                        overlap_chunks: Optional[int] = None) -> float:
        """Cycles for ``batch`` coalesced requests run as one call
        pipelined over ``overlap_chunks`` chunks of the request axis
        (default: one a request)."""
        b = max(int(batch), 1)
        c = b if overlap_chunks is None else max(int(overlap_chunks), 1)
        c = min(c, b)
        w = self.wire_cycles
        comp = self.serial_cycles - w
        if c <= 1:
            return b * self.serial_cycles
        return (b * (comp + w) / c + (c - 1) / c * b * max(comp, w)
                + c * OVERLAP_CHUNK_OVERHEAD)

    def pipeline_us(self, batch: int,
                    overlap_chunks: Optional[int] = None) -> float:
        """Steady-state CS-2 microseconds per request of a coalesced batch."""
        return wm.runtime_us(self.pipeline_cycles(batch, overlap_chunks)
                             / max(int(batch), 1))

    def pipeline_latency_us(self, batch: int,
                            overlap_chunks: Optional[int] = None) -> float:
        """CS-2 microseconds for the whole coalesced batch."""
        return wm.runtime_us(self.pipeline_cycles(batch, overlap_chunks))


def _local_shape(shape: Sequence[int], layout: Layout,
                 mesh_shape: Mapping[str, int]) -> Tuple[int, ...]:
    return tuple(s // strat.static_group_size(o, mesh_shape)
                 for s, o in zip(shape, layout))


def _fft_step(n_ax: int, axis: int, elems: int, method: str,
              precision: wm.Precision, *, kernel: str = 'reference',
              backend: str = 'wse') -> StepCost:
    pencils = elems // n_ax
    meth = select_method(n_ax, precision) if method == 'auto' else method
    cyc = pencils * wm.pencil_cycles_backend(n_ax, precision, meth,
                                             backend=backend, kernel=kernel)
    return StepCost('fft',
                    f'n={n_ax} axis={axis} x{pencils} ({meth}/{kernel})', cyc)


def _swap_step(mesh_axis, mesh_shape, elems: float, strategy: str,
               precision: wm.Precision,
               measured: Optional[MeasuredTable] = None, *,
               measured_arrays: int = 2,
               measured_elems: Optional[float] = None,
               measured_dtype: Optional[str] = None,
               wire_dtype: str = 'native',
               axis_bw: Optional[Mapping[str, float]] = None) -> StepCost:
    """One swap of ``elems`` local complex elements: from the measured
    table where it has the (mesh, group, strategy), as ``measured_arrays``
    arrays of ``measured_elems``; else the strategy's analytic cost, a
    16-bit wire at the paper's FP16 rate."""
    ax = '*'.join(strat.axis_tuple(mesh_axis))
    wire = '' if wire_dtype == 'native' else f' wire={wire_dtype}'
    if measured is not None:
        if measured_dtype is None:
            measured_dtype = WIRE_MEASURED_DTYPE.get(
                wire_dtype, PRECISION_WIRE_DTYPE.get(precision, 'c64'))
        us = measured.swap_us(strategy, mesh_shape, mesh_axis,
                              elems if measured_elems is None
                              else measured_elems, dtype=measured_dtype)
        if us is not None:
            cyc = measured_arrays * us * (wm.CLOCK_HZ / 1e6)
            p = strat.static_group_size(mesh_axis, mesh_shape)
            sc = wm.SwapCost(strategy, p, elems, cyc, 0.0)
            return StepCost('swap',
                            f'{ax} p={p} ({strategy}, measured){wire}',
                            cyc, sc)
    eff = 'fp16' if wire_dtype in WIRE_MEASURED_DTYPE else precision
    sc = strat.get(strategy).cost(mesh_axis, mesh_shape, elems, eff,
                                  axis_bw=axis_bw)
    return StepCost('swap', f'{ax} p={sc.p} ({sc.strategy}){wire}',
                    sc.cycles, sc)


def _rfft_step(n_ax: int, axis: int, elems: int, method: str,
               precision: wm.Precision, *, kernel: str = 'reference',
               backend: str = 'wse') -> StepCost:
    pencils = elems // n_ax
    meth = (select_method(max(n_ax // 2, 1), precision)
            if method == 'auto' else method)
    # the complex half pencil takes the tier's weights; the O(n)
    # Hermitian combine does not
    half = max(n_ax // 2, 1)
    cyc = pencils * (wm.pencil_cycles_backend(half, precision, meth,
                                              backend=backend, kernel=kernel)
                     + wm.RFFT_COMBINE_CPE * n_ax)
    return StepCost('rfft',
                    f'n={n_ax} axis={axis} x{pencils} ({meth}/{kernel}, r2c)',
                    cyc)


def pencil_plan_cost(shape: Sequence[int], layout: Layout,
                     mesh_shape: Mapping[str, int], *,
                     precision: wm.Precision = 'fp32',
                     method: str = 'auto', strategy: str = 'all_to_all',
                     overlap_chunks: int = 1, real: bool = False,
                     padded_spectrum: bool = True,
                     measured='auto', wire_dtype: str = 'native',
                     kernel: str = 'reference', backend: str = 'wse',
                     axis_bw: Optional[Mapping[str, float]] = None
                     ) -> PlanCost:
    """Cost the rank-2/3 pencil schedule (``forward_schedule``) step by
    step. Real plans halve every count after the r2c superstep truncates
    the last axis to its (padded) half spectrum; ``padded_spectrum=False``
    adds the np-layout boundary 'gather' of the truncated axis.
    ``measured='auto'`` prefers the port's measured swap table where it
    has data."""
    from repro_torch.fft import pencil as _pencil   # lazy: import cycle
    tbl = _resolve_measured(measured)
    ra = len(shape) - 1 if real else None
    steps_sym, final_lay = _pencil.forward_schedule(tuple(layout), ra)
    p_total = 1
    for o in layout:
        p_total *= strat.static_group_size(o, mesh_shape)
    cur = list(shape)
    out = []
    for step in steps_sym:
        elems = math.prod(cur) // p_total
        if step[0] == 'fft':
            if real and step[1] == ra:
                out.append(_rfft_step(cur[ra], ra, elems, method, precision,
                                      kernel=kernel, backend=backend))
                cur[ra] = _pencil.real_padded_extent(shape, layout,
                                                     mesh_shape)
            else:
                out.append(_fft_step(cur[step[1]], step[1], elems, method,
                                     precision, kernel=kernel,
                                     backend=backend))
        else:
            out.append(_swap_step(step[1], mesh_shape, elems, strategy,
                                  precision, tbl, wire_dtype=wire_dtype,
                                  axis_bw=axis_bw))
    if real and not padded_spectrum and final_lay[ra] is not None:
        # the boundary all-gather of the truncated axis (np layout)
        p = strat.static_group_size(final_lay[ra], mesh_shape)
        elems = math.prod(cur) // p_total
        ax = '*'.join(strat.axis_tuple(final_lay[ra]))
        out.append(StepCost(
            'gather', f'{ax} p={p} x{elems} (np-layout boundary)',
            wm.swap_cycles_a2a(p, elems, precision)))
    return PlanCost(tuple(out), strategy, method, precision, overlap_chunks,
                    wire_dtype, kernel)


# ---------------------------------------------------------------------------
# Overlap feasibility (mirror of the executor's chunk-axis rule)
# ---------------------------------------------------------------------------

def feasible_overlap(shape: Sequence[int], layout: Layout,
                     mesh_shape: Mapping[str, int], *,
                     real: bool = False) -> Tuple[int, ...]:
    """Chunk counts for which every (fft, swap) pair the executor would
    pipeline has a free local axis to chunk over. A real plan's r2c pair
    chunks a free axis of the REAL input (not the real axis, not the
    swap's shard axis); pairs after it see the padded half spectrum."""
    from repro_torch.fft import pencil as _pencil   # lazy: import cycle
    ra = len(shape) - 1 if real else None
    steps, _ = _pencil.forward_schedule(tuple(layout), ra)
    lay = tuple(layout)
    cur = list(shape)
    pair_axes = []
    i = 0
    while i < len(steps):
        step = steps[i]
        nxt = steps[i + 1] if i + 1 < len(steps) else None
        if step[0] == 'fft' and real and step[1] == ra:
            if nxt is not None and nxt[0] == 'swap':
                _, mesh_axis, mem_pos = nxt
                sp = planlib.owner_pos(lay, mesh_axis)
                local = _local_shape(cur, lay, mesh_shape)
                pair_axes.append(tuple(
                    local[p] for p in range(len(lay))
                    if p not in (mem_pos, sp, ra)))
                cur[ra] = _pencil.real_padded_extent(shape, layout,
                                                     mesh_shape)
                lay = planlib.swap(lay, nxt[1], nxt[2])
                i += 2
                continue
            cur[ra] = _pencil.real_padded_extent(shape, layout, mesh_shape)
        elif step[0] == 'fft' and nxt is not None and nxt[0] == 'swap':
            _, mesh_axis, mem_pos = nxt
            sp = planlib.owner_pos(lay, mesh_axis)
            local = _local_shape(cur, lay, mesh_shape)
            pair_axes.append(tuple(
                local[p] for p in range(len(lay))
                if p not in (mem_pos, sp, step[1])))
            lay = planlib.swap(lay, mesh_axis, mem_pos)
            i += 2
            continue
        elif step[0] == 'swap':
            lay = planlib.swap(lay, step[1], step[2])
        i += 1
    ok = []
    for c in _OVERLAP_CANDIDATES:
        if all(any(s % c == 0 and s >= c for s in sizes)
               for sizes in pair_axes):
            ok.append(c)
    return tuple(ok) or (1,)


# ---------------------------------------------------------------------------
# The selector
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Selection:
    strategy: str
    overlap_chunks: int
    method: str
    costs: Dict[str, PlanCost]        # strategy name -> best-overlap cost

    @property
    def cost(self) -> PlanCost:
        return self.costs[self.strategy]


def _tree_candidates(mesh_shape: Mapping[str, int], measured,
                     pod_trees: Optional[bool],
                     max_depth: int = POD_TREE_MAX_DEPTH) -> Tuple[str, ...]:
    """Pod-tree names the selector considers: by default those with
    measured rows on this mesh; ``pod_trees=True`` the full bounded
    search; ``False`` none."""
    if pod_trees is False:
        return ()
    if pod_trees:
        return enumerate_trees(tuple(mesh_shape), mesh_shape,
                               max_depth=max_depth)
    tbl = _resolve_measured(measured)
    if tbl is None:
        return ()
    return tuple(s for s in tbl.strategies_for(mesh_shape)
                 if s.startswith(strat.POD_TREE_PREFIX))


def select(shape: Sequence[int], layout: Layout,
           mesh_shape: Mapping[str, int], *,
           precision: wm.Precision = 'fp32', method: str = 'auto',
           strategies: Optional[Sequence[str]] = None,
           real: bool = False, measured='auto',
           wire_dtype: str = 'native',
           axis_bw: Optional[Mapping[str, float]] = None,
           pod_trees: Optional[bool] = None) -> Selection:
    """Pick (strategy, overlap_chunks, method) minimising the predicted
    cycles of the pencil schedule of ``shape``/``layout``.

    The method is resolved per transform axis by :func:`select_method`
    and named only when every axis agrees. The candidates are every
    registered strategy, runnable in the port or not, and the pod trees
    of :func:`_tree_candidates`: the pick is the reference's, and a plan
    whose pick the port cannot run raises (``strategies.check_runnable``)."""
    if method == 'auto':
        # real plans spend the last axis's flops on a length-n/2 pencil
        lens = (tuple(shape[:-1]) + (max(shape[-1] // 2, 1),)
                if real else tuple(shape))
        picks = {select_method(n, precision) for n in lens}
        method = picks.pop() if len(picks) == 1 else 'auto'
    chunk_opts = feasible_overlap(shape, layout, mesh_shape, real=real)
    if strategies is None:
        cand = list(strat.names())
        cand += [t for t in _tree_candidates(mesh_shape, measured, pod_trees)
                 if t not in cand]
    else:
        cand = list(strategies)
    costs: Dict[str, PlanCost] = {}
    for name in cand:
        best = None
        for c in chunk_opts:
            pc = pencil_plan_cost(shape, layout, mesh_shape,
                                  precision=precision, method=method,
                                  strategy=name, overlap_chunks=c,
                                  real=real, measured=measured,
                                  wire_dtype=wire_dtype, axis_bw=axis_bw)
            if best is None or pc.cycles < best.cycles:
                best = pc
        costs[name] = best
    winner = min(costs, key=lambda k: costs[k].cycles)
    return Selection(winner, costs[winner].overlap_chunks, method, costs)


# ---------------------------------------------------------------------------
# Report formatting (FFT.cost_report)
# ---------------------------------------------------------------------------

def format_report(pc: PlanCost, shape: Sequence[int],
                  mesh_shape: Mapping[str, int]) -> str:
    """The per-step table, the reference's text line for line, with the
    paper's Table-1 model and measured cycles where the configuration is
    an n^3 cube the paper measured. Its "predicted runtime" is CS-2
    microseconds."""
    shape = tuple(shape)
    lines = [
        f"cost_report shape={tuple(shape)} mesh={dict(mesh_shape)} "
        f"strategy={pc.strategy} method={pc.method} "
        f"precision={pc.precision} overlap_chunks={pc.overlap_chunks} "
        f"wire_dtype={pc.wire_dtype} kernel={pc.kernel}",
        f"{'step':>4}  {'kind':<8} {'detail':<34} {'cycles':>14}",
    ]
    if pc.strategy.startswith(strat.POD_TREE_PREFIX):
        tree = strat.parse_tree_spec(pc.strategy[len(strat.POD_TREE_PREFIX):])
        fac = '  '.join(
            f"{a}: {mesh_shape.get(a, '?')} -> "
            + 'x'.join(str(f) for f in fs) for a, fs in sorted(tree.items()))
        lines.insert(1, f"      pod tree: {fac}")
    native_comp = 8 if PRECISION_WIRE_DTYPE.get(pc.precision) == 'c128' else 4
    comp_bytes = strat.wire_elem_bytes(pc.wire_dtype, native_comp)
    paired = set(pc.overlapped_steps())
    for i, s in enumerate(pc.steps):
        mark = '  ~ovl' if (pc.overlap_chunks > 1 and i in paired) else ''
        if s.kind == 'swap' and s.swap is not None:
            # planar complex pair: 2 component arrays on the wire
            wb = 2 * s.swap.elems * comp_bytes
            mark = f'  {wb / 1024.0:>8.1f} KiB/dev wire' + mark
        lines.append(f"{i:>4}  {s.kind:<8} {s.detail:<34} "
                     f"{s.cycles:>14.0f}{mark}")
    lines.append(f"{'':>4}  {'total':<8} {'(serial)':<34} "
                 f"{pc.serial_cycles:>14.0f}")
    if pc.overlap_chunks > 1:
        lines.append(f"{'':>4}  {'total':<8} "
                     f"{f'(pipelined x{pc.overlap_chunks})':<34} "
                     f"{pc.cycles:>14.0f}")
        lines.append("      ~ovl: inside a compute/comm overlap pair "
                     "(r2c joins via split-combine)")
    lines.append(f"      predicted runtime: {pc.runtime_us():.1f} us "
                 f"@ {wm.CLOCK_HZ / 1e6:.0f} MHz")
    n = shape[0]
    cube = len(shape) == 3 and shape == (n,) * 3
    if cube and n in wm.TABLE1_CYCLES:
        sizes = list(mesh_shape.values())
        m = n // sizes[0] if sizes and n % sizes[0] == 0 else 0
        if m and all(n // s == m for s in sizes):
            model = wm.total_cycles_model(n, m, pc.precision)
            lines.append(f"      wse_model total_cycles_model(n={n}, m={m}):"
                         f" {model:.0f} cycles")
            if m == 1:
                meas = wm.TABLE1_CYCLES[n][pc.precision]
                lines.append(
                    f"      paper Table 1 measured ({pc.precision}): {meas} "
                    f"cycles = {wm.runtime_us(meas):.1f} us "
                    f"(model/measured = {pc.serial_cycles / meas:.2f})")
    return "\n".join(lines)
