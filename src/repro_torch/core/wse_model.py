"""The paper's closed-form cycle model: the part the cost layer uses.

Port of ``repro.core.wse_model``: the per-pencil cycle models, the
generalised swap models (Eq. 1 and its ring and pod-tree relatives), the
per-backend compute weights and the paper's Table 1. These are analytic
models of the CS-2 wafer (850 MHz PEs, 32-bit links) and of a matmul
unit. They rank schedules exactly as the reference does; they predict
no time on a GPU. A "runtime" here is WSE cycles at the CS-2 clock.

The paper-figure helpers (``et_total_*``, ``router_*``,
``bisection_bw_tbs``, ``table1_report``) wait for the benchmarks that use
them (ROADMAP queue 1, 'Examples + benchmarks').
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Literal

Precision = Literal['fp16', 'fp32']

# ---------------------------------------------------------------------------
# Machine constants (paper §3/§5)
# ---------------------------------------------------------------------------

CLOCK_HZ = 850e6          # CS-2 clock
ROUTER_RECONFIG = 30      # d: cycles to reprogram a router filter chain


def r_factor(precision: Precision) -> int:
    """Cycles per complex element on a 32-bit link: FP16 packs (re, im)
    into one wavelet (r=1); FP32 needs two (r=2)."""
    return 1 if precision == 'fp16' else 2


#: the paper's measured Table 1: cycles of one n^3 transform on n x n PEs
TABLE1_CYCLES: Dict[int, Dict[Precision, int]] = {
    32:  {'fp16': 10_953,  'fp32': 13_633},
    64:  {'fp16': 24_000,  'fp32': 32_176},
    128: {'fp16': 56_741,  'fp32': 82_405},
    256: {'fp16': 147_247, 'fp32': 236_329},
    512: {'fp16': 471_064, 'fp32': 815_371},
}


# ---------------------------------------------------------------------------
# Eq. 1 and its generalisations: one ownership swap
# ---------------------------------------------------------------------------

#: per-round launch/synchronisation cost of a pairwise ring round (cycles)
RING_ROUND_OVERHEAD = 512
#: the hierarchical exchange's final local reorder, cycles per complex element
LOCAL_REORDER_CPE = 1.0
#: a fused operator plan's pointwise stage, cycles per complex element
#: per operand pair (one complex multiply)
POINTWISE_CPE = 6.0


def tt_comm(n: int, m: int, precision: Precision) -> float:
    """Eq. 1: cycles for ONE transpose phase, problem n^3 on (n/m)^2 PEs
    (the p = n/m, elems = n*m^2 instance of :func:`swap_cycles_a2a`)."""
    return swap_cycles_a2a(n // m, n * m * m, precision)


def tt_comm_single(n: int, precision: Precision) -> float:
    """Eqs. 3-4 (m = 1)."""
    return tt_comm(n, 1, precision)


@dataclasses.dataclass(frozen=True)
class SwapCost:
    """Predicted cycles for one ownership swap, split into the wire
    (serialised stream) and fixed (reconfigure/launch/reorder) terms."""
    strategy: str
    p: int
    elems: float          # local complex elements exchanged
    wire_cycles: float
    fixed_cycles: float

    @property
    def cycles(self) -> float:
        return self.wire_cycles + self.fixed_cycles


def swap_cycles_a2a(p: int, elems: float, precision: Precision) -> float:
    """Generalised Eq. 1: broadcast-and-filter / all_to_all exchange of
    ``elems`` local complex elements over a group of p devices."""
    if p <= 1:
        return 0.0
    r = r_factor(precision)
    return (p * (p - 1) / 2.0) * (elems / p) * r + ROUTER_RECONFIG * (p - 1)


def swap_cycles_ring(p: int, elems: float, precision: Precision) -> float:
    """Pairwise ring: p-1 rounds of elems/p-element messages; the
    bottleneck link carries about p^2/4 of them, each round pays a
    launch."""
    if p <= 1:
        return 0.0
    r = r_factor(precision)
    return (p * p / 4.0) * (elems / p) * r + RING_ROUND_OVERHEAD * (p - 1)


def swap_cycles_tree(levels, elems: float, precision: Precision) -> float:
    """Multi-phase pod-tree exchange. ``levels`` is a sequence of
    ``(factor, kind, bw)`` phases: ``kind`` 'a2a' (a whole mesh axis) or
    'ring' (a sub-factor), ``bw`` a weight on the wire term. One local
    reorder pass follows when more than one phase ran."""
    total = 0.0
    n_levels = 0
    for f, kind, bw in levels:
        if f <= 1:
            continue
        n_levels += 1
        base = (swap_cycles_ring(f, elems, precision) if kind == 'ring'
                else swap_cycles_a2a(f, elems, precision))
        fixed = (RING_ROUND_OVERHEAD if kind == 'ring'
                 else ROUTER_RECONFIG) * (f - 1)
        total += (base - fixed) * float(bw) + fixed
    if n_levels > 1:
        total += LOCAL_REORDER_CPE * elems
    return total


def swap_cycles_hierarchical(p_outer: int, p_inner: int, elems: float,
                             precision: Precision) -> float:
    """Two-phase pod split: the two-level instance of :func:`swap_cycles_tree`."""
    return swap_cycles_tree(((p_outer, 'a2a', 1.0), (p_inner, 'a2a', 1.0)),
                            elems, precision)


def swap_cost_a2a(p: int, elems: float, precision: Precision, *,
                  strategy: str = 'all_to_all') -> SwapCost:
    total = swap_cycles_a2a(p, elems, precision)
    fixed = ROUTER_RECONFIG * (p - 1) if p > 1 else 0.0
    return SwapCost(strategy, p, elems, total - fixed, fixed)


def swap_cost_ring(p: int, elems: float, precision: Precision, *,
                   strategy: str = 'ppermute') -> SwapCost:
    total = swap_cycles_ring(p, elems, precision)
    fixed = RING_ROUND_OVERHEAD * (p - 1) if p > 1 else 0.0
    return SwapCost(strategy, p, elems, total - fixed, fixed)


def swap_cost_tree(levels, elems: float, precision: Precision, *,
                   strategy: str = 'pod_tree') -> SwapCost:
    """:func:`swap_cycles_tree` split into its wire and fixed terms."""
    total = swap_cycles_tree(levels, elems, precision)
    p = 1
    fixed = 0.0
    n_levels = 0
    for f, kind, _bw in levels:
        if f <= 1:
            continue
        n_levels += 1
        p *= f
        fixed += (RING_ROUND_OVERHEAD if kind == 'ring'
                  else ROUTER_RECONFIG) * (f - 1)
    if n_levels > 1:
        fixed += LOCAL_REORDER_CPE * elems
    return SwapCost(strategy, p, elems, total - fixed, fixed)


def swap_cost_hierarchical(p_outer: int, p_inner: int, elems: float,
                           precision: Precision, *,
                           strategy: str = 'hierarchical') -> SwapCost:
    return swap_cost_tree(((p_outer, 'a2a', 1.0), (p_inner, 'a2a', 1.0)),
                          elems, precision, strategy=strategy)


# ---------------------------------------------------------------------------
# §5.1: pencil (computation) cycle model
# ---------------------------------------------------------------------------

#: matmul-form estimates: sustained real MACs per cycle and the fixed
#: per-pencil setup, calibrated so the model's method choice agrees with
#: the registry's AUTO_MATMUL_MIN = 64 crossover.
MXU_MACS_PER_CYCLE = {'fp16': 16.0, 'fp32': 8.0}
MXU_SETUP_CYCLES = 3000.0


def pencil_cycles(n: int, precision: Precision) -> float:
    """Per-PE cycles for one length-n pencil FFT (the paper's
    assembly-level count: 3n log2 n + 34n + 34 log2 n FP16;
    6.5n log2 n + 35n + 36 log2 n FP32)."""
    lg = math.log2(n)
    if precision == 'fp16':
        return 3.0 * n * lg + 34.0 * n + 34.0 * lg
    return 6.5 * n * lg + 35.0 * n + 36.0 * lg


def pencil_cycles_method(n: int, precision: Precision,
                         method: str = 'stockham') -> float:
    """Per-PE cycles for one length-n pencil under a named local
    algorithm: the butterfly model for 'stockham', the four-step's
    4*n*(n1+n2) real MACs at the matmul rate plus setup for
    'four_step'/'block', and the dense n^2 DFT for 'direct'."""
    if method in ('four_step', 'block'):
        k = max(1, round(math.log2(n)))
        n1 = 1 << ((k + 1) // 2)
        n2 = n // n1
        macs = 4.0 * n * (n1 + n2)
        return macs / MXU_MACS_PER_CYCLE[precision] + MXU_SETUP_CYCLES
    if method == 'direct':
        return 4.0 * n * n / MXU_MACS_PER_CYCLE[precision] + MXU_SETUP_CYCLES
    return pencil_cycles(n, precision)


#: per-backend planning weights relative to the WSE PE ('wse' is the
#: paper's CS-2): throughput multiplier, fixed dispatch cycles per
#: pencil batch, and the penalty of an interpreted kernel tier. Coarse
#: weights that rank tiers, not measurements.
BACKEND_COMPUTE: Dict[str, Dict[str, float]] = {
    'wse': {'scale': 1.0, 'dispatch': 0.0, 'interpret_penalty': 1.0},
    'cpu': {'scale': 8.0, 'dispatch': 2000.0, 'interpret_penalty': 40.0},
    'gpu': {'scale': 0.5, 'dispatch': 5000.0, 'interpret_penalty': 40.0},
    'tpu': {'scale': 0.5, 'dispatch': 4000.0, 'interpret_penalty': 40.0},
}
_BACKEND_ALIASES = {'cuda': 'gpu', 'rocm': 'gpu'}
#: backends whose kernel tier runs compiled kernels
PALLAS_NATIVE_BACKENDS = ('gpu', 'tpu')
#: wire-term discount of the fused twiddle+transpose tier on such a backend
PALLAS_FUSED_SPEEDUP = 0.7


def pencil_cycles_backend(n: int, precision: Precision,
                          method: str = 'stockham', *,
                          backend: str = 'wse',
                          kernel: str = 'reference') -> float:
    """Per-pencil cycles of :func:`pencil_cycles_method` weighted for a
    backend and kernel tier; 'wse'/'reference' is the paper model."""
    bk = _BACKEND_ALIASES.get(backend, backend)
    cfg = BACKEND_COMPUTE.get(bk, BACKEND_COMPUTE['cpu'])
    cyc = pencil_cycles_method(n, precision, method) * cfg['scale']
    if kernel == 'pallas':
        if bk in PALLAS_NATIVE_BACKENDS:
            cyc *= PALLAS_FUSED_SPEEDUP
        else:
            cyc *= cfg['interpret_penalty']
    return cyc + cfg['dispatch']


#: cycles per input element of the rfft Hermitian combine
RFFT_COMBINE_CPE = 5.0


def rfft_pencil_cycles_method(n: int, precision: Precision,
                              method: str = 'stockham') -> float:
    """Per-PE cycles for one length-n REAL pencil: one length-n/2
    complex pencil plus the O(n) combine."""
    return (pencil_cycles_method(max(n // 2, 1), precision, method)
            + RFFT_COMBINE_CPE * n)


def total_cycles_model(n: int, m: int, precision: Precision) -> float:
    """3 compute supersteps (m^2 pencils each) + 2 transposes."""
    return 3.0 * m * m * pencil_cycles(n, precision) + 2.0 * tt_comm(n, m, precision)


def runtime_us(cycles: float) -> float:
    """WSE cycles as microseconds at the CS-2 clock (not a GPU time)."""
    return cycles / CLOCK_HZ * 1e6
