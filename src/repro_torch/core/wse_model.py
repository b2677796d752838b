"""The paper's closed-form cycle model: the part the cost layer uses.

Port of ``repro.core.wse_model``: the per-pencil cycle models, the
generalised swap models (Eq. 1 and its ring and pod-tree relatives), the
per-backend compute weights and the paper's Table 1. These are analytic
models of the CS-2 wafer (850 MHz PEs, 32-bit links) and of a matmul
unit. They rank schedules exactly as the reference does; they predict
no time on a GPU. A "runtime" here is WSE cycles at the CS-2 clock.

The paper side is here too: the paper's published numbers (``PAPER_*``,
``TABLE2``), its flop counts, the pencil throughput and its asymptotes,
the reconstruction of the measured compute/communication split and the
estimates built on it (Eqs. 8-12: ``et_total_*``), the network and
bisection bandwidths (``router_*``, ``bisection_bw_tbs``,
``comm_lower_bound_2d``) and the Table 1 report the paper scripts print
(``benchmarks/torch_paper_*.py``). Every value is the reference's float
arithmetic, so it is the reference's to the bit. They are cycles, times
and rates of the CS-2 wafer at its clock: none of them is a time or a
rate of this port on a GPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Literal, Tuple

Precision = Literal['fp16', 'fp32']

# ---------------------------------------------------------------------------
# Machine constants (paper §3/§5)
# ---------------------------------------------------------------------------

CLOCK_HZ = 850e6          # CS-2 clock
ROUTER_RECONFIG = 30      # d: cycles to reprogram a router filter chain
WORD_BYTES = 4            # one wavelet = 32 bits


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

#: §5.2 headline: the 512^3 FP32 runtime, microseconds on the CS-2
PAPER_512_FP32_US = 959.0
#: §5.3 measured Tflop/s at n = 512 on the CS-2
PAPER_512_TFLOPS = {'fp32': 18.9, 'fp16': 32.7}
#: §5.4 / Table 2 estimates at n = 1024 (a 512 x 512 submesh)
PAPER_1024_TFLOPS_EST = {'fp32': 22.5, 'fp16': 36.0}
#: §5.1 pencil throughput at the largest measured size: (n, flops/cycle)
PAPER_PENCIL_FLOPS_PER_CYCLE = {'fp16': (4096, 0.89), 'fp32': (2048, 0.57)}
#: §5.1 asymptotes, flops/cycle
PAPER_PENCIL_ASYMPTOTE = {'fp16': 5.0 / 3.0, 'fp32': 5.0 / 6.5}
#: §6.2: bisection bandwidth of a 512 x 512 mesh, TB/s
PAPER_BISECTION_TBS = 3.5
#: §5.3: total router bandwidth at n = 512, PB/s
PAPER_ROUTER_BW_PBS = 0.8

#: the paper's Table 2: (size n, precision, system, Tflop/s) as it quotes them
TABLE2 = [
    (256, '64-bit', 'Takahashi Appro Xtreme-X3', 0.4),
    (256, '64-bit', 'HeFFTe 32-node Summit', 0.5),
    (256, '32-bit', 'wsFFT CS-2', 7.2),
    (256, '16-bit', 'wsFFT CS-2', 11.6),
    (512, '64-bit', 'HeFFTe 64-node Summit', 1.3),
    (512, '32-bit', 'cuFFT DGXA100', 16.0),
    (512, '32-bit', 'wsFFT CS-2', 18.9),
    (512, '16-bit', 'wsFFT CS-2', 32.7),
    (1024, '64-bit', 'HeFFTe 1024-node Summit', 9.0),
    (1024, '32-bit', 'Google FFT TPUv3 pod', 10.9),
    (1024, '32-bit', 'cuFFT DGXA100', 19.0),
    (1024, '32-bit', 'wsFFT CS-2 (est.)', 22.5),
    (1024, '16-bit', 'wsFFT CS-2 (est.)', 36.0),
]


# ---------------------------------------------------------------------------
# Flop counts
# ---------------------------------------------------------------------------

def fft_flops_1d(n: int) -> float:
    """Real-arithmetic flops of a complex-to-complex radix-2 FFT (§1)."""
    return 5.0 * n * math.log2(n)


def fft_flops_3d(n: int) -> float:
    """3 supersteps x n^2 pencils (§5.3: 3 n^2 * 5 n log2 n)."""
    return 3.0 * n * n * fft_flops_1d(n)


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


# ---------------------------------------------------------------------------
# The paper side: pencil throughput, the measured split and Eqs. 8-12
# ---------------------------------------------------------------------------

def pencil_flops_per_cycle(n: int, precision: Precision) -> float:
    return fft_flops_1d(n) / pencil_cycles(n, precision)


def pencil_asymptote(precision: Precision) -> float:
    """§5.1: the n log2 n terms alone give 5/3 = 1.66 (FP16) and 5/6.5 =
    0.77 (FP32) flops a cycle, the flop count's leading coefficient (5)
    over the cycle model's (3 or 6.5)."""
    return 5.0 / (3.0 if precision == 'fp16' else 6.5)


def measured_split(n: int, precision: Precision) -> Tuple[float, float]:
    """(RT_cmpt, RT_comm) of the paper's measured run: compute from the
    §5.1 pencil cycle model, communication the rest of Table 1's total.
    Eqs. 8-12 build on these as the paper builds on its measured phases."""
    total = TABLE1_CYCLES[n][precision]
    cmpt = 3.0 * pencil_cycles(n, precision)
    return cmpt, total - cmpt


def et_total_strong(n: int, m: int, precision: Precision) -> float:
    """Eq. 11: estimated cycles of n^3 on (n/m)^2 PEs from the measured
    m = 1 phases, m * RT_comm + m^2 * RT_cmpt."""
    cmpt, comm = measured_split(n, precision)
    return m * comm + m * m * cmpt


def et_total_1024(precision: Precision) -> float:
    """Eq. 10: ET(1024^3 on 1024^2 PEs) = 4 RT_comm(512) + 3 RT_pencil(1024),
    RT_comm(512) the measured communication of the 512 run (Eq. 2:
    RT_comm(2n) <= 4 RT_comm(n))."""
    _, comm512 = measured_split(512, precision)
    return 4.0 * comm512 + 3.0 * pencil_cycles(1024, precision)


def et_total_1024_strong(m: int, precision: Precision) -> float:
    """1024^3 on a (1024/m)^2 submesh: Eq. 11 on the Eq. 10 phases (the
    paper's 512 x 512 datapoint is m = 2)."""
    _, comm512 = measured_split(512, precision)
    comm1024 = 4.0 * comm512
    cmpt1024 = 3.0 * pencil_cycles(1024, precision)
    return m * comm1024 + m * m * cmpt1024


def tflops(n: int, cycles: float) -> float:
    """Tflop/s at the CS-2 clock of an n^3 transform taking ``cycles``."""
    return fft_flops_3d(n) / (cycles / CLOCK_HZ) / 1e12


# ---------------------------------------------------------------------------
# §5.3 network bandwidth (Fig. 6) and §6 bisection analysis
# ---------------------------------------------------------------------------

def router_bytes_total(n: int, precision: Precision) -> float:
    """Link-bytes of both transposes under broadcast-and-filter (§4.3: a
    wavelet runs to the end of its row, not to its destination). East:
    PE i sends n-1-i elements over n-1-i links each, sum_i (n-1-i)^2 =
    n(n-1)(2n-1)/6 a direction a row; two directions, n rows, two
    transposes."""
    elem_bytes = 4 if precision == 'fp16' else 8   # complex element
    per_row_hops = 2.0 * n * (n - 1) * (2 * n - 1) / 6.0
    return 2.0 * n * per_row_hops * elem_bytes


def router_bw_pbs(n: int, precision: Precision) -> float:
    """Total router bandwidth of the measured n^3 run, PB/s on the CS-2."""
    cycles = TABLE1_CYCLES[n][precision]
    return router_bytes_total(n, precision) / (cycles / CLOCK_HZ) / 1e15


def bisection_bw_tbs(p: int) -> float:
    """§6.2: p words a clock each way across the midline of a p x p mesh."""
    return 2.0 * p * WORD_BYTES * CLOCK_HZ / 1e12


def comm_lower_bound_2d(n: int) -> float:
    """§6.1: bisection-limited cycles to transpose an n^2 array on a
    sqrt(n) x sqrt(n) mesh (FP16): n^2/4 elements each way over sqrt(n)
    links."""
    return (n * n / 4.0) / math.sqrt(n)


# ---------------------------------------------------------------------------
# Model against the paper (the paper scripts print it)
# ---------------------------------------------------------------------------

def table1_report() -> list:
    """One row a Table 1 entry: measured and modelled cycles, the model's
    relative error, and the measured run's microseconds and Tflop/s at
    the CS-2 clock."""
    rows = []
    for n, meas in TABLE1_CYCLES.items():
        for prec in ('fp16', 'fp32'):
            model = total_cycles_model(n, 1, prec)
            err = (model - meas[prec]) / meas[prec]
            rows.append(dict(n=n, precision=prec, measured=meas[prec],
                             model=round(model), rel_err=err,
                             us_measured=runtime_us(meas[prec]),
                             tflops_measured=tflops(n, meas[prec])))
    return rows
