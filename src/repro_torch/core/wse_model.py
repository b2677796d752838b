"""The paper's per-pencil cycle model: the part the method choice uses.

Port of ``repro.core.wse_model.pencil_cycles`` and
``pencil_cycles_method``. These are analytic models of the CS-2 PE and
of a matmul unit; they rank local algorithms, they predict no time on
a GPU.
"""
from __future__ import annotations

import math
from typing import Literal

Precision = Literal['fp16', 'fp32']

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
