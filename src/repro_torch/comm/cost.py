"""Cost-model method choice.

Port of ``repro.comm.cost.select_method`` only. The strategy and
overlap selector (``select``) is a later slice; the facade resolves
``comm='auto'`` on a one-device mesh without it (see
``repro_torch.fft.api``).
"""
from __future__ import annotations

from repro_torch.core import wse_model as wm


def select_method(n: int, precision: wm.Precision = 'fp32') -> str:
    """Cheapest of the butterfly and matmul cycle models for a length-n
    pencil (dense DFT for non-pow2 lengths)."""
    if n & (n - 1):
        return 'direct'
    stock = wm.pencil_cycles_method(n, precision, 'stockham')
    mxu = wm.pencil_cycles_method(n, precision, 'four_step')
    return 'stockham' if stock <= mxu else 'four_step'
