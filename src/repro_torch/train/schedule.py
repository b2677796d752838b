"""LR schedules: plain functions of the step.

Port of ``repro.train.schedule``. The reference evaluates the schedule
in float32 on the device; here it is host arithmetic in numpy float32,
the same operations in the same order, and the result is a Python float
(exactly the float32 value).
"""
from __future__ import annotations

import numpy as np


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``."""
    f32 = np.float32
    step = f32(int(step))
    if step < warmup_steps:
        return float(f32(peak_lr) * np.minimum(f32(1.0), (step + f32(1)) / f32(max(warmup_steps, 1))))
    frac = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(peak_lr) * (f32(min_ratio) + f32(1 - min_ratio) * f32(0.5)
                          * (f32(1) + np.cos(f32(np.pi) * frac)))
    return float(cos)
