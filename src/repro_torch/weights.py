"""The port's operands from the reference's numpy data.

This system has no weights: its state is the planar operand and the
host-baked tables, which each module builds itself. What the two
packages must share is the operand, so tests and scripts make it once
with numpy from a seed and hand it to both sides through here.
"""
from __future__ import annotations

import numpy as np
import torch


def from_numpy(x, device='cuda'):
    """numpy operand -> the port's tensors on ``device``.

    A complex array becomes one complex64 tensor; a planar ``(re, im)``
    pair becomes a pair of float32 tensors; a real array becomes one
    float32 tensor."""
    if isinstance(x, (tuple, list)):
        re, im = x
        return (torch.as_tensor(np.asarray(re, dtype=np.float32), device=device),
                torch.as_tensor(np.asarray(im, dtype=np.float32), device=device))
    a = np.asarray(x)
    dtype = np.complex64 if np.iscomplexobj(a) else np.float32
    return torch.as_tensor(a.astype(dtype), device=device)
