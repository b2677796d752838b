"""The port's operands and model parameters from the reference's numpy data.

The FFT system has no weights: its state is the planar operand and the
host-baked tables, which each module builds itself. What the two
packages must share is the operand, so tests and scripts make it once
with numpy from a seed and hand it to both sides through here
(:func:`from_numpy`).

The language models' parameters are nested dicts laid out as the
reference's parameter tree: layer-stacked along axis 0, linear weights
``(d_in, d_out)`` used as ``x @ w``. :func:`params_from_reference` and
:func:`params_to_reference` carry a tree across, leaf for leaf, in its
own dtype.
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


def params_from_reference(tree, device='cuda'):
    """The reference's parameter (or cache) tree, numpy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree), device=device)


def params_to_reference(params):
    """The port's parameter (or cache) tree as numpy leaves, the layout
    the reference's functions take (``jax.tree.map(jnp.asarray, ...)``)."""
    if isinstance(params, dict):
        return {k: params_to_reference(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
