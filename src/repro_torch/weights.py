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
own dtype (bfloat16 as ``ml_dtypes.bfloat16`` on the reference's side).
:func:`opt_from_reference` and :func:`opt_to_reference` carry the
optimizer state ``{'step', 'master', 'm', 'v'}``; the port keeps its
``step`` on the host (``repro_torch.train.optim``).
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
    a = np.asarray(tree)
    if a.dtype.name == 'bfloat16':          # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)          # a copy: the port updates in place


def params_to_reference(params):
    """The port's parameter (or cache) tree as numpy leaves, the layout
    the reference's functions take (``jax.tree.map(jnp.asarray, ...)``).
    A bfloat16 leaf needs ``ml_dtypes`` (which JAX brings)."""
    if isinstance(params, dict):
        return {k: params_to_reference(v) for k, v in params.items()}
    t = params.detach().to('cpu', copy=True)       # a copy: the port updates in place
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def opt_from_reference(opt, device='cuda'):
    """The reference's AdamW state (numpy leaves) as the port's: master,
    m and v on ``device``, step a host int32 tensor."""
    out = {k: params_from_reference(opt[k], device) for k in ('master', 'm', 'v')}
    out['step'] = torch.tensor(int(np.asarray(opt['step'])), dtype=torch.int32)
    return out


def opt_to_reference(opt):
    """The port's AdamW state as the reference's numpy leaves."""
    return {k: params_to_reference(v) for k, v in opt.items()}
