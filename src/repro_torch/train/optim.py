"""AdamW with mixed precision, in place.

Port of ``repro.train.optim``. The state tree is the reference's,
``{'step', 'master', 'm', 'v'}``: an fp32 master copy of every
parameter (a copy even for fp32 parameters) and fp32 first and second
moments, so a checkpoint holds the reference's leaves in its order.

Two deliberate differences:

* The update is in place, under ``torch.no_grad()``: the reference
  returns new arrays (and donates the old ones to its jitted step); at
  full width a functional update would hold the 30 GB of state twice.
  :func:`adamw_update` writes master, m and v, and the parameters when
  it is given them.
* ``step`` is a 0-d int32 tensor on the host: the schedule and the bias
  corrections are host arithmetic, and a counter on the device would
  cost a synchronisation a step to read.

On a mesh every rank updates its own blocks (the state is cut as the
parameters are, ``opt_axes``); only the clip scale needs the whole
tree, from the mesh-wide norm that the caller passes as ``norm``
(``parallel.global_norm``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_map


def adamw_init(params) -> Dict[str, Any]:
    f32 = lambda t: tree_map(lambda x: x.detach().to(torch.float32, copy=True), t)
    zeros = lambda t: tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                     device=x.device), t)
    return {'step': torch.zeros((), dtype=torch.int32), 'master': f32(params),
            'm': zeros(params), 'v': zeros(params)}


def abstract_opt(abstract_params) -> Dict[str, Any]:
    """The state's shapes and dtypes on the ``meta`` device."""
    meta = lambda t: tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32,
                                                    device='meta'), t)
    return {'step': torch.empty((), dtype=torch.int32, device='meta'),
            'master': meta(abstract_params), 'm': meta(abstract_params),
            'v': meta(abstract_params)}


def opt_axes(params_axes) -> Dict[str, Any]:
    """Optimizer state logical axes = parameter axes, replicated step."""
    return {'step': (), 'master': params_axes, 'm': params_axes, 'v': params_axes}


@torch.no_grad()
def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares + 1e-12) in fp32, the leaves summed one after
    another in sorted-key order, as the reference's Python ``sum``
    over ``jax.tree.leaves``."""
    total = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total + 1e-12)


@torch.no_grad()
def adamw_update(grads, opt_state, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0, param_dtype=torch.bfloat16,
                 params=None, norm: Optional[Callable] = None
                 ) -> Tuple[Any, Dict[str, Any], torch.Tensor]:
    """One AdamW step. ``grads`` may be bf16 (they are upcast here) and
    are not written. Updates ``opt_state`` in place and, if given,
    ``params`` (copied from the new master, cast to their dtype); else
    the new parameters are fresh ``param_dtype`` tensors. ``norm``: the
    clip norm of ``grads`` (default :func:`global_norm`; on a mesh,
    where ``grads`` are this rank's blocks, the mesh-wide norm). Returns
    (params, opt_state, grad_norm); grad_norm is 0 without clipping."""
    opt_state['step'] += 1
    t = np.float32(int(opt_state['step']))
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    lr = float(lr)
    flat_g = tree_leaves(grads)
    if grad_clip is not None:
        gnorm = (norm or global_norm)(grads)
        scale = torch.clamp(grad_clip / gnorm, max=1.0)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=flat_g[0].device)
        scale = None
    out = tree_leaves(params) if params is not None else None
    for i, (g, m, v, p) in enumerate(zip(flat_g, tree_leaves(opt_state['m']),
                                         tree_leaves(opt_state['v']),
                                         tree_leaves(opt_state['master']))):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        del g
        u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        u.add_(weight_decay * p)
        p.sub_(u.mul_(lr))
        del u
        if out is not None:
            out[i].copy_(p)
    if params is None:
        params = tree_map(lambda p: p.to(param_dtype, copy=True), opt_state['master'])
    return params, opt_state, gnorm
