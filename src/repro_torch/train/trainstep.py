"""Train-step factory: loss gradients, microbatch accumulation, AdamW.

Port of ``repro.train.trainstep.make_train_step`` on one rank, for
token and embeds-mode batches (``embeds``, M-RoPE ``positions``). The
global batch is split on its leading axis into ``microbatches`` (the
M-RoPE positions ``(3, B, S)`` on their second), each microbatch's
gradients are added into one fp32 buffer a parameter, then clipped and
applied by :func:`repro_torch.train.optim.adamw_update` at the
:func:`warmup_cosine` learning rate, in place.

The reference constrains gradients to the parameters' shardings and
jits the step with explicit shardings (``jit_train_step``); on one rank
there is nothing to constrain. Sharded training is ROADMAP queue 1 item
11i: a mesh of more than one rank raises here rather than train on one.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.launch.mesh import require_one_rank
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import optim
from repro_torch.train.schedule import warmup_cosine


def split_microbatches(batch: Dict[str, torch.Tensor], microbatches: int):
    """The reference's split: leading axis into ``microbatches`` equal
    parts (a leaf that does not divide is repeated); positions (3, B, S)
    split on B."""
    def part(x, i):
        if x.ndim >= 1 and x.shape[0] % microbatches == 0:
            k = x.shape[0] // microbatches
            return x[i * k:(i + 1) * k]
        return x
    out = [{k: part(v, i) for k, v in batch.items()} for i in range(microbatches)]
    if 'positions' in batch:
        pos = batch['positions']
        k = pos.shape[1] // microbatches
        for i, mb in enumerate(out):
            mb['positions'] = pos[:, i * k:(i + 1) * k]
    return out


def make_train_step(cfg, mesh=None, *, microbatches: int = 1, peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000, sp: bool = False,
                    param_dtype=torch.bfloat16) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, which updates ``params`` and ``opt_state`` in
    place and returns them. ``metrics``: 0-d tensors 'loss', 'ce',
    'aux', 'grad_norm' on the device and the float 'lr'. ``mesh``: the
    ('data', 'model') mesh of :func:`repro_torch.launch.mesh.make_host_mesh`,
    one rank, or None; the FFT-conv mixer plans on it. ``param_dtype``
    is the parameters' dtype: the reference casts the updated master to
    it, the port keeps the parameters' tensors, so it checks instead."""
    if mesh is not None:
        require_one_rank(mesh.shape, 'make_train_step')

    def grads_of(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = M.loss_fn(live, cfg, batch, mesh=mesh, sp=sp)
        # an embeds-mode config's table is unused by the forward (decode
        # reads it): its gradient is zeros, as jax.grad's
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), metrics, grads

    def train_step(params, opt_state, batch):
        dtypes = {t.dtype for t in tree_leaves(params) if t.is_floating_point()}
        if dtypes != {param_dtype}:
            raise ValueError(f'parameters of {sorted(map(str, dtypes))}, param_dtype '
                             f'{param_dtype}: the step updates them in place, in their dtype')
        if microbatches > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            ls, lls, auxs = [], [], []
            for mb in split_microbatches(batch, microbatches):
                loss, metrics, grads = grads_of(params, mb)
                for a, g in zip(acc, grads):
                    a.add_(g.float() / microbatches)
                del grads
                ls.append(loss)
                lls.append(metrics['loss'].detach())
                auxs.append(metrics['aux'].detach())
            grads = acc
            loss, ce, aux = (torch.stack(t).mean() for t in (ls, lls, auxs))
        else:
            loss, metrics, grads = grads_of(params, batch)
            ce, aux = metrics['loss'].detach(), metrics['aux'].detach()
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        lr = warmup_cosine(opt_state['step'], peak_lr=peak_lr, warmup_steps=warmup_steps,
                           total_steps=total_steps)
        params, opt_state, gnorm = optim.adamw_update(
            grads, opt_state, lr=lr, param_dtype=param_dtype, params=params)
        return params, opt_state, {'loss': loss, 'ce': ce, 'aux': aux, 'lr': lr,
                                   'grad_norm': gnorm}
    return train_step
