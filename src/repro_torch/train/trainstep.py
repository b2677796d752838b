"""Train-step factory: loss gradients, microbatch accumulation, AdamW.

Port of ``repro.train.trainstep`` (``make_train_step``,
``batch_shardings``, ``jit_train_step``) on a ('data', 'model') mesh of
any shape, for token and embeds-mode batches (``embeds``, M-RoPE
``positions``). The global batch is split on its leading axis into
``microbatches`` (the M-RoPE positions ``(3, B, S)`` on their second),
each microbatch's gradients are added into one fp32 buffer a parameter,
then clipped and applied by :func:`repro_torch.train.optim.adamw_update`
at the :func:`warmup_cosine` learning rate, in place.

On a mesh of several ranks each rank holds its blocks of the parameters
and optimizer state under the reference's train rules
(``parallel.make_rules(mode='train')``: FSDP over 'data' on every
'embed' dimension, tensor and expert parallel over 'model') and its
block of each microbatch (:func:`repro_torch.data.shard_batch` with
``microbatches``, so a rank's microbatch i is its block of the global
microbatch i, as the reference's). The model code gathers each period's
leaves over 'data' at use and reduce-scatters their gradients in the
backward; the step then sums over 'data' the gradients of the leaves
'data' does not cut (``parallel.reduce_data_parallel``) and clips by the
mesh-wide norm (``parallel.global_norm``). Where the reference jits the
step with these shardings, the port's step is eager: ``jit_train_step``
returns it with the same specs. On a 1 x 1 mesh every operation is the
one-rank step's.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.parallel import (global_norm, make_rules, named_sharding,
                                  reduce_data_parallel, tree_specs)
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


def batch_shardings(rules, batch_sds: Dict, batch_axes: Dict) -> Dict:
    """Each batch leaf's ``(mesh, spec)`` under ``rules`` (``batch_sds``:
    anything with ``.shape``, or shapes)."""
    return {k: named_sharding(rules, getattr(v, 'shape', v), batch_axes[k])
            for k, v in batch_sds.items()}


def _accumulate(acc: torch.Tensor, microbatches: int, t: torch.Tensor) -> None:
    """A microbatch's gradient of one leaf into its fp32 buffer, then
    dropped: the step never holds a second gradient tree. With one
    microbatch the buffer is the gradient, bit for bit."""
    acc.add_(t.grad.float() / microbatches)
    t.grad = None


def make_train_step(cfg, mesh=None, *, microbatches: int = 1, peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000, sp: bool = False,
                    param_dtype=torch.bfloat16) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, which updates ``params`` and ``opt_state`` in
    place and returns them. ``metrics``: 0-d tensors 'loss', 'ce',
    'aux', 'grad_norm' on the device (the global values, the same on
    every rank) and the float 'lr'.

    ``mesh``: a ('data', 'model') mesh of
    :func:`repro_torch.launch.mesh.make_host_mesh` (its train rules cut
    ``params``, ``opt_state`` and ``batch``: this rank's blocks), or
    None (one rank; so is 1 x 1). ``sp``: Ulysses attention over
    'model'. ``param_dtype`` is the parameters' dtype: the reference
    casts the updated master to it, the port keeps the parameters'
    tensors, so it checks instead."""
    rules = None if mesh is None else make_rules(mesh, mode='train')
    sharded = mesh is not None and mesh.size > 1
    plan = M.model_plan(cfg)
    norm = functools.partial(global_norm, plan=plan, rules=rules) if sharded else None

    def accumulated(params, batch):
        """Each microbatch's backward adds each leaf's gradient into its
        fp32 buffer as autograd finishes it (an embeds-mode config's
        table, unused by the forward, keeps zeros, as ``jax.grad`` gives).
        Returns (the buffers, the means of the microbatches' loss, ce and
        aux)."""
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        hooks = [t.register_post_accumulate_grad_hook(
            functools.partial(_accumulate, a, microbatches))
            for t, a in zip(tree_leaves(live), acc)]
        ls, lls, auxs = [], [], []
        try:
            for mb in split_microbatches(batch, microbatches):
                loss, metrics = M.loss_fn(live, cfg, mb, rules=rules, mesh=mesh, sp=sp)
                loss.backward()
                ls.append(loss.detach())
                lls.append(metrics['loss'].detach())
                auxs.append(metrics['aux'].detach())
        finally:
            for h in hooks:
                h.remove()
        return acc, *(torch.stack(t).mean() for t in (ls, lls, auxs))

    def train_step(params, opt_state, batch):
        dtypes = {t.dtype for t in tree_leaves(params) if t.is_floating_point()}
        if dtypes != {param_dtype}:
            raise ValueError(f'parameters of {sorted(map(str, dtypes))}, param_dtype '
                             f'{param_dtype}: the step updates them in place, in their dtype')
        grads, loss, ce, aux = accumulated(params, batch)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        if sharded:
            reduce_data_parallel(grads, plan, rules)
        lr = warmup_cosine(opt_state['step'], peak_lr=peak_lr, warmup_steps=warmup_steps,
                           total_steps=total_steps)
        params, opt_state, gnorm = optim.adamw_update(
            grads, opt_state, lr=lr, param_dtype=param_dtype, params=params, norm=norm)
        return params, opt_state, {'loss': loss, 'ce': ce, 'aux': aux, 'lr': lr,
                                   'grad_norm': gnorm}
    return train_step


def jit_train_step(cfg, mesh, batch_sds: Dict, batch_axes: Dict, *,
                   param_dtype=torch.bfloat16, **kw):
    """The step and its shardings, as the reference's ``jit_train_step``:
    ``(step, aux)`` with ``aux`` holding the parameters' and optimizer
    state's shapes on the ``meta`` device (``params``, ``opt``), the
    ``(mesh, spec)`` trees of the parameters, state and batch (``p_sh``,
    ``o_sh``, ``b_sh``) and the train ``rules``. The step is eager (no
    compilation): ``kw`` go to :func:`make_train_step`."""
    rules = make_rules(mesh, mode='train')
    p_axes = M.param_axes(cfg)
    p_abs = M.abstract_params(cfg, param_dtype)
    o_abs = optim.abstract_opt(p_abs)
    p_sh = tree_specs(rules, p_abs, p_axes)
    o_sh = tree_specs(rules, o_abs, optim.opt_axes(p_axes))
    b_sh = batch_shardings(rules, batch_sds, batch_axes)
    step = make_train_step(cfg, mesh, param_dtype=param_dtype, **kw)
    return step, dict(params=p_abs, opt=o_abs, p_sh=p_sh, o_sh=o_sh, b_sh=b_sh, rules=rules)
