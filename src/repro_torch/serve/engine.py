"""Batched language-model serving: prefill a prompt batch once, then
greedy-decode token by token.

Port of ``repro.serve.engine.ServeEngine``. The reference jits its
prefill and decode steps with sharded caches and donates the caches to
the decode step; here both steps run eagerly on the mesh's device
(``cuda`` unless the caller built a CPU mesh), and the decode step
updates the caches in place. The caches keep the dtype the prefill
computes them in (fp32 for fp32 parameters), as the reference's do.

A prompt batch is ``{'tokens': (B, S) int}`` or, for an embeds-mode
config (qwen2-vl-2b), ``{'embeds': (B, S, d_model)}``, with M-RoPE's
``'positions'`` (3, B, S) where the config has them (default ``arange``
in each stream); decode continues in text either way. A local-attention
config (recurrentgemma-9b) keeps a ring cache of its window, so a
prompt may be longer than the window and decode wraps the ring.

On a ('data', 'model') mesh of several ranks (one process a rank) the
steps are the reference's ``make_prefill_step`` / ``make_decode_step``
under the serve rules, run eagerly: every rank takes the whole prompt
batch and tokens, computes on its batch block (over 'data') with its
parameter blocks (tensor-parallel over 'model', the MoE feed-forward
expert-parallel), keeps its blocks of the caches (``cache_shardings``:
the port's heads layout, ``models.model.cache_axes``), and returns the
whole logits (gathered over 'model' and 'data'). ``generate`` therefore
returns the whole (B, steps) tokens on every rank; a distributed argmax
over the gathered logits breaks ties by the lowest index, as
``torch.argmax``. On a 1 x 1 mesh every spec is the whole leaf and no
collective runs.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import comm
from repro_torch.configs import ShapeSpec, input_specs
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.parallel.sharding import (local_block, make_rules, named_sharding,
                                           tree_specs)


def cache_shardings(cfg, rules, B: int, cap: int):
    """(the caches' ``named_sharding`` tree in the port's layout, the
    whole caches on the ``meta`` device)."""
    c_abs = M.abstract_cache(cfg, B, cap)
    return tree_specs(rules, c_abs, M.cache_axes(cfg, B, cap)), c_abs


def _shape(s):
    return tuple(getattr(s, 'shape', s))


def _batch_block(batch: Dict[str, torch.Tensor], b_sh: Dict, mesh) -> Dict[str, torch.Tensor]:
    return {k: local_block(v, b_sh[k][1], mesh) for k, v in batch.items()}


def _whole_batch(logits: torch.Tensor, spec, mesh) -> torch.Tensor:
    """Every data row's logits: gathered over the batch's mesh axes."""
    return logits if not spec or spec[0] is None else comm.all_gather(logits, mesh, spec[0], 0)


def make_prefill_step(cfg, mesh, batch_shapes: Dict, batch_axes: Dict, *,
                      cache_cap: Optional[int] = None, sp: bool = False):
    """The prefill step, eager: ``(params, batch) -> (whole last-token
    logits (B, 1, V) fp32, this rank's caches)``, with ``params`` this
    rank's blocks and ``batch`` the whole prompt batch, which it cuts by
    the batch's specs. ``batch_shapes``: each input's shape (or a tensor
    of it, e.g. ``configs.input_specs``'s); ``batch_axes``: its logical
    axes. Returns (step, the specs: p_sh, b_sh, c_sh, rules)."""
    rules = make_rules(mesh, mode='serve')
    p_sh = tree_specs(rules, M.abstract_params(cfg), M.param_axes(cfg))
    b_sh = {k: named_sharding(rules, _shape(v), batch_axes[k]) for k, v in batch_shapes.items()}
    lead = _shape(batch_shapes.get('tokens', batch_shapes.get('embeds')))
    B, S = lead[0], lead[1]
    cap = cache_cap or S
    c_sh, _ = cache_shardings(cfg, rules, B, cap)
    lead_spec = b_sh['tokens' if 'tokens' in b_sh else 'embeds'][1]

    @torch.inference_mode()
    def prefill(params, batch):
        logits, caches = M.prefill(params, cfg, _batch_block(batch, b_sh, mesh), cache_cap=cap,
                                   rules=rules, sp=sp)
        return _whole_batch(logits, lead_spec, mesh), caches
    return prefill, dict(p_sh=p_sh, b_sh=b_sh, c_sh=c_sh, rules=rules)


def make_decode_step(cfg, mesh, *, batch: int, cache_cap: int):
    """The single-token decode step, eager: ``(params, caches, tokens,
    cache_len) -> (whole logits (B, 1, V) fp32, caches)``, ``tokens`` the
    whole (B, 1) batch; updates this rank's caches in place (the
    reference donates them). Returns (step, the specs: caches, p_sh,
    c_sh, rules)."""
    rules = make_rules(mesh, mode='serve')
    p_sh = tree_specs(rules, M.abstract_params(cfg), M.param_axes(cfg))
    c_sh, c_abs = cache_shardings(cfg, rules, batch, cache_cap)
    t_sh = named_sharding(rules, (batch, 1), ('batch', None))

    @torch.inference_mode()
    def decode(params, caches, tokens, cache_len: int):
        logits, caches = M.decode_step(params, cfg, caches, local_block(tokens, t_sh[1], mesh),
                                       int(cache_len), rules=rules)
        return _whole_batch(logits, t_sh[1], mesh), caches
    return decode, dict(caches=c_abs, p_sh=p_sh, c_sh=c_sh, rules=rules)


class ServeEngine:
    """Minimal batched-request engine: prefill a prompt batch once, then
    greedy-decode ``steps - 1`` more tokens. ``params``: this rank's
    blocks (``weights.shard_params``; whole on a 1 x 1 mesh).

        with ServeEngine(cfg, make_host_mesh(1, 1), params, batch=8,
                         prompt_len=2048, max_len=2112) as eng:
            tokens = eng.generate({'tokens': prompts}, 64)   # (8, 64) int32
    """

    def __init__(self, cfg, mesh, params, *, batch: int, prompt_len: int, max_len: int):
        if not cfg.causal:
            raise ValueError(f'{cfg.name} is encoder-only: no decode step')
        if max_len < prompt_len:
            raise ValueError(f'max_len {max_len} < prompt_len {prompt_len}')
        self.device = torch.device(mesh.device)
        wrong = {str(t.device) for t in L.tree_leaves(params)
                 if t.device.type != self.device.type}
        if wrong:
            raise ValueError(f'parameters on {sorted(wrong)}, the mesh is on {self.device}')
        self.cfg, self.mesh, self.params = cfg, mesh, params
        self.batch, self.prompt_len, self.max_len = batch, prompt_len, max_len
        specs, axes = input_specs(cfg, ShapeSpec('serve', 'prefill', prompt_len, batch))
        #: the prompt's inputs and their shapes (M-RoPE's positions optional)
        self._inputs = {k: tuple(v.shape) for k, v in specs.items()}
        self._prefill, _ = make_prefill_step(cfg, mesh, specs, axes, cache_cap=max_len)
        self._decode, _ = make_decode_step(cfg, mesh, batch=batch, cache_cap=max_len)

    def _prompt(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The prompt's inputs the config takes, shape-checked, on the device."""
        key = 'embeds' if self.cfg.input_mode == 'embeds' else 'tokens'
        if key not in batch:
            raise ValueError(f'{self.cfg.name} takes {key!r}; the batch holds {sorted(batch)}')
        given = {k: shape for k, shape in self._inputs.items() if k in batch}
        for k, shape in given.items():
            if tuple(batch[k].shape) != shape:
                raise ValueError(f'{k} of shape {tuple(batch[k].shape)}, the engine serves '
                                 f'{shape}')
        return {k: batch[k].to(self.device) for k in given}

    def prefill(self, batch: Dict[str, torch.Tensor]):
        """(whole last-token logits (B, 1, V) fp32, this rank's caches of
        ``max_len`` positions)."""
        return self._prefill(self.params, self._prompt(batch))

    def decode(self, caches, tokens: torch.Tensor, pos: int):
        """One greedy step at position ``pos`` for the whole (B, 1)
        ``tokens``; updates ``caches`` in place."""
        return self._decode(self.params, caches, tokens.to(self.device), pos)

    def generate(self, batch: Dict[str, torch.Tensor], steps: int) -> torch.Tensor:
        """(B, steps) int32 tokens: the prompt's greedy continuation."""
        if self.prompt_len + steps - 1 > self.max_len:
            raise ValueError(f'{steps} tokens after a prompt of {self.prompt_len} need a '
                             f'cache of {self.prompt_len + steps - 1}, over max_len '
                             f'{self.max_len}')
        logits, caches = self.prefill(batch)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out = [tok]
        for pos in range(self.prompt_len, self.prompt_len + steps - 1):
            logits, caches = self.decode(caches, tok, pos)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1)

    def close(self) -> None:
        """Release engine resources: the engine holds no threads or
        caches between calls, so there is nothing to release; it exists so
        launchers treat every engine uniformly (``FFTEngine.close()``)."""

    def __enter__(self) -> 'ServeEngine':
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
