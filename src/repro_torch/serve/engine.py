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

The engine serves on a 1 x 1 mesh only: the sharded server (DTensor
placements for ``parallel/sharding.py``) is ROADMAP queue 1 item 11g.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.launch.mesh import require_one_rank
from repro_torch.models import layers as L
from repro_torch.models import model as M


class ServeEngine:
    """Minimal batched-request engine: prefill a prompt batch once, then
    greedy-decode ``steps - 1`` more tokens.

        with ServeEngine(cfg, make_host_mesh(1, 1), params, batch=8,
                         prompt_len=2048, max_len=2112) as eng:
            tokens = eng.generate({'tokens': prompts}, 64)   # (8, 64) int32
    """

    def __init__(self, cfg, mesh, params, *, batch: int, prompt_len: int, max_len: int):
        require_one_rank(mesh.shape, 'ServeEngine')
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

    def _prompt(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The prompt's inputs the config takes, shape-checked, on the device."""
        B, S, cfg = self.batch, self.prompt_len, self.cfg
        key, want = (('embeds', (B, S, cfg.d_model)) if cfg.input_mode == 'embeds'
                     else ('tokens', (B, S)))
        if key not in batch:
            raise ValueError(f'{cfg.name} takes {key!r}; the batch holds {sorted(batch)}')
        shapes = {key: want}
        if cfg.pos_kind == 'mrope' and 'positions' in batch:
            shapes['positions'] = (3, B, S)
        for k, shape in shapes.items():
            if tuple(batch[k].shape) != shape:
                raise ValueError(f'{k} of shape {tuple(batch[k].shape)}, the engine serves '
                                 f'{shape}')
        return {k: batch[k].to(self.device) for k in shapes}

    @torch.inference_mode()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """(last-token logits (B, 1, V) fp32, caches of ``max_len`` positions)."""
        return M.prefill(self.params, self.cfg, self._prompt(batch), cache_cap=self.max_len)

    @torch.inference_mode()
    def decode(self, caches, tokens: torch.Tensor, pos: int):
        """One greedy step at position ``pos``; updates ``caches`` in place."""
        return M.decode_step(self.params, self.cfg, caches, tokens, pos)

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
