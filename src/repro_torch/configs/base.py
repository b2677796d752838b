"""ArchConfig: one dataclass covering all 10 architecture families, the
input-shape registry, seeded batches and reduced smoke configs.

Port of ``repro.configs.base``, data only: the fields, ``SHAPES``,
``skip_reason`` and ``smoke_config`` are the reference's, with
``cache_dtype`` a torch dtype. ``make_batch`` draws from numpy given a
seed (the reference draws from ``jax.random``), so a test hands the same
arrays to both packages. ``input_specs`` gives the batch's shapes on the
``meta`` device with their logical axes, for the sharded steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                          # dense|ssm|hybrid|audio|vlm|moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ('attn',)
    # attention
    causal: bool = True
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos_kind: str = 'rope'               # rope|mrope|none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    window: int = 0                      # sliding window (local_attn blocks)
    attn_chunk: int = 1024               # flash KV chunk
    # MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe: bool = False
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    # RG-LRU (griffin)
    lru_width: int = 0
    lru_chunk: int = 256
    # fftconv (example mixer)
    fftconv_len: int = 1024
    # frontends / io
    input_mode: str = 'tokens'           # tokens|embeds (stub frontend)
    embed_scale: bool = False
    tie_embeddings: bool = True          # False = separate LM head
    # numerics / compile discipline
    norm_kind: str = 'rms'               # rms|ln
    norm_eps: float = 1e-6
    act: str = 'silu'
    mlp_gated: bool = True
    remat: bool = True
    cache_dtype: Any = torch.bfloat16
    source: str = ''                     # provenance tag from the assignment


# ---------------------------------------------------------------------------
# Input shapes (one set shared by all 10 LM-family archs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    'train_4k': ShapeSpec('train_4k', 'train', 4096, 256),
    'prefill_32k': ShapeSpec('prefill_32k', 'prefill', 32768, 32),
    'decode_32k': ShapeSpec('decode_32k', 'decode', 32768, 128),
    'long_500k': ShapeSpec('long_500k', 'decode', 524288, 1),
}

SUBQUADRATIC_FAMILIES = ('ssm', 'hybrid')


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """Principled skips of an (arch, shape) cell."""
    if shape.kind == 'decode' and not cfg.causal:
        return 'encoder-only: no decode step'
    if shape.name == 'long_500k' and cfg.family not in SUBQUADRATIC_FAMILIES:
        return 'needs sub-quadratic attention; pure full-attention arch'
    return None


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> Tuple[Dict, Dict]:
    """(the batch's tensors on the ``meta`` device, their logical axes)
    for one (arch, shape) cell, the reference's ``ShapeDtypeStruct``s.

    train:   tokens/embeds + labels (+ mrope positions)
    prefill: tokens/embeds (+ positions)
    decode:  one new token + the 0-d cache length (the caches come from
             ``model.abstract_cache``)."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device='meta')
    batch: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}
    if shape.kind == 'decode':
        batch['tokens'], axes['tokens'] = meta((B, 1), torch.int32), ('batch', None)
        batch['cache_len'], axes['cache_len'] = meta((), torch.int32), ()
        return batch, axes
    if cfg.input_mode == 'embeds':
        batch['embeds'], axes['embeds'] = meta((B, S, cfg.d_model), dtype), ('batch', 'seq', None)
    else:
        batch['tokens'], axes['tokens'] = meta((B, S), torch.int32), ('batch', 'seq')
    if cfg.pos_kind == 'mrope':
        batch['positions'] = meta((3, B, S), torch.int32)
        axes['positions'] = (None, 'batch', 'seq')
    if shape.kind == 'train':
        batch['labels'], axes['labels'] = meta((B, S), torch.int32), ('batch', 'seq')
    return batch, axes


def make_batch(cfg: ArchConfig, *, batch: int, seq: int, seed: int = 0,
               dtype=torch.float32, device='cuda') -> Dict[str, torch.Tensor]:
    """Random batch drawn from ``numpy.random.default_rng(seed)``:
    int32 ``tokens`` (or ``embeds``), mrope ``positions`` and ``labels``."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    if cfg.input_mode == 'embeds':
        out['embeds'] = torch.as_tensor(
            rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32)).to(dtype)
    else:
        out['tokens'] = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32))
    if cfg.pos_kind == 'mrope':
        out['positions'] = torch.arange(seq, dtype=torch.int32)[None, None].expand(
            3, batch, seq)
    out['labels'] = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq),
                                                 dtype=np.int32))
    return {k: v.to(device) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Smoke reduction: same family/pattern/flags, laptop-sized dims
# ---------------------------------------------------------------------------

def smoke_config(cfg: ArchConfig) -> ArchConfig:
    period = len(cfg.block_pattern)
    layers = period + 1 if period > 1 else 2   # exercise the stacked and tail paths
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads else 0,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab_size=256,
        window=16 if cfg.window else 0,
        attn_chunk=32,
        q_lora_rank=24 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_nope_dim=16 if cfg.qk_nope_dim else 0,
        rope_head_dim=8 if cfg.rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        num_experts=8 if cfg.moe else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=2 if cfg.moe else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8,
        ssm_chunk=8,
        lru_width=64 if cfg.lru_width else 0,
        lru_chunk=8,
        fftconv_len=32,
        mrope_sections=(2, 3, 3),
        remat=False,
    )
