"""Attention: flash-chunked GQA and sliding-window attention for full
sequences, prefill and decode.

Port of the GQA and sliding-window parts of ``repro.models.attention``.
``flash_attention`` is the reference's online-softmax algorithm in plain
PyTorch: an outer loop over ``q_chunk`` query blocks, an inner loop over
``chunk`` KV chunks, fp32 accumulators, GQA through a (kv_heads, group)
head split so repeated KV is never materialized. Every masked block is
computed in full, as in the reference (windowed attention too). The
blocking conditions are the reference's: query blocks only when
``Sq > q_chunk`` and ``q_chunk`` divides ``Sq``, KV chunks only when
``Skv > chunk`` and ``chunk`` divides ``Skv``, else one pass.

Local attention (``window > 0``) keeps a ring cache of the last
``W = min(window, cache_cap)`` keys and values, slot ``pos % W``, with
each slot's absolute position in ``kpos`` (-1: empty); decode writes
the new token at ``cache_len % W`` in place (:func:`gqa_decode_ring`).
M-RoPE configs decode text: all three position streams advance to the
cache length.

Sequence parallelism (``sp=True``, Ulysses) and MLA are not ported yet
(ROADMAP queue 1 items 10, 11e).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.fft1d import full_fp32_matmul
from repro_torch.models import layers as L

NEG_INF = -1e30


def _no_sp(sp: bool) -> None:
    if sp:
        raise NotImplementedError(
            'sequence-parallel (Ulysses) attention is not ported yet: it needs the '
            'comm surface (ROADMAP queue 1 item 10), which goes with training')


# ---------------------------------------------------------------------------
# Core: chunked online-softmax attention (GQA native)
# ---------------------------------------------------------------------------

def _mask(qpos, kpos, *, causal: bool, window: int):
    m = kpos[None, :] >= 0                    # slot -1 = empty (ring cache)
    if causal:
        m = m & (qpos[:, None] >= kpos[None, :])
    if window:
        m = m & (qpos[:, None] - kpos[None, :] < window)
    return m


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    chunk: int = 1024, q_chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KH, D) with KH | H.

    ``q_offset``: global position of q[0] (decode: cache length).
    ``kv_len``: valid length of k/v (decode: keys at or past it are masked).
    ``kv_positions``: explicit (Skv,) absolute positions of the keys (-1:
    an empty slot), the ring cache's; default ``arange(Skv)``.
    Returns (B, Sq, H, D) in q's dtype. Accumulation in fp32.
    """
    B, Sq, H, D = q.shape
    if Sq > q_chunk and Sq % q_chunk == 0:
        return torch.cat([
            flash_attention(q[:, i:i + q_chunk], k, v, causal=causal, window=window,
                            q_offset=q_offset + i, kv_len=kv_len,
                            kv_positions=kv_positions, chunk=chunk, q_chunk=q_chunk)
            for i in range(0, Sq, q_chunk)], dim=1)
    full_fp32_matmul(q.device)
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    out_dtype = q.dtype          # NOT v.dtype: v may be a quantized cache
    q = (q.float() * D ** -0.5).reshape(B, Sq, KH, G, D)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    C = chunk if (Skv > chunk and Skv % chunk == 0) else Skv
    all_kpos = (torch.arange(Skv, device=q.device) if kv_positions is None
                else kv_positions.to(q.device))

    m = torch.full((B, KH, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KH, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KH, G, Sq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Skv, C):
        kc, vc = k[:, c0:c0 + C].float(), v[:, c0:c0 + C].float()
        kpos = all_kpos[c0:c0 + C]
        s = torch.einsum('bqhgd,bkhd->bhgqk', q, kc)
        mask = _mask(qpos, kpos, causal=causal, window=window)
        if kv_len is not None:
            mask = mask & (kpos[None, :] < kv_len)
        s = torch.where(mask, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None])
        corr = torch.exp(m - m_cur)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum('bhgqk,bkhd->bhgqd', p, vc)
        m = m_cur
    out = acc / torch.clamp(l[..., None], min=1e-30)      # (B, KH, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(out_dtype)


# ---------------------------------------------------------------------------
# GQA block (plan + apply)
# ---------------------------------------------------------------------------

def gqa_plan(cfg) -> Dict:
    d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        'wq': L.linear_plan(d, H * hd, ('embed', 'heads'), bias=cfg.qkv_bias),
        'wk': L.linear_plan(d, KH * hd, ('embed', 'kv_heads'), bias=cfg.qkv_bias),
        'wv': L.linear_plan(d, KH * hd, ('embed', 'kv_heads'), bias=cfg.qkv_bias),
        'wo': L.linear_plan(H * hd, d, ('heads', 'embed')),
    }


def gqa_qkv(p: Dict, cfg, x, positions):
    """Project + rope. x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KH,hd)."""
    B, S, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = L.apply_linear(p['wq'], x).reshape(B, S, H, hd)
    k = L.apply_linear(p['wk'], x).reshape(B, S, KH, hd)
    v = L.apply_linear(p['wv'], x).reshape(B, S, KH, hd)
    if cfg.pos_kind == 'mrope':
        q = L.apply_mrope(q, positions, theta=cfg.rope_theta, sections=cfg.mrope_sections)
        k = L.apply_mrope(k, positions, theta=cfg.rope_theta, sections=cfg.mrope_sections)
    elif cfg.pos_kind == 'rope':
        q = L.apply_rope(q, positions, theta=cfg.rope_theta)
        k = L.apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def gqa_apply(p: Dict, cfg, x, positions, *, window: int = 0, sp: bool = False):
    """Full-sequence (train/prefill) GQA attention."""
    _no_sp(sp)
    B, S, _ = x.shape
    q, k, v = gqa_qkv(p, cfg, x, positions)
    o = flash_attention(q, k, v, causal=cfg.causal, window=window, chunk=cfg.attn_chunk)
    return L.apply_linear(p['wo'], o.reshape(B, S, -1))


def gqa_prefill(p: Dict, cfg, x, positions, *, window: int = 0,
                cache_cap: Optional[int] = None, sp: bool = False):
    """Full-sequence attention that also returns the decode cache, k and
    v in their own dtype. Dense (``window`` 0): zero-padded to
    ``cache_cap`` positions. Windowed: the ring cache of the last
    ``W = min(window, cache_cap)`` tokens, slot ``pos % W``, with their
    positions in ``kpos`` (-1 where a prompt shorter than W leaves a slot
    empty)."""
    _no_sp(sp)
    B, S, _ = x.shape
    q, k, v = gqa_qkv(p, cfg, x, positions)
    o = flash_attention(q, k, v, causal=cfg.causal, window=window, chunk=cfg.attn_chunk)
    out = L.apply_linear(p['wo'], o.reshape(B, S, -1))
    if not window:
        pad = (cache_cap or S) - S
        return out, {'k': F.pad(k, (0, 0, 0, 0, 0, pad)), 'v': F.pad(v, (0, 0, 0, 0, 0, pad))}
    W = window if cache_cap is None else min(window, cache_cap)
    if S >= W:
        # positions keep..S-1 in ring order: position keep + j goes to slot
        # (keep + j) % W, a roll of the last W by keep % W (the reference
        # scatters with the inverse permutation: the same slots)
        keep = S - W
        kpos = torch.arange(keep, S, dtype=torch.int32, device=x.device)
        roll = keep % W
        cache = {'k': torch.roll(k[:, keep:], roll, dims=1),
                 'v': torch.roll(v[:, keep:], roll, dims=1),
                 'kpos': torch.roll(kpos, roll, dims=0)}
    else:                          # prefix shorter than the window
        pad = W - S
        cache = {'k': F.pad(k, (0, 0, 0, 0, 0, pad)), 'v': F.pad(v, (0, 0, 0, 0, 0, pad)),
                 'kpos': F.pad(torch.arange(S, dtype=torch.int32, device=x.device), (0, pad),
                               value=-1)}
    return out, cache


def gqa_decode_ring(p: Dict, cfg, x, cache: Dict, cache_len: int, *, window: int):
    """One-token decode against the sliding-window ring cache
    {'k', 'v': (B, W, KH, hd), 'kpos': (W,) int32}.

    Writes the new k, v and position at slot ``cache_len % W`` IN PLACE
    (the reference's engine donates its caches) and returns (out, cache)."""
    B = x.shape[0]
    W = cache['k'].shape[1]
    q, k, v = gqa_qkv(p, cfg, x, torch.full((B, 1), cache_len, device=x.device))
    slot = cache_len % W
    cache['k'][:, slot] = k[:, 0]
    cache['v'][:, slot] = v[:, 0]
    cache['kpos'][slot] = cache_len
    o = flash_attention(q, cache['k'], cache['v'], causal=True, window=window,
                        q_offset=cache_len, kv_positions=cache['kpos'], chunk=W)
    return L.apply_linear(p['wo'], o.reshape(B, 1, -1)), cache


def gqa_decode(p: Dict, cfg, x, cache_k, cache_v, cache_len: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); caches (B, S_max, KH, hd).

    Writes the new k/v at ``cache_len`` into the caches IN PLACE (the
    reference's engine donates its caches to the jitted step) and
    returns (out, cache_k, cache_v). An M-RoPE config continues in text:
    all three position streams are ``cache_len``."""
    B = x.shape[0]
    shape = (3, B, 1) if cfg.pos_kind == 'mrope' else (B, 1)
    q, k, v = gqa_qkv(p, cfg, x, torch.full(shape, cache_len, device=x.device))
    cache_k[:, cache_len] = k[:, 0]
    cache_v[:, cache_len] = v[:, 0]
    # single pass (chunk = the whole cache), as the reference
    o = flash_attention(q, cache_k, cache_v, causal=True, q_offset=cache_len,
                        kv_len=cache_len + 1, chunk=cache_k.shape[1])
    return L.apply_linear(p['wo'], o.reshape(B, 1, -1)), cache_k, cache_v
