"""Mixture-of-Experts FFN: top-k routing and capacity-bounded scatter
dispatch, on one rank.

Port of ``repro.models.moe`` (``moe_plan``, ``capacity``, ``route``,
``_dispatch_indices``, ``moe_apply``). Dispatch is *sort + scatter*:
each batch row's (token, expert) pairs are sorted by expert (stable),
and the first ``C`` pairs of an expert get its capacity slots; the rest
go to one drop slot that is discarded. The expert buffer is laid out
(E, B * C, d) once, so each expert weight is one batched product.

The combine differs from the reference's on purpose: the reference adds
each pair's gated output into its token with a scatter-add
(``index_add_`` here, which the card runs with atomics in no fixed
order). The port gathers each token's K outputs back into (B, S, K, d)
and sums them over K in the order of the router's top-k, so the card's
result is reproducible run to run; it agrees with the reference's
within rounding (the reference sums a token's pairs in expert order).

The expert-parallel path (``moe_ep_explicit``) and the sharding
constraints (``use_gathered``) are not ported: they need the comm
surface and the sharded server (ROADMAP queue 1 items 10 and 11g).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.fft1d import full_fp32_matmul
from repro_torch.models import layers as L
from repro_torch.models.layers import PSpec


def moe_plan(cfg) -> Dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    plan = {
        'router': PSpec((d, E), ('embed', None), 'lin'),
        'wi': PSpec((E, d, 2 * f), ('expert', 'embed', 'mlp')),
        'wo': PSpec((E, f, d), ('expert', 'mlp', 'embed')),
    }
    if cfg.num_shared_experts:
        plan['shared'] = L.mlp_plan(d, cfg.num_shared_experts * f)
    return plan


def capacity(tokens_per_group: int, cfg) -> int:
    c = int(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.num_experts))
    return max(c, cfg.top_k)


def route(router_w, x, cfg):
    """x: (..., T, d). Returns (gates (..., T, K) fp32, idx (..., T, K)
    int32, probs (..., T, E) fp32 for the aux loss)."""
    full_fp32_matmul(x.device)
    probs = torch.softmax(torch.matmul(x.float(), router_w.float()), dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx.to(torch.int32), probs


def _dispatch_indices(idx, E: int, C: int):
    """idx: (..., T, K) expert assignment. Returns (order, dest, keep),
    each (..., T * K): entry j of the *sorted* stream is pair ``order[j]``
    (token ``order[j] // K``), and goes to flat buffer slot ``dest[j]``
    if ``keep[j]`` (its expert's capacity not exceeded), else to the drop
    slot ``E * C``. Leading axes are independent groups."""
    lead = idx.shape[:-2]
    TK = idx.shape[-2] * idx.shape[-1]
    e_flat = idx.reshape(*lead, TK).long()
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, -1, order)
    experts = torch.arange(E, device=idx.device).expand(*lead, E).contiguous()
    start = torch.searchsorted(e_sorted, experts)               # side='left'
    pos = torch.arange(TK, device=idx.device) - torch.gather(start, -1, e_sorted)
    keep = pos < C
    dest = torch.where(keep, e_sorted * C + pos, E * C)
    return order, dest, keep


def aux_loss(idx, probs, cfg):
    """The load-balance loss E * sum_e frac_e * mean_prob_e: frac_e the
    share of (token, k) pairs routed to expert e, mean_prob_e the mean
    router probability of e, both over every token."""
    E, K = cfg.num_experts, cfg.top_k
    tokens = idx.numel() // K
    counts = F.one_hot(idx.long(), E).sum(dim=tuple(range(idx.dim())))
    frac = counts.float() / tokens / K
    pmean = probs.reshape(-1, E).mean(dim=0)
    return E * torch.sum(frac * pmean)


def moe_apply(p: Dict, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Groups = batch rows: each row's
    tokens share a capacity pool of ``capacity(S)`` slots an expert."""
    B, S, d = x.shape
    K, E = cfg.top_k, cfg.num_experts
    C = capacity(S, cfg)
    gates, idx, probs = route(p['router'], x, cfg)
    order, dest, keep = _dispatch_indices(idx, E, C)              # (B, S * K)
    # the sorted stream's slot in the (E, B, C) buffer, then each (token,
    # k) pair's slot in pair order (order is a permutation of the pairs)
    row = torch.arange(B, device=x.device)[:, None]
    drop = E * B * C
    slot = torch.where(keep, (dest // C) * (B * C) + row * C + dest % C, drop)
    slot = torch.empty_like(slot).scatter_(1, order, slot).reshape(B * S * K)
    buf = x.new_zeros((drop + 1, d))
    buf[slot] = x[:, :, None].expand(B, S, K, d).reshape(B * S * K, d)
    full_fp32_matmul(x.device)
    h = torch.bmm(buf[:drop].view(E, B * C, d), p['wi'].to(x.dtype))
    g, u = torch.chunk(h, 2, dim=-1)
    out = torch.bmm(F.silu(g) * u, p['wo'].to(x.dtype))             # (E, B * C, d)
    out = torch.cat([out.reshape(drop, d), out.new_zeros((1, d))])
    ys = out[slot].reshape(B, S, K, d)
    gk = gates.to(out.dtype)
    y = ys[:, :, 0] * gk[..., 0, None]
    for k in range(1, K):                      # a fixed order: the router's top-k
        y = y + ys[:, :, k] * gk[..., k, None]
    if 'shared' in p:
        y = y + L.apply_mlp(p['shared'], x)
    return y, aux_loss(idx, probs, cfg)
