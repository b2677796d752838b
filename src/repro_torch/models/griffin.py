"""Griffin / RecurrentGemma RG-LRU recurrent block.

Port of ``repro.models.griffin``:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = c * r_t * log sigmoid(lam)    (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

The decay is input-gated and varies in time, so the recurrence has no
FFT-convolution form: it is computed, not transformed. Prefill runs a
chunked scan (a log-depth scan inside each chunk, a carry across
chunks); decode is an O(1) state update.

The temporal block is conv1d + RG-LRU on one branch and a GeLU gate on
the other (Griffin fig. 2); the local sliding-window attention layers
are ``models/attention.py``'s with ``cfg.window``.

The scan inside a chunk is a Hillis-Steele doubling scan in plain tensor
ops (log2 of the chunk steps, 8 at 256) where the reference runs
``jax.lax.associative_scan``: the same composition, products and sums
taken in another order, so the two agree to fp32 rounding, not
bitwise (ROADMAP queue 3).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import PSpec
from repro_torch.models.ssd import _causal_conv

C_FACTOR = 8.0


def rglru_plan(cfg) -> Dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        'wx_in': L.linear_plan(d, w, ('embed', 'heads')),
        'wgate': L.linear_plan(d, w, ('embed', 'heads')),
        'conv': PSpec((cfg.conv_width, w), (None, 'heads')),
        'wa': PSpec((w, w), ('heads', 'heads')),
        'wi': PSpec((w, w), ('heads', 'heads')),
        'ba': PSpec((w,), (None,), 'zeros'),
        'bi': PSpec((w,), (None,), 'zeros'),
        'lam': PSpec((w,), (None,), 'ones'),
        'wo': L.linear_plan(w, d, ('heads', 'embed')),
    }


def _gates(p: Dict, x):
    """(a, gated input b) a position, fp32 whatever ``x``'s dtype.
    x: (..., W) after the conv."""
    xf = x.float()
    r = torch.sigmoid(L.linear(xf, p['wa'].float()) + p['ba'].float())
    i = torch.sigmoid(L.linear(xf, p['wi'].float()) + p['bi'].float())
    log_a_max = F.logsigmoid(p['lam'].float() * 4.0)
    log_a = C_FACTOR * r * log_a_max            # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def _scan_in_chunks(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along axis -2 of
    (..., Lc, W), from h = 0: the cumulative compositions (A_t, B_t) with
    h_t = A_t h_{-1} + B_t. Hillis-Steele doubling: at distance d every
    position composes the one d before it,
    (A, B) o (A', B') = (A A', A' B + B')."""
    Lc = a.shape[-2]
    d = 1
    while d < Lc:
        a_new = torch.cat([a[..., :d, :], a[..., d:, :] * a[..., :-d, :]], dim=-2)
        b = torch.cat([b[..., :d, :], a[..., d:, :] * b[..., :-d, :] + b[..., d:, :]], dim=-2)
        a = a_new
        d *= 2
    return a, b


def _lru_scan_chunked(a, b, h0, chunk: int):
    """h_t = a_t h_{t-1} + b_t along axis 1 of (B, S, W); returns (h_all,
    h_final). A log-depth scan inside ``chunk``-long chunks (all chunks at
    once), then the state carried across chunks in a loop of S / chunk
    steps."""
    B, S0, W = a.shape
    Lc = min(chunk, S0)
    pad = (-S0) % Lc
    if pad:        # identity padding: a=1, b=0 leaves the state untouched
        a = torch.cat([a, a.new_ones((B, pad, W))], dim=1)
        b = torch.cat([b, b.new_zeros((B, pad, W))], dim=1)
    S = S0 + pad
    nc = S // Lc
    A_cum, B_cum = _scan_in_chunks(a.reshape(B, nc, Lc, W), b.reshape(B, nc, Lc, W))
    h, h_in = h0, []
    for n in range(nc):               # the state entering each chunk
        h_in.append(h)
        h = A_cum[:, n, -1] * h + B_cum[:, n, -1]
    hs = A_cum * torch.stack(h_in, dim=1)[:, :, None, :] + B_cum
    hs = hs.reshape(B, S, W)[:, :S0]
    if pad:        # the true final state is at position S0-1, not the pad end
        h = hs[:, -1, :]
    return hs, h


def rglru_apply(p: Dict, cfg, x, *, return_cache: bool = False):
    """Temporal block, full sequence. x: (B, S, d_model). With
    ``return_cache`` also the decode cache: the final state (fp32) and
    the conv's rolling prefix."""
    B, S, _ = x.shape
    gate = L._act(L.apply_linear(p['wgate'], x), 'gelu')
    u = L.apply_linear(p['wx_in'], x)
    u, conv_state = _causal_conv(u, p['conv'])
    a, b = _gates(p, u)
    h0 = torch.zeros((B, cfg.lru_width), dtype=torch.float32, device=x.device)
    h, h_final = _lru_scan_chunked(a, b, h0, cfg.lru_chunk)
    out = L.apply_linear(p['wo'], h.to(x.dtype) * gate)
    if return_cache:
        return out, {'h': h_final, 'conv': conv_state}
    return out


def rglru_decode(p: Dict, cfg, x, cache: Dict):
    """One-token decode. x: (B, 1, d); cache: {'h' (B, W) fp32, 'conv'
    (B, conv_width-1, W)}.

    Writes the new state and conv prefix into ``cache``'s tensors IN
    PLACE (the reference's engine donates its caches) and returns (out,
    cache)."""
    gate = L._act(L.apply_linear(p['wgate'], x), 'gelu')
    u = L.apply_linear(p['wx_in'], x)
    u, conv_state = _causal_conv(u, p['conv'], cache['conv'])
    a, b = _gates(p, u[:, 0, :])
    h = a * cache['h'] + b
    y = h[:, None, :].to(x.dtype) * gate
    cache['h'].copy_(h)
    cache['conv'].copy_(conv_state)
    return L.apply_linear(p['wo'], y), cache
