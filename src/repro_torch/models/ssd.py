"""Mamba2 SSD (state-space duality) mixer: chunked scan and O(1) decode.

Port of the SSD part of ``repro.models.ssd``. The SSD recurrence per
head (state N x P):

    h_t = a_t * h_{t-1} + dt_t * B_t x_t^T          a_t = exp(dt_t * A)
    y_t = C_t . h_t + D * x_t

computed with the chunk decomposition of the Mamba2 paper: within a
chunk the quadratic (attention-like) form with a decay mask; across
chunks a loop carries the (H, N, P) state (the reference's
``lax.scan``), taking the state *entering* each chunk. The decays
within a chunk are segment sums of the log decay (the Mamba2 paper's
``segsum``), where the reference differences two cumulative sums.

The FFT long-convolution mixer of the same reference file
(``fftconv``) is not ported yet (ROADMAP queue 1 item 11f).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.fft1d import full_fp32_matmul
from repro_torch.models import layers as L
from repro_torch.models.layers import PSpec


def ssd_dims(cfg) -> Tuple[int, int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = di // P
    N = cfg.ssm_state
    return di, H, P, N


def ssd_plan(cfg) -> Dict:
    d = cfg.d_model
    di, H, P, N = ssd_dims(cfg)
    G = cfg.ssm_groups
    w = cfg.conv_width
    return {
        'wz': L.linear_plan(d, di, ('embed', 'heads')),
        'wx': L.linear_plan(d, di, ('embed', 'heads')),
        'wb': L.linear_plan(d, G * N, ('embed', None)),
        'wc': L.linear_plan(d, G * N, ('embed', None)),
        'wdt': L.linear_plan(d, H, ('embed', None)),
        'conv_x': PSpec((w, di), (None, 'heads')),
        'conv_b': PSpec((w, G * N), (None, None)),
        'conv_c': PSpec((w, G * N), (None, None)),
        'a_log': PSpec((H,), (None,), 'ssm_a'),
        'dt_bias': PSpec((H,), (None,), 'ssm_dt'),
        'dskip': PSpec((H,), (None,), 'ones'),
        'norm': L.norm_plan(di),
        'wo': L.linear_plan(di, d, ('heads', 'embed')),
    }


def _causal_conv(x, w, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along axis 1. x: (B, S, C); w: (W, C).
    ``state``: (B, W-1, C) prefix (decode); returns (silu(y), new_state)."""
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    return F.silu(y), xp[:, -(W - 1):]


def _ssd_chunk_scan(xh, b, c, dt, a_log, chunk: int):
    """Chunked SSD. xh: (B,S,H,P); b,c: (B,S,G,N); dt: (B,S,H) fp32.
    Returns (y (B,S,H,P) fp32, final state (B,H,N,P) fp32)."""
    full_fp32_matmul(xh.device)
    B, S0, H, P = xh.shape
    G, N = b.shape[2], b.shape[3]
    Lc = min(chunk, S0)
    pad = (-S0) % Lc
    if pad:        # identity padding: dt=0 => a=1, zero state contribution
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    S = S0 + pad
    nc = S // Lc
    hg = H // G                       # heads per B/C group

    A = -torch.exp(a_log.float())                                   # (H,)
    xf = xh.float().reshape(B, nc, Lc, H, P)
    # expand groups to per-head (head h belongs to group h // hg)
    bh = torch.repeat_interleave(b.float(), hg, dim=2).reshape(B, nc, Lc, H, N)
    ch = torch.repeat_interleave(c.float(), hg, dim=2).reshape(B, nc, Lc, H, N)
    dtf = dt.reshape(B, nc, Lc, H)
    la = dtf * A                                                    # log a_t, <= 0
    cum = torch.cumsum(la, dim=2)                                   # (B,nc,Lc,H)

    # intra-chunk: M[t,s] = (C_t . B_s) * exp(seg[t,s]) * dt_s, s <= t, with
    # seg[t,s] = sum_{s<r<=t} log a_r summed over the segment itself. The
    # reference takes it as cum_t - cum_s: where the chunk's cumulative
    # log decay reaches -1e4, an fp32 ulp of it is 1e-3, which that
    # difference keeps on the near-diagonal decays
    gsc = torch.einsum('bnthi,bnshi->bnhts', ch, bh)                # (B,nc,H,Lc,Lc)
    strict = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=xh.device), -1)
    seg = torch.where(strict, la.transpose(2, 3)[..., :, None], 0.0).cumsum(dim=-2)
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=xh.device))
    m = torch.where(tri, gsc * torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    del gsc
    m = m * dtf.transpose(2, 3)[..., None, :]                       # * dt_s
    y_intra = torch.einsum('bnhts,bnshp->bnthp', m, xf)
    del m

    # per-chunk input to the state: sum_s exp(seg[last, s]) dt_s B_s x_s
    w_s = torch.exp(seg[..., -1, :]).transpose(2, 3) * dtf          # (B,nc,Lc,H)
    del seg
    bx = torch.einsum('bnshi,bnshp->bnhip', bh, xf * w_s[..., None])
    a_chunk = torch.exp(torch.sum(la, dim=2))                       # (B,nc,H)

    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
    h_in = []
    for n in range(nc):
        h_in.append(h)                                              # state entering chunk n
        h = h * a_chunk[:, n, :, None, None] + bx[:, n]
    h_in = torch.stack(h_in, dim=1)                                 # (B,nc,H,N,P)

    # inter-chunk: y_inter[t] = exp(cum_t) * C_t . h_in
    y_inter = torch.einsum('bnthi,bnhip->bnthp', ch, h_in) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y[:, :S0], h


def ssd_apply(p: Dict, cfg, x, *, return_cache: bool = False):
    """Full-sequence SSD block. x: (B, S, d_model). With ``return_cache``
    also returns the decode cache (final SSM state + rolling conv
    prefixes, in the dtypes the block computes them in)."""
    B, S, _ = x.shape
    di, H, P, N = ssd_dims(cfg)
    G = cfg.ssm_groups
    z = L.apply_linear(p['wz'], x)
    xi = L.apply_linear(p['wx'], x)
    bi = L.apply_linear(p['wb'], x)
    ci = L.apply_linear(p['wc'], x)
    dt = L.apply_linear(p['wdt'], x).float()
    xi, sx = _causal_conv(xi, p['conv_x'])
    bi, sb = _causal_conv(bi, p['conv_b'])
    ci, sc = _causal_conv(ci, p['conv_c'])
    dt = F.softplus(dt + p['dt_bias'].float())
    xh = xi.reshape(B, S, H, P)
    y, state = _ssd_chunk_scan(xh, bi.reshape(B, S, G, N), ci.reshape(B, S, G, N), dt,
                               p['a_log'], cfg.ssm_chunk)
    y = y + xh.float() * p['dskip'].float()[:, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = L.apply_norm(p['norm'], y * F.silu(z))
    out = L.apply_linear(p['wo'], y)
    if return_cache:
        return out, {'state': state, 'conv_x': sx, 'conv_b': sb, 'conv_c': sc}
    return out


def ssd_decode(p: Dict, cfg, x, cache: Dict):
    """One-token decode. x: (B, 1, d); cache: {'state' (B,H,N,P) fp32,
    'conv_x'/'conv_b'/'conv_c' (B, W-1, C) rolling prefixes}.

    Writes the new state and prefixes into ``cache``'s tensors IN PLACE
    (the reference's engine donates its caches) and returns (out, cache)."""
    B = x.shape[0]
    di, H, P, N = ssd_dims(cfg)
    G = cfg.ssm_groups
    z = L.apply_linear(p['wz'], x)
    xi = L.apply_linear(p['wx'], x)
    bi = L.apply_linear(p['wb'], x)
    ci = L.apply_linear(p['wc'], x)
    dt = L.apply_linear(p['wdt'], x).float()
    xi, conv_x = _causal_conv(xi, p['conv_x'], cache['conv_x'])
    bi, conv_b = _causal_conv(bi, p['conv_b'], cache['conv_b'])
    ci, conv_c = _causal_conv(ci, p['conv_c'], cache['conv_c'])
    dt = F.softplus(dt + p['dt_bias'].float())[:, 0]                # (B,H)
    A = -torch.exp(p['a_log'].float())
    a = torch.exp(dt * A)                                           # (B,H)
    xh = xi.reshape(B, H, P).float()
    hg = H // G
    bfh = torch.repeat_interleave(bi.reshape(B, G, N).float(), hg, dim=1)   # (B,H,N)
    cfh = torch.repeat_interleave(ci.reshape(B, G, N).float(), hg, dim=1)
    state = cache['state'] * a[..., None, None] + \
        (dt[..., None, None] * bfh[..., None] * xh[:, :, None, :])
    y = torch.einsum('bhi,bhip->bhp', cfh, state)
    y = y + xh * p['dskip'].float()[:, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = L.apply_norm(p['norm'], y * F.silu(z))
    for name, new in (('state', state), ('conv_x', conv_x), ('conv_b', conv_b),
                      ('conv_c', conv_c)):
        cache[name].copy_(new)
    return L.apply_linear(p['wo'], y), cache
