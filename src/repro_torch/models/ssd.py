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

``fftconv`` at the bottom is the FFT long-convolution mixer: for a
*constant* per-head decay the SSD kernel is a convolution, and the long
convolution runs through the port's own FFT, the hand-written kernels
on the card. Its gradient is :class:`_FFTConv`'s adjoint, which runs the
same kernels (they have no backward of their own).
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import fft
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import full_fp32_matmul
from repro_torch.fft import methods as fftm
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


def _per_head(t, hg: int):
    """(..., G, N) -> (..., G * hg, N): each group's row repeated for its
    ``hg`` heads (head h belongs to group h // hg), as
    ``repeat_interleave`` on the group axis; its backward is a sum over
    the expanded axis, which is deterministic on CUDA, where
    ``repeat_interleave``'s adds with atomics."""
    G, N = t.shape[-2:]
    return t[..., None, :].expand(t.shape[:-1] + (hg, N)).reshape(
        t.shape[:-2] + (G * hg, N))


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
    bh = _per_head(b.float(), hg).reshape(B, nc, Lc, H, N)
    ch = _per_head(c.float(), hg).reshape(B, nc, Lc, H, N)
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
    bfh = _per_head(bi.reshape(B, G, N).float(), hg)                 # (B,H,N)
    cfh = _per_head(ci.reshape(B, G, N).float(), hg)
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


# ---------------------------------------------------------------------------
# FFT long-convolution mixer (examples/torch_fftconv_lm.py)
# ---------------------------------------------------------------------------

#: (kind, n, mesh, ...) -> cached fftconv operator plan. The runtime
#: entries ('rt', 'adj') are one ``n_spectra=1`` plan each, shared by
#: every training step; a baked entry holds (parameter token, weak refs
#: to the parameters' tensors, plan), one a layer's kernel, and goes when
#: those tensors do.
_fftconv_plans: Dict = {}


def _pick_axes(mesh, n: int):
    """Mesh axes for a length-``n`` rank-1 conv plan: the axes whose
    device product divides BOTH four-step factors (the rank-1 layout
    constraint). Tries all size>1 axes together, then each alone
    (largest first). None -> no distributed plan fits this mesh; the
    caller falls back to the local real-pencil path."""
    n1, n2 = tw.four_step_factors(n)
    live = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    for axes in ((live,) if live else ()) + \
            tuple((a,) for a in sorted(live, key=lambda a: -mesh.shape[a])):
        psize = 1
        for a in axes:
            psize *= mesh.shape[a]
        if n1 % psize == 0 and n2 % psize == 0:
            return axes
    return None if live else (mesh.axis_names[0],)


def conj_mul(ar, ai, k):
    """``(ar + i ai) * conj(kr + i ki)``, the correlation's pointwise
    stage: elementwise and conjugation-equivariant, as ``plan_op`` needs."""
    kr, ki = k
    return ar * kr + ai * ki, ai * kr - ar * ki


def _fftconv_runtime_plan(n: int, mesh, axes, adjoint: bool):
    """The shared ``n_spectra=1`` operator plan: the convolution
    (``spectral_mul``) or, with ``adjoint``, the correlation (``conj_mul``)."""
    key = ('adj' if adjoint else 'rt', n, mesh)
    pl = _fftconv_plans.get(key)
    if pl is None:
        pl = fft.plan_op((n,), mesh, op=conj_mul if adjoint else fft.spectral_mul,
                         op_name='fftconv_adjoint' if adjoint else 'fftconv', real=True,
                         n_spectra=1, donate=False, mesh_axes=axes)
        _fftconv_plans[key] = pl
    return pl


def _fftconv_op_plan(n: int, mesh, p: Dict, kr, klen: int, traced: bool):
    """The cached fused operator plan for an (n, mesh) conv, or None
    when the mesh cannot host one. ``traced`` (training: the spectrum
    is a function of live parameters) -> the shared ``n_spectra=1``
    plan, the kernel a runtime operand of the same apply. Else
    (eval/decode) -> a plan with the kernel spectrum BAKED: transformed
    once (``bake_count``) and reused while the parameters are unchanged.

    The reference keys a baked spectrum on the parameters' ``id()``,
    which holds because its optimizer makes new arrays each step. Here
    AdamW updates in place and a layer's parameters are fresh views of
    the stacked leaves each forward, so the key is each tensor's data
    pointer and the token adds its ``_version``, which every in-place
    write bumps: an update re-bakes. The entry holds weak refs to the
    tensors that own that memory (a view's base), so a freed model's
    entries go, and a new tensor at a freed address is not taken for it."""
    axes = _pick_axes(mesh, n)
    if axes is None:
        return None
    if traced:
        return _fftconv_runtime_plan(n, mesh, axes, adjoint=False)
    k, dec = p['kernel'], p['decay']
    owners = tuple(t if t._base is None else t._base for t in (k, dec))
    key = ('baked', n, mesh, k.data_ptr(), dec.data_ptr())
    tok = (k._version, dec._version, klen, tuple(k.shape))
    ent = _fftconv_plans.get(key)
    if ent is None or ent[0] != tok or any(r() is not o for r, o in zip(ent[1], owners)):
        for old in [kk for kk, e in _fftconv_plans.items()
                    if kk[0] == 'baked' and any(r() is None for r in e[1])]:
            del _fftconv_plans[old]
        pl = fft.plan_op((n,), mesh, op=fft.spectral_mul, op_name='fftconv', real=True,
                         donate=False, mesh_axes=axes, spectra=(kr,))
        ent = (tok, tuple(weakref.ref(o) for o in owners), pl)
        _fftconv_plans[key] = ent
    return ent[2]


def _local_conv(op: Callable) -> Callable:
    """The local real-pencil executor ``(a, b) -> irfft(op(rfft(a), rfft(b)))``
    along the last axis (``methods.apply_real``, four-step)."""

    def run(a, b):
        are, aim = fftm.apply_real(a, method='four_step')
        bre, bim = fftm.apply_real(b, method='four_step')
        yre, yim = op(are, aim, (bre, bim))
        return fftm.apply_real(yre, yim, inverse=True, method='four_step')
    return run


class _FFTConv(torch.autograd.Function):
    """``y = irfft(rfft(hr) * rfft(kr))``, a real circular convolution
    of length n along the last axis (hr (..., d, n), kr broadcasting to
    it), whose gradient runs the same FFT as its forward.

    The forward runs ``conv`` on detached operands without grad, so on
    the card it is the hand-written kernels, which refuse operands that
    require grad. The adjoint of a real circular convolution is a
    correlation:

        grad_hr = irfft(rfft(g) * conj(rfft(kr)))
        grad_kr = sum over the batch of irfft(rfft(g) * conj(rfft(hr)))

    so the backward is two applies of ``adjoint`` (the same executor
    with ``conj_mul`` for its pointwise stage) and adds no kernel."""

    @staticmethod
    def forward(ctx, hr, kr, conv, adjoint):
        ctx.save_for_backward(hr, kr)
        ctx.adjoint = adjoint
        with torch.no_grad():
            return conv(hr.detach(), kr.detach())

    @staticmethod
    def backward(ctx, g):
        hr, kr = ctx.saved_tensors
        g = g.contiguous()
        grad_hr = grad_kr = None
        with torch.no_grad():
            if ctx.needs_input_grad[0]:
                grad_hr = ctx.adjoint(g, kr.detach())
            if ctx.needs_input_grad[1]:
                grad_kr = ctx.adjoint(g, hr.detach())
                lead = grad_kr.ndim - kr.ndim
                if lead:
                    grad_kr = grad_kr.sum(dim=tuple(range(lead)))
        return grad_hr, grad_kr, None, None


def fftconv_plan(cfg) -> Dict:
    d = cfg.d_model
    return {
        'wi': L.linear_plan(d, d, ('embed', 'heads')),
        'kernel': PSpec((cfg.fftconv_len, d), (None, 'heads'), 'emb'),
        'decay': PSpec((d,), (None,), 'zeros'),   # softplus(0): taps at
        # lag 2-4 start alive; 'ones' kills them below grad noise
        'wo': L.linear_plan(d, d, ('heads', 'embed')),
    }


def fftconv_apply(p: Dict, cfg, x, *, mesh=None):
    """y = causal_conv(x, k) via the port's FFT: pad to 2S, fused rfft ->
    spectral multiply -> irfft. The long-conv form of a constant-decay
    SSM, the wsFFT engine as an LM mixer.

    With ``mesh`` the conv runs through a cached :func:`repro_torch.fft.
    plan_op` operator plan. When a gradient is wanted (grad enabled and
    an operand requires it) the kernel rides as a runtime operand of
    the shared plan, inside :class:`_FFTConv`, whose backward applies the
    adjoint plan; otherwise the kernel's spectrum is baked into a plan,
    transformed once. Without a usable mesh the conv uses the local REAL
    pencil transforms (half spectra via ``methods.apply_real``), inside
    :class:`_FFTConv` as well. The padding, the ``[:S]`` slice, the
    decay and the linears differentiate by plain autograd.

    No multiplicative gate: a pointwise content gate corrupts the
    relative-offset copy path that IS the conv mixer's strength
    (the reference measured the gated version failing to learn
    period-k copying)."""
    B, S, d = x.shape
    h = L.apply_linear(p['wi'], x)
    klen = min(cfg.fftconv_len, S)
    decay = torch.exp(-F.softplus(p['decay'].float())
                      * torch.arange(klen, dtype=torch.float32, device=x.device)[:, None])
    ker = p['kernel'].float()[:klen] * decay                       # (klen, d)
    n = 2 * S                         # linear (non-circular) convolution
    hf = h.float().transpose(1, 2)                                 # (B, d, S)
    kf = ker.t()                                                   # (d, klen)
    hr = F.pad(hf, (0, n - S)).contiguous()
    kr = F.pad(kf, (0, n - klen)).contiguous()
    traced = torch.is_grad_enabled() and (hr.requires_grad or kr.requires_grad)
    op = None if mesh is None else _fftconv_op_plan(n, mesh, p, kr, klen, traced)
    if op is not None and not traced:
        yr = op.apply(hr)                                          # baked spectrum
    else:
        if op is None:
            conv, adjoint = _local_conv(fft.spectral_mul), _local_conv(conj_mul)
        else:
            conv = op.apply
            adjoint = _fftconv_runtime_plan(n, mesh, _pick_axes(mesh, n), True).apply
        yr = _FFTConv.apply(hr, kr, conv, adjoint) if traced else conv(hr, kr)
    y = yr[..., :S].transpose(1, 2).to(x.dtype)
    return L.apply_linear(p['wo'], y)
