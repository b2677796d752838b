"""Shared model layers and the parameter *plan* system.

Port of ``repro.models.layers``. A plan is a nested dict whose leaves are
``PSpec(shape, axes, init)``: ``axes`` are the reference's logical
sharding axes (kept for the sharded server) and ``init`` names an
initializer. From one plan come the parameters (:func:`init_from_plan`,
drawn from an explicit ``torch.Generator`` on its device), their
shapes on the ``meta`` device (:func:`abstract_from_plan`) and the axes.

Parameters are plain tensors in nested dicts, laid out as the
reference's: layer-stacked along axis 0 (:func:`stack_plans`), linear
weights ``(d_in, d_out)`` used as ``x @ w``. Norms, softmax and rope
run in fp32; products run in the operands' dtype with fp32
accumulation, at full fp32 precision on CUDA (no TF32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fft1d import full_fp32_matmul


# ---------------------------------------------------------------------------
# Nested-dict trees (the reference's pytrees of dicts)
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys in sorted order, as
    ``jax.tree`` flattens a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# Param plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = 'lin'            # lin | emb | zeros | ones | neg1 | ssm_a | ssm_dt
    dtype: Optional[Any] = None  # override the model param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f'shape {self.shape} and axes {self.axes} differ in rank')


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


#: the most fp32 elements a narrow-dtype draw holds at once (1 GiB)
DRAW_ELEMS = 1 << 28


def _normal(gen, shape, scale: float, dt) -> torch.Tensor:
    """``scale`` times a standard normal of ``shape`` in ``dt``. An fp32
    (or wider) leaf is one draw scaled in place. A narrower leaf is
    drawn in fp32 and cast a block of leading-axis slices at a time (at
    most ``DRAW_ELEMS`` elements), so a leaf that fills most of the card
    in bf16 never has its fp32 twin alongside it."""
    dev = gen.device
    if torch.finfo(dt).bits >= 32 or len(shape) < 2:
        return torch.randn(shape, generator=gen, device=dev).mul_(scale).to(dt)
    out = torch.empty(shape, dtype=dt, device=dev)
    rows = max(1, DRAW_ELEMS // math.prod(shape[1:]))
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        out[i:i + n] = torch.randn((n,) + tuple(shape[1:]), generator=gen,
                                   device=dev).mul_(scale)
    return out


def _init_leaf(gen: torch.Generator, p: PSpec, dtype, fan_in: Optional[int] = None
               ) -> torch.Tensor:
    """One leaf drawn from ``gen`` on ``gen.device``, as the reference's
    ``_init_leaf`` draws it (another generator, the same distribution),
    except the fan-in of a layer-stacked linear weight (below).
    ``fan_in`` overrides the 'lin' fan-in (a shard of a leaf is drawn
    with its whole leaf's)."""
    dt = p.dtype or dtype
    dev = gen.device
    if p.init == 'zeros':
        return torch.zeros(p.shape, dtype=dt, device=dev)
    if p.init == 'neg1':          # empty ring-cache slots
        return torch.full(p.shape, -1, dtype=dt, device=dev)
    if p.init == 'ones':
        return torch.ones(p.shape, dtype=dt, device=dev)
    if p.init == 'emb':
        return _normal(gen, p.shape, 0.02, dt)
    if p.init == 'lin':
        # fan-in scaled normal, the fan-in d_in of a (..., d_in, d_out)
        # leaf. The reference takes shape[0], which for a layer-stacked
        # (L, d_in, d_out) leaf is the layer count: at full width that
        # scales every product by sqrt(d_in / L) (6.5x a linear layer in
        # mamba2-1.3b), and fp32 rounding then grows past the serve
        # contract's 2e-3 on the logits
        if fan_in is None:
            fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        return _normal(gen, p.shape, 1.0 / math.sqrt(max(fan_in, 1)), dt)
    if p.init == 'ssm_a':         # log(-A) ~ U[log 1, log 16]: Mamba2 A_log init
        return _uniform(gen, p.shape, math.log(1.0), math.log(16.0)).to(dt)
    if p.init == 'ssm_dt':        # dt bias ~ softplus^-1(U[1e-3, 1e-1]) (log-uniform)
        dt_ = torch.exp(_uniform(gen, p.shape, math.log(1e-3), math.log(1e-1)))
        return (dt_ + torch.log(-torch.expm1(-dt_))).to(dt)
    raise ValueError(f'unknown init {p.init!r}')


def init_from_plan(gen: torch.Generator, plan, dtype=torch.bfloat16):
    """Every leaf of ``plan`` drawn in turn from ``gen`` (sorted-key order)."""
    return tree_map(lambda p: _init_leaf(gen, p, dtype), plan)


def abstract_from_plan(plan, dtype=torch.bfloat16):
    """The plan's tensors on the ``meta`` device: shapes and dtypes, no memory."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype or dtype, device='meta'),
                    plan)


def axes_from_plan(plan):
    return tree_map(lambda p: p.axes, plan)


def stack_plans(plans: Sequence):
    """Stack per-layer plans along a new leading (layer) axis."""
    def stack(*leaves: PSpec) -> PSpec:
        p0 = leaves[0]
        if any(leaf.shape != p0.shape for leaf in leaves):
            raise ValueError(f'cannot stack plans of shapes {[leaf.shape for leaf in leaves]}')
        return PSpec((len(leaves),) + p0.shape, (None,) + p0.axes, p0.init, p0.dtype)
    return tree_map(stack, plans[0], *plans[1:])


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps)).to(dt) * scale.to(dt) + bias.to(dt)


def norm_plan(d: int, kind: str = 'rms') -> Dict:
    if kind == 'rms':
        return {'scale': PSpec((d,), (None,), 'ones')}
    return {'scale': PSpec((d,), (None,), 'ones'),
            'bias': PSpec((d,), (None,), 'zeros')}


def apply_norm(p: Dict, x, eps: float = 1e-6):
    if 'bias' in p:
        return layer_norm(x, p['scale'], p['bias'], eps)
    return rms_norm(x, p['scale'], eps)


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------

def linear(x, w, b=None):
    """``x @ w`` (+ ``b``): fp32 accumulation, the result in x's dtype."""
    full_fp32_matmul(x.device)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def linear_plan(d_in: int, d_out: int, axes: Tuple[Optional[str], Optional[str]],
                *, bias: bool = False, bias_axis: Optional[str] = None) -> Dict:
    p = {'w': PSpec((d_in, d_out), axes)}
    if bias:
        p['b'] = PSpec((d_out,), (bias_axis if bias_axis is not None else axes[1],),
                       'zeros')
    return p


def apply_linear(p: Dict, x):
    return linear(x, p['w'], p.get('b'))


def row_parallel(x, w, par=None):
    """``x @ w`` where x's last axis and w's rows are this rank's block of
    the 'model' group's: the partial products summed over the group
    (``par.sum``, an ``all_reduce``); ``par`` None is one rank."""
    y = linear(x, w)
    return y if par is None else par.sum(y)


def embed_plan(vocab: int, d: int) -> Dict:
    return {'table': PSpec((vocab, d), ('vocab', 'embed'), 'emb')}


def embed_lookup(p: Dict, ids):
    """Rows of the table for int32 or int64 ``ids``. ``F.embedding``:
    its CUDA backward sums a row's gradients in a fixed order, where
    ``index_select``'s adds them with atomics, so a training step gives
    the same bits on every run."""
    return F.embedding(ids, p['table'])


def embed_lookup_tp(p: Dict, ids, par):
    """The vocab-parallel lookup: this rank holds rows ``[r V/p, (r+1) V/p)``
    of the table; a token outside them looks up zeros, and the sum over
    the 'model' group (``par.sum``) gives every rank its row (one
    nonzero term: the bits of the whole table's)."""
    n = p['table'].shape[0]
    local = ids.long() - par.tp_index * n
    inside = (local >= 0) & (local < n)
    x = F.embedding(torch.where(inside, local, 0), p['table'])
    return par.sum(x.masked_fill_(~inside[..., None], 0))


def unembed(p: Dict, x):
    """Logits via the (tied or separate) embedding table, in fp32."""
    full_fp32_matmul(x.device)
    return torch.matmul(x, p['table'].to(x.dtype).t()).float()


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def _rotate(x, ang):
    """Rotate the two halves of x's last axis (not interleaved) by ``ang``
    (..., S, D/2), broadcast over the heads axis."""
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, *, theta: float = 1e4):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta), dtype=torch.float32,
                            device=x.device)
    return _rotate(x, positions.float()[..., None] * freqs)


def apply_mrope(x, positions3, *, theta: float = 1e4,
                sections: Tuple[int, int, int] = (16, 24, 24)):
    """Qwen2-VL multimodal RoPE: positions3 (3, ..., S) are (t, h, w)
    position ids; the head_dim/2 frequency slots are split into three
    sections, each rotated by its own position stream."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f'mrope sections {sections} do not sum to head_dim/2 = {d // 2}')
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32, device=x.device)
    sec = np.repeat(np.arange(3), np.asarray(sections))        # (D/2,) -> section id
    onehot = torch.as_tensor(np.eye(3)[sec], dtype=torch.float32, device=x.device)
    ang_all = positions3.float()[..., None] * freqs           # (3, ..., S, D/2)
    ang = torch.einsum('k...d,dk->...d', ang_all, onehot)      # per-slot select
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_plan(d: int, d_ff: int, *, gated: bool = True) -> Dict:
    if gated:
        return {'wi': PSpec((d, 2 * d_ff), ('embed', 'mlp')),
                'wo': PSpec((d_ff, d), ('mlp', 'embed'))}
    return {'wi': PSpec((d, d_ff), ('embed', 'mlp')),
            'wo': PSpec((d_ff, d), ('mlp', 'embed'))}


def apply_mlp(p: Dict, x, *, act: str = 'silu', par=None):
    """The MLP. With ``par`` (``parallel.Parallel``: a 'model' group of
    several ranks) it is tensor-parallel: ``wi`` column-parallel, stored
    as this rank's [gate block ‖ up block] when gated
    (``weights.shard_params``), ``wo`` row-parallel, then ``all_reduce``;
    ``x`` enters the split (``par.enter``: its cotangent summed over
    'model')."""
    if par is not None:
        x = par.enter(x)
    h = linear(x, p['wi'])
    if p['wi'].shape[-1] == 2 * p['wo'].shape[0]:      # gated (SwiGLU/GeGLU)
        g, u = torch.chunk(h, 2, dim=-1)
        h = _act(g, act) * u
    else:
        h = _act(h, act)
    return row_parallel(h, p['wo'], par)


def _act(x, name: str):
    if name == 'silu':
        return F.silu(x)
    if name == 'gelu':                   # jax.nn.gelu's default: the tanh form
        return F.gelu(x, approximate='tanh')
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def token_nll(logits, labels, par=None):
    """Each token's negative log-likelihood from fp32 logits (..., V);
    with ``par`` the logits are this rank's block of the vocabulary
    (``V / tp`` columns, in 'model' order) and the log-sum-exp and the
    gold logit are summed over 'model' (Megatron's vocab-parallel cross
    entropy: no rank holds a whole row of logits). Every rank gets every
    token's loss."""
    logits = logits.float()
    if par is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    with torch.no_grad():
        m = par.amax(logits.amax(dim=-1))
    lse = torch.log(par.sum(torch.exp(logits - m[..., None]).sum(dim=-1))) + m
    n = logits.shape[-1]
    local = labels.long() - par.tp_index * n
    inside = (local >= 0) & (local < n)
    gold = torch.take_along_dim(logits, torch.where(inside, local, 0)[..., None], dim=-1)[..., 0]
    return lse - par.sum(gold.masked_fill(~inside, 0))


def softmax_xent(logits, labels, *, mask=None):
    """Mean token cross-entropy; logits fp32 (..., V), labels int (...)."""
    nll = token_nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
