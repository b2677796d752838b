"""Model assembly: config -> parameter plan -> forward / prefill / decode.

Port of ``repro.models.model``. Layers are grouped into *periods* of
``cfg.block_pattern``; the full periods are stacked along a leading
axis of every parameter and cache leaf (the reference scans over it),
and the remainder layers form an unrolled tail (``split_layers``). Here
every loop over layers is a Python loop over that axis.

Every block kind of the reference runs: ``attn``, ``local_attn``
(sliding window, ring cache), ``mla`` (compressed latent cache),
``ssd``, ``rglru`` and ``fftconv``, with the ``mlp`` or the ``moe``
feed-forward, on token or embedding inputs (``cfg.input_mode``) with
RoPE, M-RoPE's three position streams or no positions
(``cfg.pos_kind``). The MoE router's load-balance loss is summed over
every layer into ``forward``'s aux loss. Decode updates the caches in
place: the reference's serving engine donates them to its jitted step,
so a caller that still needs a cache after a decode step clones it
first.

Training differentiates :func:`loss_fn` with autograd. With
``cfg.remat`` (the full configs; ``smoke_config`` turns it off) and
grad enabled, each period of layers runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward, as the reference's ``jax.checkpoint`` of
its scanned period body; the unrolled tail is not checkpointed, as
there.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import griffin, moe, ssd
from repro_torch.models import layers as L
from repro_torch.models.layers import PSpec

# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def ffn_kind(cfg) -> Optional[str]:
    if cfg.moe:
        return 'moe'
    if cfg.d_ff > 0:
        return 'mlp'
    return None


def layer_plan(cfg, kind: str) -> Dict:
    p: Dict[str, Any] = {'norm1': L.norm_plan(cfg.d_model, cfg.norm_kind)}
    if kind in ('attn', 'local_attn'):
        p[kind] = attn.gqa_plan(cfg)
    elif kind == 'mla':
        p[kind] = attn.mla_plan(cfg)
    elif kind == 'ssd':
        p[kind] = ssd.ssd_plan(cfg)
    elif kind == 'rglru':
        p[kind] = griffin.rglru_plan(cfg)
    elif kind == 'fftconv':
        p[kind] = ssd.fftconv_plan(cfg)
    else:
        raise ValueError(f'unknown block kind {kind!r}')
    fk = ffn_kind(cfg)
    if fk is not None:
        p['norm2'] = L.norm_plan(cfg.d_model, cfg.norm_kind)
        p[fk] = moe.moe_plan(cfg) if fk == 'moe' else L.mlp_plan(cfg.d_model, cfg.d_ff)
    return p


def split_layers(cfg) -> Tuple[int, int]:
    """(n_full_periods, n_tail_layers)."""
    P = len(cfg.block_pattern)
    return cfg.num_layers // P, cfg.num_layers % P


def model_plan(cfg) -> Dict:
    n_periods, tail = split_layers(cfg)
    period = {f'{i}_{kind}': layer_plan(cfg, kind)
              for i, kind in enumerate(cfg.block_pattern)}
    plan: Dict[str, Any] = {
        'embed': L.embed_plan(cfg.vocab_size, cfg.d_model),
        'blocks': L.stack_plans([period] * n_periods),
        'final_norm': L.norm_plan(cfg.d_model, cfg.norm_kind),
    }
    if not cfg.tie_embeddings:
        plan['head'] = L.linear_plan(cfg.d_model, cfg.vocab_size, ('embed', 'vocab'))
    if tail:
        plan['tail'] = {str(j): layer_plan(cfg, cfg.block_pattern[j]) for j in range(tail)}
    return plan


def init_params(gen: torch.Generator, cfg, dtype=torch.bfloat16):
    """Random parameters drawn from ``gen``, on ``gen.device``."""
    return L.init_from_plan(gen, model_plan(cfg), dtype)


def abstract_params(cfg, dtype=torch.bfloat16):
    return L.abstract_from_plan(model_plan(cfg), dtype)


def param_axes(cfg):
    return L.axes_from_plan(model_plan(cfg))


def param_count(cfg) -> int:
    return int(sum(np.prod(p.shape) for p in L.tree_leaves(model_plan(cfg))))


def active_param_count(cfg) -> int:
    """Parameters touched a token: in an MoE layer every leaf named
    ``wi`` or ``wo`` under ``moe`` counts ``top_k / num_experts`` of its
    size, as the reference's count (which scales the shared experts'
    too)."""
    if not cfg.moe:
        return param_count(cfg)

    def count(tree, keys):
        if isinstance(tree, dict):
            return sum(count(v, keys + (k,)) for k, v in tree.items())
        n = int(np.prod(tree.shape))
        if 'moe' in keys and ('wi' in keys or 'wo' in keys):
            n = n * cfg.top_k // cfg.num_experts
        return n
    return count(model_plan(cfg), ())


def _layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views)."""
    return L.tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Full-sequence blocks (train / prefill)
# ---------------------------------------------------------------------------

def _apply_block(p: Dict, cfg, kind: str, x, positions, *, mesh=None, sp: bool = False,
                 cache_cap: Optional[int] = None, want_cache: bool = False):
    """One residual block (temporal + optional FFN). Returns
    (x, aux-loss-or-None, cache-or-None); ``fftconv`` has no cache, and
    only the MoE feed-forward has an aux loss. ``mesh``: the FFT-conv
    mixer's plan mesh (None: the local real-pencil path)."""
    h = L.apply_norm(p['norm1'], x, cfg.norm_eps)
    cache = None
    if kind in ('attn', 'local_attn'):
        window = cfg.window if kind == 'local_attn' else 0
        if want_cache:
            y, cache = attn.gqa_prefill(p[kind], cfg, h, positions, window=window,
                                        cache_cap=cache_cap, sp=sp)
        else:
            y = attn.gqa_apply(p[kind], cfg, h, positions, window=window, sp=sp)
    elif kind == 'mla':
        if want_cache:
            y, cache = attn.mla_prefill(p[kind], cfg, h, positions, cache_cap=cache_cap)
        else:
            y = attn.mla_apply(p[kind], cfg, h, positions)
    elif kind == 'ssd':
        out = ssd.ssd_apply(p[kind], cfg, h, return_cache=want_cache)
        y, cache = out if want_cache else (out, None)
    elif kind == 'rglru':
        out = griffin.rglru_apply(p[kind], cfg, h, return_cache=want_cache)
        y, cache = out if want_cache else (out, None)
    elif kind == 'fftconv':
        y = ssd.fftconv_apply(p[kind], cfg, h, mesh=mesh)
    else:
        raise ValueError(kind)
    x, aux = _ffn(p, cfg, x + y)
    return x, aux, cache


def _ffn(p: Dict, cfg, x):
    """The block's feed-forward and its residual: (x, the MoE router's
    aux loss, or None for an MLP or no feed-forward)."""
    fk = ffn_kind(cfg)
    if fk is None:
        return x, None
    h = L.apply_norm(p['norm2'], x, cfg.norm_eps)
    if fk == 'mlp':
        return x + L.apply_mlp(p['mlp'], h, act=cfg.act), None
    y, aux = _moe_ffn(p['moe'], cfg, h)
    return x + y, aux


def _moe_ffn(p: Dict, cfg, h):
    """One rank: the scatter path (``moe.moe_apply``). The reference's
    expert-parallel path on a 'model' axis of several ranks is item 11g."""
    return moe.moe_apply(p, cfg, h)


def _positions(cfg, batch, B: int, S: int, device):
    """RoPE's (B, S); M-RoPE's three streams (3, B, S) from the batch,
    by default ``arange`` in each; None for ``pos_kind='none'``."""
    if cfg.pos_kind == 'mrope':
        pos = batch.get('positions')
        if pos is None:
            pos = torch.arange(S, device=device)[None, None].expand(3, B, S)
        return pos
    if cfg.pos_kind == 'rope':
        return torch.arange(S, device=device)[None].expand(B, S)
    return None


def _scale(cfg, x):
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _embed_in(params, cfg, batch):
    """The input sequence: ``batch['embeds']`` (embeds mode) or the
    tokens' rows of the table, scaled by sqrt(d_model) where
    ``cfg.embed_scale``."""
    if cfg.input_mode == 'embeds':
        return _scale(cfg, batch['embeds'])
    return _scale(cfg, L.embed_lookup(params['embed'], batch['tokens']))


def _layers(params, cfg):
    """(params, kind) of every layer in order: the stacked periods, then
    the tail."""
    n_periods, n_tail = split_layers(cfg)
    for i in range(n_periods):
        pp = _layer(params['blocks'], i)
        for j, kind in enumerate(cfg.block_pattern):
            yield pp[f'{j}_{kind}'], kind
    for j in range(n_tail):
        yield params['tail'][str(j)], cfg.block_pattern[j]


def forward(params, cfg, batch, *, mesh=None, sp: bool = False):
    """Logits for a full sequence. batch: {'tokens' | 'embeds',
    ['positions']}. Returns (logits fp32, aux_loss): the MoE router's
    load-balance loss summed over the layers (0 without MoE)."""
    x = _embed_in(params, cfg, batch)
    B, S = x.shape[:2]
    positions = _positions(cfg, batch, B, S, x.device)
    n_periods, n_tail = split_layers(cfg)

    def period(x, aux, pp):
        for j, kind in enumerate(cfg.block_pattern):
            x, a, _ = _apply_block(pp[f'{j}_{kind}'], cfg, kind, x, positions, mesh=mesh,
                                   sp=sp)
            aux = aux if a is None else aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n_periods):
        pp = _layer(params['blocks'], i)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(period, x, aux, pp, use_reentrant=False)
        else:
            x, aux = period(x, aux, pp)
    for j in range(n_tail):
        kind = cfg.block_pattern[j]
        x, a, _ = _apply_block(params['tail'][str(j)], cfg, kind, x, positions, mesh=mesh,
                               sp=sp)
        aux = aux if a is None else aux + a
    x = L.apply_norm(params['final_norm'], x, cfg.norm_eps)
    return _logits(params, cfg, x), aux


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        return L.unembed(params['embed'], x)
    return L.linear(x, params['head']['w']).float()


def loss_fn(params, cfg, batch, *, mesh=None, sp: bool = False):
    logits, aux = forward(params, cfg, batch, mesh=mesh, sp=sp)
    loss = L.softmax_xent(logits, batch['labels'], mask=batch.get('mask'))
    total = loss + cfg.aux_coef * aux
    return total, {'loss': loss, 'aux': aux}


# ---------------------------------------------------------------------------
# Serving: cache plan, prefill, decode
# ---------------------------------------------------------------------------

def _layer_cache_plan(cfg, kind: str, B: int, cap: int) -> Optional[Dict]:
    KH, hd = cfg.num_kv_heads, cfg.head_dim
    cdt = cfg.cache_dtype
    if kind == 'attn':
        return {'k': PSpec((B, cap, KH, hd), ('batch', 'kv_seq', 'kv_heads', None),
                           'zeros', cdt),
                'v': PSpec((B, cap, KH, hd), ('batch', 'kv_seq', 'kv_heads', None),
                           'zeros', cdt)}
    if kind == 'local_attn':
        W = min(cfg.window, cap)
        return {'k': PSpec((B, W, KH, hd), ('batch', None, 'kv_heads', None), 'zeros', cdt),
                'v': PSpec((B, W, KH, hd), ('batch', None, 'kv_heads', None), 'zeros', cdt),
                'kpos': PSpec((W,), (None,), 'neg1', torch.int32)}
    if kind == 'fftconv':
        return None
    if kind == 'ssd':
        di, H, P, N = ssd.ssd_dims(cfg)
        G, w = cfg.ssm_groups, cfg.conv_width
        return {'state': PSpec((B, H, N, P), ('batch', 'heads', None, None), 'zeros',
                               torch.float32),
                'conv_x': PSpec((B, w - 1, di), ('batch', None, 'heads'), 'zeros', cdt),
                'conv_b': PSpec((B, w - 1, G * N), ('batch', None, None), 'zeros', cdt),
                'conv_c': PSpec((B, w - 1, G * N), ('batch', None, None), 'zeros', cdt)}
    if kind == 'rglru':
        w = cfg.conv_width
        return {'h': PSpec((B, cfg.lru_width), ('batch', 'heads'), 'zeros', torch.float32),
                'conv': PSpec((B, w - 1, cfg.lru_width), ('batch', None, 'heads'), 'zeros',
                              cdt)}
    if kind == 'mla':
        return {'latent': PSpec((B, cap, cfg.kv_lora_rank), ('batch', 'kv_seq', 'kv_lora'),
                                'zeros', cdt),
                'krope': PSpec((B, cap, cfg.rope_head_dim), ('batch', 'kv_seq', None),
                               'zeros', cdt)}
    raise ValueError(kind)


def cache_plan(cfg, B: int, cap: int) -> Dict:
    """The caches' shapes and axes. Their dtype here is
    ``cfg.cache_dtype``; the caches that ``prefill`` returns keep the
    dtype they are computed in (fp32 for fp32 parameters), as the
    reference's do."""
    n_periods, tail = split_layers(cfg)
    period = {f'{i}_{kind}': _layer_cache_plan(cfg, kind, B, cap)
              for i, kind in enumerate(cfg.block_pattern)}
    period = {k: v for k, v in period.items() if v is not None}
    plan: Dict[str, Any] = {'blocks': L.stack_plans([period] * n_periods)}
    if tail:
        plan['tail'] = {str(j): _layer_cache_plan(cfg, cfg.block_pattern[j], B, cap)
                        for j in range(tail)}
    return plan


def prefill(params, cfg, batch, *, cache_cap: Optional[int] = None, mesh=None,
            sp: bool = False):
    """Run the prompt; return (last-token logits fp32 (B, 1, V), caches),
    the caches laid out as ``cache_plan``'s."""
    x = _embed_in(params, cfg, batch)
    B, S = x.shape[:2]
    cap = cache_cap or S
    positions = _positions(cfg, batch, B, S, x.device)
    n_periods = split_layers(cfg)[0]
    P = len(cfg.block_pattern)
    blocks: Dict[str, Any] = {}
    out: Dict[str, Any] = {'blocks': blocks}
    for n, (p, kind) in enumerate(_layers(params, cfg)):
        x, _, c = _apply_block(p, cfg, kind, x, positions, mesh=mesh, sp=sp, cache_cap=cap,
                               want_cache=True)
        i, j = divmod(n, P)
        if i < n_periods:            # into the layer-stacked buffers
            if c is None:            # fftconv: no cache
                continue
            key = f'{j}_{kind}'
            if i == 0:
                blocks[key] = L.tree_map(
                    lambda t: t.new_empty((n_periods,) + tuple(t.shape)), c)
            L.tree_map(lambda buf, t: buf[i].copy_(t), blocks[key], c)
        else:
            out.setdefault('tail', {})[str(j)] = c
    x = L.apply_norm(params['final_norm'], x, cfg.norm_eps)
    return _logits(params, cfg, x[:, -1:]), out


def _decode_block(p: Dict, cfg, kind: str, x, cache, cache_len: int):
    h = L.apply_norm(p['norm1'], x, cfg.norm_eps)
    if kind == 'attn':
        y, _, _ = attn.gqa_decode(p[kind], cfg, h, cache['k'], cache['v'], cache_len)
    elif kind == 'local_attn':
        y, _ = attn.gqa_decode_ring(p[kind], cfg, h, cache, cache_len, window=cfg.window)
    elif kind == 'ssd':
        y, _ = ssd.ssd_decode(p[kind], cfg, h, cache)
    elif kind == 'mla':
        y, _, _ = attn.mla_decode(p[kind], cfg, h, cache['latent'], cache['krope'], cache_len)
    elif kind == 'rglru':
        y, _ = griffin.rglru_decode(p[kind], cfg, h, cache)
    else:
        raise ValueError(kind)
    return _ffn(p, cfg, x + y)[0]           # decode discards the router's aux loss


def decode_step(params, cfg, caches, tokens, cache_len: int):
    """One-token decode. tokens: (B, 1) int; cache_len: the number of
    tokens already in the cache. Updates ``caches`` in place and returns
    (logits fp32 (B, 1, V), caches). An embeds-mode config continues in
    text, through ``params['embed']``."""
    x = _scale(cfg, L.embed_lookup(params['embed'], tokens))
    n_periods = split_layers(cfg)[0]
    P = len(cfg.block_pattern)
    for n, (p, kind) in enumerate(_layers(params, cfg)):
        i, j = divmod(n, P)
        if i < n_periods:
            cache = _layer(caches['blocks'][f'{j}_{kind}'], i)
        else:
            cache = caches['tail'][str(j)]
        x = _decode_block(p, cfg, kind, x, cache, cache_len)
    x = L.apply_norm(params['final_norm'], x, cfg.norm_eps)
    return _logits(params, cfg, x), caches
