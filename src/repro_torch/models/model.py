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

With ``rules`` over a ('data', 'model') mesh (the sharded server,
``repro_torch.serve.engine``) ``forward``, ``prefill`` and
``decode_step`` run on this rank's blocks of the parameters and caches
and on its batch block: attention, MLA and the MLP tensor-parallel, the
embedding and the head vocab-parallel (the logits gathered whole), the
MoE feed-forward expert-parallel (``moe.moe_ep_explicit``), the SSD's,
RG-LRU's and FFT-conv mixer's sharded leaves gathered at use
(``GATHERED_KINDS``). The caches are laid out as :func:`cache_axes`
says. On a 1 x 1 mesh every step is the one-rank step.

With the train rules (the sharded trainer, ``repro_torch.train``)
every leaf is also cut over 'data' on its 'embed' dimension (FSDP):
``forward`` gathers each period's leaves into their serve-rule blocks
inside the period's ``torch.utils.checkpoint`` (remat gathers them
again in the backward, and no rank holds more than one period whole),
the embedding, head and final norm at use; an expert-parallel MoE
layer's expert weights are gathered inside ``moe.moe_ep_explicit``
(``fsdp_axes``), as the reference's. Each gather's backward is a
reduce-scatter over 'data' (``parallel.sharding``'s rule). The FFT-conv
mixer runs its one-rank plan on each rank's batch block.
:func:`loss_fn` gives the reference's global token mean and MoE aux
loss, and the gradient of each rank's share of them.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import comm
from repro_torch.models import attention as attn
from repro_torch.models import griffin, moe, ssd
from repro_torch.models import layers as L
from repro_torch.models.layers import PSpec
from repro_torch.parallel.sharding import (DataParallel, Parallel, gather_fsdp, local_shape,
                                           spec_for)

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

#: the mixers computed whole on every rank of a 'model' group: their
#: sharded leaves are gathered at use, a layer at a time
GATHERED_KINDS = {'ssd': ssd.ssd_plan, 'rglru': griffin.rglru_plan,
                  'fftconv': ssd.fftconv_plan}


def _parallel(rules, mesh) -> Optional[Parallel]:
    """The model code's view of a run under ``rules`` (None: one rank, or
    a 'model' group of one: every step is then the one-rank step). A
    sharded run's mesh is ``rules.mesh``; ``mesh`` is None or that mesh
    (the reference passes both), else the FFT-conv mixer's plan mesh of
    a one-rank run."""
    if rules is not None and mesh is not None and mesh is not rules.mesh:
        raise ValueError("a sharded run's mesh is rules.mesh; mesh= is that mesh or the "
                         "FFT-conv mixer's plan mesh of a one-rank run")
    return Parallel.of(rules)


@functools.lru_cache(maxsize=None)
def _one_rank_mesh(device: torch.device):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(1, 1, device=device.type)


def _plan_mesh(rules, mesh):
    """The FFT-conv mixer's plan mesh: ``mesh`` on one rank (or a 1 x 1
    mesh), a one-rank mesh on each rank's device for a sharded run given
    its mesh (the trainer: each rank transforms its batch block through
    the kernels), None for a sharded run without it (the server: the
    local real-pencil path)."""
    if rules is None or mesh is None or mesh.size == 1:
        return mesh
    return _one_rank_mesh(mesh.device)


def _fsdp(rules) -> bool:
    """Whether ``rules`` cut the leaves over an FSDP group of several ranks."""
    fs = None if rules is None else rules.fsdp_axes
    return fs is not None and comm.group_size(rules.mesh, fs) > 1


def _gather_layer(p: Dict, cfg, kind: str, rules, par):
    """One layer's leaves gathered over the FSDP axes into their
    serve-rule blocks (``p`` itself without FSDP). An expert-parallel MoE
    layer's expert weights stay cut: ``moe_ep_explicit`` gathers them."""
    if not _fsdp(rules):
        return p
    plan = layer_plan(cfg, kind)
    if par is None or 'moe' not in p:
        return gather_fsdp(p, plan, rules)
    keep = ('wi', 'wo')
    rest = {**p, 'moe': {k: v for k, v in p['moe'].items() if k not in keep}}
    rplan = {**plan, 'moe': {k: v for k, v in plan['moe'].items() if k not in keep}}
    out = gather_fsdp(rest, rplan, rules)
    out['moe'].update({k: p['moe'][k] for k in keep})
    return out


def _gather_top(params, cfg, rules):
    """The embedding, head and final norm gathered over the FSDP axes
    (``params`` itself without FSDP)."""
    if not _fsdp(rules):
        return params
    plan = model_plan(cfg)
    names = [k for k in ('embed', 'head', 'final_norm') if k in params]
    return {**params, **gather_fsdp({k: params[k] for k in names}, {k: plan[k] for k in names},
                                    rules)}


def _mixer(p: Dict, cfg, kind: str, par):
    """A gathered-at-use mixer's weights whole on this rank."""
    if par is None or kind not in GATHERED_KINDS:
        return p
    return L.tree_map(lambda t, s: par.whole(t, s.shape, s.axes), p, GATHERED_KINDS[kind](cfg))


def _apply_block(p: Dict, cfg, kind: str, x, positions, *, mesh=None, sp: bool = False,
                 cache_cap: Optional[int] = None, want_cache: bool = False, par=None,
                 dp=None, fsdp_axes=None):
    """One residual block (temporal + optional FFN). Returns
    (x, aux-loss-or-None, cache-or-None); ``fftconv`` has no cache, and
    only the MoE feed-forward has an aux loss. ``mesh``: the FFT-conv
    mixer's plan mesh (None: the local real-pencil path); ``par``: a
    sharded run's view (``parallel.Parallel``), None on one rank;
    ``dp``, ``fsdp_axes``: a training run's batch group
    (``parallel.DataParallel``) and the FSDP axes of its expert weights."""
    h = L.apply_norm(p['norm1'], x, cfg.norm_eps)
    cache = None
    pk = _mixer(p[kind], cfg, kind, par)
    if kind in ('attn', 'local_attn'):
        window = cfg.window if kind == 'local_attn' else 0
        if want_cache:
            y, cache = attn.gqa_prefill(pk, cfg, h, positions, window=window,
                                        cache_cap=cache_cap, sp=sp, par=par)
        else:
            y = attn.gqa_apply(pk, cfg, h, positions, window=window, sp=sp, par=par)
    elif kind == 'mla':
        if want_cache:
            y, cache = attn.mla_prefill(pk, cfg, h, positions, cache_cap=cache_cap, par=par)
        else:
            y = attn.mla_apply(pk, cfg, h, positions, par=par)
    elif kind == 'ssd':
        out = ssd.ssd_apply(pk, cfg, h, return_cache=want_cache)
        y, cache = out if want_cache else (out, None)
    elif kind == 'rglru':
        out = griffin.rglru_apply(pk, cfg, h, return_cache=want_cache)
        y, cache = out if want_cache else (out, None)
    elif kind == 'fftconv':
        y = ssd.fftconv_apply(pk, cfg, h, mesh=mesh)
    else:
        raise ValueError(kind)
    x, aux = _ffn(p, cfg, x + y, par, dp, fsdp_axes)
    return x, aux, cache


def _ffn(p: Dict, cfg, x, par=None, dp=None, fsdp_axes=None):
    """The block's feed-forward and its residual: (x, the MoE router's
    aux loss, or None for an MLP or no feed-forward)."""
    fk = ffn_kind(cfg)
    if fk is None:
        return x, None
    h = L.apply_norm(p['norm2'], x, cfg.norm_eps)
    if fk == 'mlp':
        return x + L.apply_mlp(p['mlp'], h, act=cfg.act, par=par), None
    y, aux = _moe_ffn(p['moe'], cfg, h, par, dp, fsdp_axes)
    return x + y, aux


def _moe_ffn(p: Dict, cfg, h, par=None, dp=None, fsdp_axes=None):
    """A 'model' axis of several ranks: the expert-parallel path
    (``moe.moe_ep_explicit``), as the reference's; else the scatter path
    (``moe.moe_apply``)."""
    if par is not None:
        return moe.moe_ep_explicit(p, cfg, h, par, fsdp_axes=fsdp_axes, dp=dp)
    return moe.moe_apply(p, cfg, h, dp)


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


def _vocab_tp(cfg, par) -> bool:
    """Whether the table and head are vocab-parallel (``spec_for`` cuts
    'vocab' where the 'model' group divides it)."""
    return par is not None and cfg.vocab_size % par.tp == 0


def _embed(params, cfg, ids, par):
    if _vocab_tp(cfg, par):
        return L.embed_lookup_tp(params['embed'], ids, par)
    return L.embed_lookup(params['embed'], ids)


def _embed_in(params, cfg, batch, par=None):
    """The input sequence: ``batch['embeds']`` (embeds mode) or the
    tokens' rows of the table, scaled by sqrt(d_model) where
    ``cfg.embed_scale``."""
    if cfg.input_mode == 'embeds':
        return _scale(cfg, batch['embeds'])
    return _scale(cfg, _embed(params, cfg, batch['tokens'], par))


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


def _trunk(params, cfg, batch, *, rules=None, mesh=None, sp: bool = False):
    """Every layer and the final norm: (x, aux, top, par), ``top`` the
    embedding and head as the logits take them (gathered over the FSDP
    axes under the train rules)."""
    par = _parallel(rules, mesh)
    dp = DataParallel.of(rules)
    plan_mesh = _plan_mesh(rules, mesh)
    fsdp_axes = rules.fsdp_axes if _fsdp(rules) else None
    top = _gather_top(params, cfg, rules)
    x = _embed_in(top, cfg, batch, par)
    B, S = x.shape[:2]
    positions = _positions(cfg, batch, B, S, x.device)
    n_periods, n_tail = split_layers(cfg)

    def block(p, kind, x, aux):
        p = _gather_layer(p, cfg, kind, rules, par)
        x, a, _ = _apply_block(p, cfg, kind, x, positions, mesh=plan_mesh, sp=sp, par=par,
                               dp=dp, fsdp_axes=fsdp_axes)
        return x, aux if a is None else aux + a

    def period(x, aux, pp):
        for j, kind in enumerate(cfg.block_pattern):
            x, aux = block(pp[f'{j}_{kind}'], kind, x, aux)
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
        x, aux = block(params['tail'][str(j)], cfg.block_pattern[j], x, aux)
    x = L.apply_norm(top['final_norm'], x, cfg.norm_eps)
    return x, aux, top, par


def forward(params, cfg, batch, *, rules=None, mesh=None, sp: bool = False):
    """Logits for a full sequence. batch: {'tokens' | 'embeds',
    ['positions']}. Returns (logits fp32, aux_loss): the MoE router's
    load-balance loss summed over the layers (0 without MoE).

    ``mesh``: the FFT-conv mixer's plan mesh (one rank). With ``rules``
    the run is sharded over ``rules.mesh``, the ('data', 'model') mesh
    (``mesh`` None or that mesh): ``params`` are this rank's blocks and
    ``batch`` its batch block; the logits are whole over the vocabulary,
    and the aux loss is this batch block's (under the train rules with
    several 'data' ranks, this rank's share of the global batch's,
    ``moe.aux_loss``)."""
    x, aux, top, par = _trunk(params, cfg, batch, rules=rules, mesh=mesh, sp=sp)
    return _logits(top, cfg, x, par), aux


def _logits(params, cfg, x, par=None, *, gather: bool = True):
    """fp32 logits; vocab-parallel on a mesh (``x`` entering the split),
    gathered over 'model' unless ``gather`` is False (this rank's block
    of the vocabulary)."""
    vocab_tp = _vocab_tp(cfg, par)
    if vocab_tp:
        x = par.enter(x)
    if cfg.tie_embeddings:
        logits = L.unembed(params['embed'], x)
    else:
        logits = L.linear(x, params['head']['w']).float()
    if vocab_tp and gather:
        logits = par.gather(logits, logits.dim() - 1)
    return logits


def loss_fn(params, cfg, batch, *, rules=None, mesh=None, sp: bool = False):
    """(total loss, {'loss': mean token cross-entropy, 'aux': the MoE
    aux loss}), as the reference's. ``rules``, ``mesh``: as
    :func:`forward`'s.

    With ``rules`` each rank holds its batch block: the cross-entropy
    is the global token mean over the batch group (a ``mask``'s sum is
    reduced too) and the aux loss the global batch's, the same value on
    every rank. Each is the group's sum of the ranks' shares
    (``DataParallel.sum``, whose backward passes the cotangent through),
    so each rank differentiates its own share and the sum over 'data'
    of the ranks' gradients is the whole gradient
    (``parallel.reduce_data_parallel``). Where the vocabulary is split
    over 'model' the cross-entropy is vocab-parallel
    (``layers.token_nll``): no rank gathers the logits."""
    labels, mask = batch['labels'], batch.get('mask')
    dp = DataParallel.of(rules)
    x, aux, top, par = _trunk(params, cfg, batch, rules=rules, mesh=mesh, sp=sp)
    nll = L.token_nll(_logits(top, cfg, x, par, gather=False), labels,
                      par if _vocab_tp(cfg, par) else None)
    if mask is None:
        num, count = nll.sum(), nll.numel() * (1 if dp is None else dp.size)
    else:
        mask = mask.float()
        num, count = (nll * mask).sum(), mask.sum()
        count = torch.clamp(count if dp is None else dp.sum(count), min=1.0)
    loss = num / count
    if dp is not None:
        loss, aux = dp.sum(loss), dp.sum(aux)
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


def init_cache(cfg, B: int, cap: int, *, rules=None, device='cpu'):
    """Empty caches (zeros; the ring's positions -1) in ``cfg.cache_dtype``:
    whole on ``device``, or with ``rules`` this rank's blocks of
    :func:`cache_axes`'s layout on ``rules.mesh``'s device."""
    if rules is not None:
        device = rules.mesh.device

    def fill(p: PSpec, axes):
        shape = p.shape
        if rules is not None:
            shape = local_shape(shape, spec_for(rules, shape, axes), rules.mesh)
        return torch.full(shape, -1 if p.init == 'neg1' else 0,
                          dtype=p.dtype or cfg.cache_dtype, device=device)
    return L.tree_map(fill, cache_plan(cfg, B, cap), cache_axes(cfg, B, cap))


def abstract_cache(cfg, B: int, cap: int):
    """The whole caches on the ``meta`` device (``cfg.cache_dtype``)."""
    return L.abstract_from_plan(cache_plan(cfg, B, cap), cfg.cache_dtype)


#: logical axes of the reference's cache layout that the port does not
#: shard: the attention caches are laid out by heads, not by 'kv_seq',
#: and the gathered-at-use mixers' states are computed whole
_CACHE_UNSHARDED = ('kv_seq', 'heads')


def cache_axes(cfg, B: int, cap: int):
    """The logical axes of the port's caches, the layout it keeps them in
    on a mesh: the reference's (``cache_plan``) with 'kv_seq' and 'heads'
    unsharded. A rank's attention cache holds its kv heads (all of them
    where the 'model' group does not divide them), MLA's the whole latent,
    the SSD's and RG-LRU's the whole state: batch over 'data' only."""
    return L.tree_map(lambda p: tuple(None if a in _CACHE_UNSHARDED else a for a in p.axes),
                      cache_plan(cfg, B, cap))


def prefill(params, cfg, batch, *, cache_cap: Optional[int] = None, rules=None, mesh=None,
            sp: bool = False):
    """Run the prompt; return (last-token logits fp32 (B, 1, V), caches),
    the caches laid out as ``cache_plan``'s (with ``rules``: this rank's
    blocks of :func:`cache_axes`'s layout, ``params`` and ``batch`` its
    blocks; ``rules`` and ``mesh`` as :func:`forward`'s)."""
    par = _parallel(rules, mesh)
    x = _embed_in(params, cfg, batch, par)
    B, S = x.shape[:2]
    cap = cache_cap or S
    positions = _positions(cfg, batch, B, S, x.device)
    n_periods = split_layers(cfg)[0]
    P = len(cfg.block_pattern)
    blocks: Dict[str, Any] = {}
    out: Dict[str, Any] = {'blocks': blocks}
    for n, (p, kind) in enumerate(_layers(params, cfg)):
        x, _, c = _apply_block(p, cfg, kind, x, positions, mesh=mesh, sp=sp, cache_cap=cap,
                               want_cache=True, par=par)
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
    return _logits(params, cfg, x[:, -1:], par), out


def _decode_block(p: Dict, cfg, kind: str, x, cache, cache_len: int, par=None):
    if kind not in ('attn', 'local_attn', 'ssd', 'mla', 'rglru'):
        raise ValueError(kind)
    h = L.apply_norm(p['norm1'], x, cfg.norm_eps)
    pk = _mixer(p[kind], cfg, kind, par)
    if kind == 'attn':
        y, _, _ = attn.gqa_decode(pk, cfg, h, cache['k'], cache['v'], cache_len, par=par)
    elif kind == 'local_attn':
        y, _ = attn.gqa_decode_ring(pk, cfg, h, cache, cache_len, window=cfg.window, par=par)
    elif kind == 'ssd':
        y, _ = ssd.ssd_decode(pk, cfg, h, cache)
    elif kind == 'mla':
        y, _, _ = attn.mla_decode(pk, cfg, h, cache['latent'], cache['krope'], cache_len,
                                  par=par)
    elif kind == 'rglru':
        y, _ = griffin.rglru_decode(pk, cfg, h, cache)
    else:
        raise ValueError(kind)
    return _ffn(p, cfg, x + y, par)[0]      # decode discards the router's aux loss


def decode_step(params, cfg, caches, tokens, cache_len: int, *, rules=None):
    """One-token decode. tokens: (B, 1) int; cache_len: the number of
    tokens already in the cache. Updates ``caches`` in place and returns
    (logits fp32 (B, 1, V), caches). An embeds-mode config continues in
    text, through ``params['embed']``. With ``rules``: this rank's blocks
    of the parameters, caches and tokens, as :func:`prefill`'s."""
    par = Parallel.of(rules)
    x = _scale(cfg, _embed(params, cfg, tokens, par))
    n_periods = split_layers(cfg)[0]
    P = len(cfg.block_pattern)
    for n, (p, kind) in enumerate(_layers(params, cfg)):
        i, j = divmod(n, P)
        if i < n_periods:
            cache = _layer(caches['blocks'][f'{j}_{kind}'], i)
        else:
            cache = caches['tail'][str(j)]
        x = _decode_block(p, cfg, kind, x, cache, cache_len, par)
    x = L.apply_norm(params['final_norm'], x, cfg.norm_eps)
    return _logits(params, cfg, x, par), caches
