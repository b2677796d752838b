"""Attention: flash-chunked GQA, sliding-window attention and MLA for
full sequences, prefill and decode.

Port of ``repro.models.attention``. ``flash_attention`` is the
reference's online-softmax algorithm in plain PyTorch: an outer loop
over ``q_chunk`` query blocks, an inner loop over ``chunk`` KV chunks,
fp32 accumulators, GQA through a (kv_heads, group) head split so
repeated KV is never materialized. Every masked block is
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

MLA (DeepSeek-V2, :func:`mla_apply`): queries and keys from low-rank
projections, RoPE on a decoupled slice of each head, and the key's
roped slice shared by every head. Its decode cache is the compressed
one, the normalized latent and the shared roped key of each token,
written in place; each decode step decompresses the whole cache, as the
reference's (no absorbed-weight decode).

On a mesh (``par``, a :class:`repro_torch.parallel.Parallel` whose
'model' group has several ranks) attention is tensor-parallel over
heads: ``wq`` (and ``wk``/``wv`` where the kv heads divide the group)
column-parallel, so each rank attends with its H/p query heads, ``wo``
row-parallel and summed (``all_reduce``). Where the kv heads do not
divide the group (MQA: recurrentgemma-9b's one kv head) ``wk``/``wv``
are gathered at use, every rank computes all kv heads, its cache keeps
them all, and it attends with the ones its query heads pair with. MLA
shards ``wq_b``, ``wkv_b`` and ``wo`` by heads; its latent is computed
whole. Decode caches are laid out by heads (each rank its kv heads),
not by the reference's ``kv_seq``. For training, what every rank holds
alike enters the heads split through ``par.enter`` (the block's input;
MLA's normalized low-rank query, latent and roped key), and MQA's
gathered ``wk``/``wv`` are reduce-scattered in the backward
(``parallel.sharding``'s rule).

Where the group does not divide the query heads (qwen1.5-32b's 40 and
qwen2-vl-2b's 12 over 16 ranks) rank r of 'model' owns the contiguous
query heads :func:`head_range`, ``[rH/p, (r+1)H/p)`` in floors, and the
kv heads they pair with (:func:`kv_head_range`). Its weights stay the
reference's even blocks at rest: at use ``wq`` (and its bias), ``wk``,
``wv`` and ``wo`` are gathered a layer at a time (each rank uses them
apart: the backward is a reduce-scatter) and narrowed to the rank's
head columns of ``wq``/``wk``/``wv`` and rows of ``wo``. The output
stays row-parallel; a rank that owns no head (12 heads over 16) adds
zeros to the sum. Its cache keeps its own kv heads. MLA's ``wq_b``,
``wkv_b`` and ``wo`` follow the same rule.

Sequence parallelism (``sp=True``): :func:`ulysses_attention`, the
reference's, on this rank's sequence block, through ``comm.swap_axes``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import comm
from repro_torch.comm import overlap as ov
from repro_torch.core.fft1d import full_fp32_matmul
from repro_torch.models import layers as L

NEG_INF = -1e30


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
    G = H // KH if KH else 1          # a rank that owns no head: empty, still in the graph
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
        # the score block is masked and exponentiated in place, and each
        # block is dropped before the next: at most two (B, H, q, k) fp32
        # blocks are alive (4 GiB each for deepseek-v2-236b's 128 heads
        # at 8 x 1024 x 1024), the values those of the out-of-place ops
        s.masked_fill_(~mask, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.sub(s, m_cur[..., None]).exp_()
        del s
        corr = torch.exp(m - m_cur)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum('bhgqk,bkhd->bhgqd', p, vc)
        del p
        m = m_cur
    out = acc / torch.clamp(l[..., None], min=1e-30)      # (B, KH, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(out_dtype)


def _cache_pad(cache_cap: Optional[int], S: int) -> int:
    """Positions a dense cache adds past a prompt of ``S``. A cache
    shorter than the prompt raises ``ValueError``, as the reference's
    ``jnp.pad`` does (``F.pad`` would crop it)."""
    cap = cache_cap or S
    if cap < S:
        raise ValueError(f'cache_cap {cap} is shorter than the prompt ({S} positions)')
    return cap - S


# ---------------------------------------------------------------------------
# Ulysses sequence parallelism (the FFT's ownership swap)
# ---------------------------------------------------------------------------

def ulysses_attention(q, k, v, mesh, *, seq_axis: str = 'model', causal: bool = True,
                      window: int = 0, chunk: int = 1024, comm_strategy: str = 'all_to_all',
                      overlap_chunks: int = 1) -> torch.Tensor:
    """Attention over sequence-sharded activations: q, k, v are this
    rank's (B, S/p, heads, D) sequence block over ``seq_axis``; so is the
    result.

    One ownership swap (``comm.swap_axes``, any registered
    ``comm_strategy``) re-shards heads instead of sequence, attention
    runs over the whole sequence with H/p heads, a second swap restores
    the sequence blocks. KV heads that the group does not divide are
    gathered over the sequence instead, and each rank attends with the
    kv heads its query-head block pairs with (MQA/GQA fallback).
    ``overlap_chunks > 1`` pipelines exchange, attention and exchange
    over head groups where both H and KH divide ``overlap_chunks * p``."""
    p = comm.group_size(mesh, seq_axis)
    H, KH = q.shape[-2], k.shape[-2]
    if H % p:
        raise ValueError(f'{H} heads not divisible by SP degree {p}')
    # 'auto' means the default schedule here, not cost selection
    strategy = comm.resolve(comm_strategy)

    def swap_in(t):    # seq (axis -3) sharded -> heads (axis -2) sharded
        return strategy.swap_axes(t, mesh, seq_axis, shard_pos=t.ndim - 3, mem_pos=t.ndim - 2)

    def swap_out(t):   # heads sharded -> seq sharded
        return strategy.swap_axes(t, mesh, seq_axis, shard_pos=t.ndim - 2, mem_pos=t.ndim - 3)

    if overlap_chunks > 1 and H % (overlap_chunks * p) == 0 and KH % (overlap_chunks * p) == 0:
        # q, k, v chunked by the SAME head groups, so the positional GQA
        # pairing inside each chunk is the global one
        def stage(qc, kc, vc):
            o = flash_attention(swap_in(qc), swap_in(kc), swap_in(vc), causal=causal,
                                window=window, chunk=chunk)
            return swap_out(o)
        return ov.pipelined(overlap_chunks, q.ndim - 2, stage, q, k, v)
    ql = swap_in(q)
    if KH % p == 0:
        kl, vl = swap_in(k), swap_in(v)
    else:
        # gather the sequence, then the kv head(s) this rank's contiguous
        # q-head block maps to: pairing local q heads positionally with the
        # gathered kv axis would scramble the GQA grouping
        # each rank attends with its own kv heads of the gathered sequence
        kl = comm.all_gather(k, mesh, seq_axis, k.ndim - 3, alike=False)
        vl = comm.all_gather(v, mesh, seq_axis, v.ndim - 3, alike=False)
        kl, vl = _kv_block(kl, vl, H, comm.group_index(mesh, seq_axis), p)
    o = flash_attention(ql, kl, vl, causal=causal, window=window, chunk=chunk)
    return swap_out(o)


def head_range(H: int, p: int, index: int) -> Tuple[int, int]:
    """The query heads ``[lo, hi)`` that rank ``index`` of a group of
    ``p`` owns: ``[index H/p, (index+1) H/p)`` in floors. Where ``p``
    does not divide ``H`` the counts differ by one, and some are 0 where
    ``p > H``."""
    return index * H // p, (index + 1) * H // p


def kv_head_range(H: int, KH: int, p: int, index: int) -> Tuple[int, int]:
    """The kv heads ``[lo, hi)`` that :func:`head_range`'s query heads
    pair with (query head h with kv head h // (H / KH)); empty where the
    rank owns no query head."""
    lo, hi = head_range(H, p, index)
    G = H // KH
    return (lo // G, lo // G) if hi == lo else (lo // G, (hi - 1) // G + 1)


def _pair(k, v, H: int, KH: int, index: int, p: int):
    """``k``, ``v`` holding the kv heads :func:`kv_head_range` (axis -2),
    in the order ``flash_attention`` pairs them with the query heads
    :func:`head_range` (local query head j with local kv head
    j // (Hl / KHl)): as they are where that is each query head's kv
    head, else one kv head a query head (``index_select``; a range that
    starts or ends inside a GQA group)."""
    lo, hi = head_range(H, p, index)
    klo, khi = kv_head_range(H, KH, p, index)
    Hl, KHl, G = hi - lo, khi - klo, H // KH
    want = [(lo + j) // G - klo for j in range(Hl)]
    if Hl == 0 or (Hl % KHl == 0 and want == [j // (Hl // KHl) for j in range(Hl)]):
        return k, v
    idx = torch.tensor(want, device=k.device)
    return k.index_select(-2, idx), v.index_select(-2, idx)


def _kv_block(k, v, H: int, index: int, p: int):
    """Of ``k``, ``v`` holding every kv head (axis -2), those that query
    heads :func:`head_range` pair with, in ``flash_attention``'s order
    (:func:`_pair`)."""
    KH = k.shape[-2]
    klo, khi = kv_head_range(H, KH, p, index)
    return _pair(k.narrow(-2, klo, khi - klo), v.narrow(-2, klo, khi - klo), H, KH, index, p)


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


def uneven_heads(cfg, par) -> bool:
    """Whether the 'model' group of ``par`` does not divide the query
    heads: each rank then owns :func:`head_range`."""
    return par is not None and cfg.num_heads % par.tp != 0


def _kv_whole(par, cfg) -> bool:
    """Whether this rank computes every kv head: the 'model' group
    divides the query heads but not the kv heads (the reference's
    ``spec_for`` may still cut ``wk``'s flattened column inside a head,
    so it is gathered at use)."""
    return par is not None and cfg.num_kv_heads % par.tp != 0 and not uneven_heads(cfg, par)


def _apart(par, t, shape, axes):
    """A leaf whole at use, which each rank uses apart (its heads): its
    blocks gathered (backward: a reduce-scatter), or where the rules do
    not cut it, the leaf entering the split (backward: the group's sum)."""
    if any(par.spec(shape, axes)):
        return par.whole(t, shape, axes, alike=False)
    return par.enter(t)


def _head_weights(p: Dict, par, cuts) -> Dict:
    """``p`` with each leaf named in ``cuts`` (name -> (the whole
    weight's shape, its logical axes, its head axis, the rank's heads
    (lo, hi), the width of a head)) gathered whole at use
    (:func:`_apart`) and narrowed to the rank's heads (all of them: kept
    whole); a bias along the head axis too."""
    out = dict(p)
    for name, (shape, axes, dim, (lo, hi), hw) in cuts.items():
        leaf = dict(p[name])
        for key, t in p[name].items():
            sh, ax = (shape, axes) if key == 'w' else ((shape[dim],), (axes[dim],))
            d = dim if key == 'w' else 0
            w = _apart(par, t, sh, ax)
            leaf[key] = w if (hi - lo) * hw == w.shape[d] else w.narrow(d, lo * hw, (hi - lo) * hw)
        out[name] = leaf
    return out


def _gqa_weights(p: Dict, cfg, par) -> Dict:
    """The block's weights as this rank computes with them: its blocks,
    with ``wk``/``wv`` gathered where it computes every kv head (and
    attends with its own: the gathers' backward is a reduce-scatter),
    and ``wq``, ``wk``, ``wv`` gathered and narrowed to its heads where
    the group does not divide the query heads (``wo``: :func:`_out`)."""
    uneven = uneven_heads(cfg, par)
    if not (uneven or _kv_whole(par, cfg)):
        return p
    d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kr = kv_head_range(H, KH, par.tp, par.tp_index) if uneven else (0, KH)
    cuts = {name: ((d, KH * hd), ('embed', 'kv_heads'), 1, kr, hd) for name in ('wk', 'wv')}
    if uneven:
        cuts['wq'] = ((d, H * hd), ('embed', 'heads'), 1, head_range(H, par.tp, par.tp_index), hd)
    return _head_weights(p, par, cuts)


def _heads(t, width: int):
    """(B, S, heads * width) -> (B, S, heads, width); no ``-1``, which a
    rank that owns no head (0 elements) cannot reshape."""
    return t.reshape(*t.shape[:-1], t.shape[-1] // width, width)


def gqa_qkv(p: Dict, cfg, x, positions):
    """Project + rope. x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KH,hd): the
    heads of the weights given (a rank's blocks on a mesh)."""
    hd = cfg.head_dim
    q, k, v = (_heads(L.apply_linear(p[n], x), hd) for n in ('wq', 'wk', 'wv'))
    if cfg.pos_kind == 'mrope':
        q = L.apply_mrope(q, positions, theta=cfg.rope_theta, sections=cfg.mrope_sections)
        k = L.apply_mrope(k, positions, theta=cfg.rope_theta, sections=cfg.mrope_sections)
    elif cfg.pos_kind == 'rope':
        q = L.apply_rope(q, positions, theta=cfg.rope_theta)
        k = L.apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _attend_kv(k, v, cfg, par):
    """The kv heads this rank attends with: all it holds; where it holds
    every kv head on a mesh, those its query heads pair with; where it
    owns an uneven head range, its own paired with its query heads."""
    if uneven_heads(cfg, par):
        return _pair(k, v, cfg.num_heads, cfg.num_kv_heads, par.tp_index, par.tp)
    if not _kv_whole(par, cfg):
        return k, v
    return _kv_block(k, v, cfg.num_heads, par.tp_index, par.tp)


def _out(p: Dict, o, cfg, par):
    """The output projection of (B, S, heads, D): row-parallel on a mesh;
    where the group does not divide the heads, ``wo`` gathered at use and
    narrowed to the rows of this rank's :func:`head_range`."""
    B, S, Hl, D = o.shape
    if uneven_heads(cfg, par):
        H = cfg.num_heads
        p = _head_weights(p, par, {'wo': ((H * D, cfg.d_model), ('heads', 'embed'), 0,
                                          head_range(H, par.tp, par.tp_index), D)})
    return L.row_parallel(o.reshape(B, S, Hl * D), p['wo']['w'], par)


def _gqa_sp(p: Dict, cfg, x, positions, *, window: int, par):
    """``sp=True`` on a mesh: this rank's sequence block projected with
    the whole (gathered) weights, :func:`ulysses_attention`, the output
    projection, and the blocks gathered over the sequence. Returns the
    output and the whole sequence's k, v (every kv head). Each rank uses
    the weights and ``x`` on its own sequence block: the gathers'
    backward is a reduce-scatter, and ``x`` enters the split."""
    if x.shape[1] % par.tp:
        raise ValueError(f'sequence {x.shape[1]} not divisible by SP degree {par.tp}')
    whole = L.tree_map(lambda t, s: par.whole(t, s.shape, s.axes, alike=False), p,
                       gqa_plan(cfg))
    xl = par.block(par.enter(x), 1)
    pos = None if positions is None else par.block(positions, positions.dim() - 1)
    q, k, v = gqa_qkv(whole, cfg, xl, pos)
    o = ulysses_attention(q, k, v, par.mesh, causal=cfg.causal, window=window,
                          chunk=cfg.attn_chunk)
    y = L.linear(o.reshape(o.shape[0], o.shape[1], -1), whole['wo']['w'])
    return par.gather(y, 1), par.gather(k, 1), par.gather(v, 1)


def _cache_heads(k, v, cfg, par):
    """The kv heads a rank's cache keeps of every head's k, v: its block
    where the group divides them, else all."""
    if par is None or _kv_whole(par, cfg):
        return k, v
    return par.block(k, 2), par.block(v, 2)


def gqa_apply(p: Dict, cfg, x, positions, *, window: int = 0, sp: bool = False, par=None):
    """Full-sequence (train/prefill) GQA attention. On a mesh ``x``
    enters the heads split (``par.enter``)."""
    if sp and par is not None:
        return _gqa_sp(p, cfg, x, positions, window=window, par=par)[0]
    if par is not None:
        x = par.enter(x)
    q, k, v = gqa_qkv(_gqa_weights(p, cfg, par), cfg, x, positions)
    k, v = _attend_kv(k, v, cfg, par)
    o = flash_attention(q, k, v, causal=cfg.causal, window=window, chunk=cfg.attn_chunk)
    return _out(p, o, cfg, par)


def gqa_prefill(p: Dict, cfg, x, positions, *, window: int = 0,
                cache_cap: Optional[int] = None, sp: bool = False, par=None):
    """Full-sequence attention that also returns the decode cache, k and
    v in their own dtype. Dense (``window`` 0): zero-padded to
    ``cache_cap`` positions. Windowed: the ring cache of the last
    ``W = min(window, cache_cap)`` tokens, slot ``pos % W``, with their
    positions in ``kpos`` (-1 where a prompt shorter than W leaves a slot
    empty). On a mesh the cache holds this rank's kv heads."""
    B, S, _ = x.shape
    if sp and par is not None:
        out, k, v = _gqa_sp(p, cfg, x, positions, window=window, par=par)
        k, v = _cache_heads(k, v, cfg, par)
    else:
        if par is not None:
            x = par.enter(x)
        q, k, v = gqa_qkv(_gqa_weights(p, cfg, par), cfg, x, positions)
        o = flash_attention(q, *_attend_kv(k, v, cfg, par), causal=cfg.causal, window=window,
                            chunk=cfg.attn_chunk)
        out = _out(p, o, cfg, par)
    if not window:
        pad = _cache_pad(cache_cap, S)
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


def gqa_decode_ring(p: Dict, cfg, x, cache: Dict, cache_len: int, *, window: int, par=None):
    """One-token decode against the sliding-window ring cache
    {'k', 'v': (B, W, KH, hd), 'kpos': (W,) int32}.

    Writes the new k, v and position at slot ``cache_len % W`` IN PLACE
    (the reference's engine donates its caches) and returns (out, cache)."""
    B = x.shape[0]
    W = cache['k'].shape[1]
    q, k, v = gqa_qkv(_gqa_weights(p, cfg, par), cfg, x,
                      torch.full((B, 1), cache_len, device=x.device))
    slot = cache_len % W
    cache['k'][:, slot] = k[:, 0]
    cache['v'][:, slot] = v[:, 0]
    cache['kpos'][slot] = cache_len
    o = flash_attention(q, *_attend_kv(cache['k'], cache['v'], cfg, par), causal=True,
                        window=window, q_offset=cache_len, kv_positions=cache['kpos'], chunk=W)
    return _out(p, o, cfg, par), cache


def gqa_decode(p: Dict, cfg, x, cache_k, cache_v, cache_len: int, *, window: int = 0,
               par=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); caches (B, S_max, KH, hd).

    Writes the new k/v at ``cache_len`` into the caches IN PLACE (the
    reference's engine donates its caches to the jitted step) and
    returns (out, cache_k, cache_v). ``window`` > 0 attends to the last
    ``window`` positions of the dense cache only (the ring cache is
    :func:`gqa_decode_ring`'s). An M-RoPE config continues in text: all
    three position streams are ``cache_len``."""
    B = x.shape[0]
    shape = (3, B, 1) if cfg.pos_kind == 'mrope' else (B, 1)
    q, k, v = gqa_qkv(_gqa_weights(p, cfg, par), cfg, x,
                      torch.full(shape, cache_len, device=x.device))
    cache_k[:, cache_len] = k[:, 0]
    cache_v[:, cache_len] = v[:, 0]
    # single pass (chunk = the whole cache), as the reference
    o = flash_attention(q, *_attend_kv(cache_k, cache_v, cfg, par), causal=True, window=window,
                        q_offset=cache_len, kv_len=cache_len + 1, chunk=cache_k.shape[1])
    return _out(p, o, cfg, par), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank Q/KV with decoupled RoPE
# ---------------------------------------------------------------------------

def mla_plan(cfg) -> Dict:
    d, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nh, rh, vh = cfg.qk_nope_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        'wq_a': L.linear_plan(d, qr, ('embed', None)),
        'q_norm': L.norm_plan(qr),
        'wq_b': L.linear_plan(qr, H * (nh + rh), (None, 'heads')),
        'wkv_a': L.linear_plan(d, kvr + rh, ('embed', 'kv_lora')),
        'kv_norm': L.norm_plan(kvr),
        'wkv_b': L.linear_plan(kvr, H * (nh + vh), ('kv_lora', 'heads')),
        'wo': L.linear_plan(H * vh, d, ('heads', 'embed')),
    }


def _enter(t, par):
    return t if par is None else par.enter(t)


def _mla_q(p: Dict, cfg, x, positions, par=None):
    """The queries (B, S, H, nh + rh): the low-rank projection through
    ``q_norm`` (eps 1e-6, not ``cfg.norm_eps``, as the reference), RoPE
    on the last ``rh`` of each head. On a mesh the normalized low-rank
    query, computed alike on every rank, enters the heads split."""
    nh, rh = cfg.qk_nope_dim, cfg.rope_head_dim
    qa = L.apply_norm(p['q_norm'], L.apply_linear(p['wq_a'], x))
    q = L.apply_linear(p['wq_b'], _enter(qa, par))
    q = _heads(q, nh + rh)                       # a rank's heads on a mesh
    return torch.cat([q[..., :nh], L.apply_rope(q[..., nh:], positions, theta=cfg.rope_theta)],
                     dim=-1)


def _mla_latent(p: Dict, cfg, x, positions):
    """What the decode cache keeps of each token: the normalized latent
    (B, S, kv_lora_rank) and the roped key shared by every head (B, S, rh)."""
    kvr = cfg.kv_lora_rank
    kv_a = L.apply_linear(p['wkv_a'], x)
    latent = L.apply_norm(p['kv_norm'], kv_a[..., :kvr])
    k_rope = L.apply_rope(kv_a[..., None, kvr:], positions, theta=cfg.rope_theta)[:, :, 0]
    return latent, k_rope


def _mla_qkv_from_latent(p: Dict, cfg, latent, k_rope, par=None):
    """Keys (B, T, H, nh + rh) and values (B, T, H, vh) decompressed from
    the latent (B, T, kvr) through ``wkv_b`` (a rank's heads on a mesh),
    the shared roped key (B, T, rh) broadcast to every head. On a mesh
    the latent and the roped key, computed alike on every rank, enter
    the heads split."""
    B, T = latent.shape[:2]
    nh, rh, vh = cfg.qk_nope_dim, cfg.rope_head_dim, cfg.v_head_dim
    latent, k_rope = _enter(latent, par), _enter(k_rope, par)
    kv = _heads(L.apply_linear(p['wkv_b'], latent), nh + vh)
    H = kv.shape[2]
    k = torch.cat([kv[..., :nh], k_rope[:, :, None].to(kv.dtype).expand(B, T, H, rh)], dim=-1)
    return k, kv[..., nh:]


def _mla_attend(p: Dict, cfg, q, latent, k_rope, par=None, **flash_kw):
    """Causal attention of q over the decompressed latent; v is zero-padded
    to the query's head width for ``flash_attention`` and sliced after.
    On a mesh each rank attends with its heads, ``wo`` row-parallel."""
    D = q.shape[-1]
    vh = cfg.v_head_dim
    k, v = _mla_qkv_from_latent(p, cfg, latent, k_rope, par)
    if vh < D:
        v = F.pad(v, (0, D - vh))
    o = flash_attention(q, k, v, causal=True, **flash_kw)[..., :vh]
    return _out(p, o, cfg, par)


def _mla_weights(p: Dict, cfg, par) -> Dict:
    """MLA's weights as this rank computes with them: its blocks, or
    where the group does not divide the heads, ``wq_b`` and ``wkv_b``
    gathered at use and narrowed to :func:`head_range` (``wo``:
    :func:`_out`)."""
    if not uneven_heads(cfg, par):
        return p
    H, qr, kvr = cfg.num_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    nh, rh, vh = cfg.qk_nope_dim, cfg.rope_head_dim, cfg.v_head_dim
    heads = head_range(H, par.tp, par.tp_index)
    return _head_weights(p, par, {
        'wq_b': ((qr, H * (nh + rh)), (None, 'heads'), 1, heads, nh + rh),
        'wkv_b': ((kvr, H * (nh + vh)), ('kv_lora', 'heads'), 1, heads, nh + vh)})


def mla_apply(p: Dict, cfg, x, positions, *, par=None):
    """Full-sequence (train/prefill) MLA."""
    p = _mla_weights(p, cfg, par)
    q = _mla_q(p, cfg, x, positions, par)
    latent, k_rope = _mla_latent(p, cfg, x, positions)
    return _mla_attend(p, cfg, q, latent, k_rope, par, chunk=cfg.attn_chunk)


def mla_prefill(p: Dict, cfg, x, positions, *, cache_cap: Optional[int] = None, par=None):
    """Full-sequence MLA that also returns the compressed decode cache
    {'latent': (B, cap, kvr), 'krope': (B, cap, rh)}, zero-padded to
    ``cache_cap`` positions (a cap under the prompt raises). The
    reference recomputes the latent for the cache; here one computation
    serves both."""
    p = _mla_weights(p, cfg, par)
    S = x.shape[1]
    pad = _cache_pad(cache_cap, S)
    q = _mla_q(p, cfg, x, positions, par)
    latent, k_rope = _mla_latent(p, cfg, x, positions)
    out = _mla_attend(p, cfg, q, latent, k_rope, par, chunk=cfg.attn_chunk)
    return out, {'latent': F.pad(latent, (0, 0, 0, pad)), 'krope': F.pad(k_rope, (0, 0, 0, pad))}


def mla_decode(p: Dict, cfg, x, cache_latent, cache_krope, cache_len: int, *, par=None):
    """One-token decode with the *compressed* cache: latents (B, S_max,
    kvr) and the roped shared key (B, S_max, rh). Writes the new token's
    at ``cache_len`` IN PLACE (as ``gqa_decode``) and decompresses the
    whole cache through ``wkv_b`` each step, as the reference does.
    Returns (out, cache_latent, cache_krope)."""
    B = x.shape[0]
    p = _mla_weights(p, cfg, par)
    positions = torch.full((B, 1), cache_len, device=x.device)
    q = _mla_q(p, cfg, x, positions, par)
    latent, k_rope = _mla_latent(p, cfg, x, positions)
    cache_latent[:, cache_len] = latent[:, 0]
    cache_krope[:, cache_len] = k_rope[:, 0]
    out = _mla_attend(p, cfg, q, cache_latent.to(x.dtype), cache_krope.to(x.dtype), par,
                      q_offset=cache_len, kv_len=cache_len + 1, chunk=cache_latent.shape[1])
    return out, cache_latent, cache_krope
