"""Attention whose query heads the 'model' group does not divide
(``repro_torch.models.attention.head_range``, ``kv_head_range``,
``_kv_block``; ``models.model.cache_block_shape``).

* ``head_range`` cuts [0, H) into contiguous ranges whose counts differ
  by at most one (40 heads over 16: 2 or 3; 12 over 16: four ranks own
  none; 40 over 3: 13, 13, 14), and ``kv_head_range`` holds exactly the
  kv heads those pair with;
* for every rank of uneven and even cuts (GQA groups of 1 to 8, ranges
  that start or end inside a group), the rank's query heads attending
  with ``_kv_block`` of every kv head give its heads of the whole
  attention, against the reference's ``flash_attention`` (max abs
  2e-6); on even cuts ``_kv_block`` is the narrow it always was (a view,
  no copy);
* a rank that owns no head: ``flash_attention`` returns (B, S, 0, D),
  and the gradient still reaches k and v (the rank's collectives run in
  the backward);
* ``cache_block_shape`` on the 16 x 16 production shape: each 'model'
  rank's kv heads of qwen1.5-32b (40) and qwen2-vl-2b (12 heads, 2 kv),
  and the even configs' blocks as ``local_shape`` gives them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.models import attention as RA
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.parallel.sharding import local_shape, make_rules, spec_for

ATOL = 2e-6
#: (H, KH, p): uneven cuts (40 over 16, 12/2 over 16, 16/8 over 3, 6/2
#: over 4, 5/1 over 2, 24/3 over 5) and even ones (8/2 over 4, 4/1 over 4)
CUTS = [(40, 40, 16), (12, 2, 16), (16, 8, 3), (6, 2, 4), (5, 1, 2), (24, 3, 5), (8, 2, 4),
        (4, 1, 4)]


@pytest.mark.parametrize('H,p,counts', [(40, 16, {2, 3}), (12, 16, {0, 1}), (40, 3, {13, 14}),
                                        (6, 4, {1, 2}), (16, 4, {4})])
def test_head_range_cuts_the_heads_contiguously(H, p, counts):
    ranges = [A.head_range(H, p, r) for r in range(p)]
    assert ranges[0][0] == 0 and ranges[-1][1] == H
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert {hi - lo for lo, hi in ranges} == counts
    if H < p:
        assert sum(hi == lo for lo, hi in ranges) == p - H


@pytest.mark.parametrize('H,KH,p', CUTS)
def test_kv_head_range_holds_the_paired_kv_heads(H, KH, p):
    G = H // KH
    for r in range(p):
        lo, hi = A.head_range(H, p, r)
        klo, khi = A.kv_head_range(H, KH, p, r)
        assert list(range(klo, khi)) == sorted({h // G for h in range(lo, hi)})


@pytest.mark.parametrize('H,KH,p', CUTS)
def test_kv_block_pairs_a_rank_range_as_the_whole_attention(H, KH, p):
    rng = np.random.default_rng(H * 100 + KH * 10 + p)
    B, S, D = 2, 8, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))
    want = np.asarray(RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=True))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    for r in range(p):
        lo, hi = A.head_range(H, p, r)
        kl, vl = A._kv_block(tk, tv, H, r, p)
        got = A.flash_attention(tq[:, :, lo:hi], kl, vl, causal=True)
        assert got.shape == (B, S, hi - lo, D)
        if hi > lo:
            assert np.abs(got.numpy() - want[:, :, lo:hi]).max() <= ATOL
        if H % p == 0:      # the narrow of the even cut, as before: a view
            Hl, G = H // p, H // KH
            start, count = r * Hl // G, max(1, Hl // G)
            assert kl.data_ptr() == tk.narrow(-2, start, count).data_ptr()
            assert kl.shape == tk.narrow(-2, start, count).shape


def test_a_rank_without_heads_stays_in_the_graph():
    B, S, D = 2, 4, 8
    q = torch.zeros((B, S, 0, D), requires_grad=True)
    k = torch.randn((B, S, 0, D), requires_grad=True)
    v = torch.randn((B, S, 0, D), requires_grad=True)
    o = A.flash_attention(q, k, v, causal=True)
    assert o.shape == (B, S, 0, D)
    y = o.reshape(B, S, 0) @ torch.randn((0, 5))
    assert torch.equal(y, torch.zeros((B, S, 5)))
    gq, gk, gv = torch.autograd.grad(y.sum(), (q, k, v))
    assert gq.shape == q.shape and gk.shape == k.shape and gv.shape == v.shape


class _Mesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize('arch', ['qwen1.5-32b', 'qwen2-vl-2b', 'internlm2-1.8b'])
def test_cache_block_shape_holds_each_rank_kv_heads(arch):
    cfg = get_config(arch)
    mesh = _Mesh({'data': 16, 'model': 16})
    rules = make_rules(mesh, mode='serve')
    B, cap = 128, 1024
    plan = M._layer_cache_plan(cfg, 'attn', B, cap)['k']
    axes = tuple(None if a in ('kv_seq', 'heads') else a for a in plan.axes)
    even = local_shape(plan.shape, spec_for(rules, plan.shape, axes), mesh)
    kv = []
    for r in range(16):
        shape = M.cache_block_shape(cfg, plan.shape, axes, rules, r)
        assert shape[:2] == even[:2] and shape[3:] == even[3:]
        kv.append(shape[2])
    if cfg.num_heads % 16 == 0:
        assert kv == [even[2]] * 16
    else:
        assert kv == [A.kv_head_range(cfg.num_heads, cfg.num_kv_heads, 16, r)[1]
                      - A.kv_head_range(cfg.num_heads, cfg.num_kv_heads, 16, r)[0]
                      for r in range(16)]
        assert max(kv) == {'qwen1.5-32b': 3, 'qwen2-vl-2b': 1}[arch]
