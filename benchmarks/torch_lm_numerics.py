"""How far fp32 rounding moves the full-width LM server on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 benchmarks/torch_lm_numerics.py [--arch internlm2-1.8b mamba2-1.3b]

The same two prompts of 2048 tokens go through the model inside a batch
of 8 and alone (a batch of 2): the products then run other cuBLAS
kernels, so every difference between the two is rounding. For each
variant of the model the script prints one JSON line with:

* ``layer_rel``: after every 8th layer (and the last), the largest
  difference of the residual stream between the two batches over its
  largest magnitude;
* ``prefill_b8_vs_b2``: the largest difference of prefill's last logits;
* ``contract_ratio``: prefill's last logits (batch 8) against the full
  forward over the prompts and 63 more tokens (2 rows), over the serve
  contract's bound 2e-3 + 2e-3 |logit| (the self-check of
  ``chip_smoke.py`` ``[lm]`` passes below 1);
* ``score_std`` (attention) or ``cum_min`` (SSD): the first layer's
  attention-score spread or its most negative cumulative log decay in a
  chunk.

Variants: ``init`` is ``port`` (a linear weight scaled by 1/sqrt(d_in))
or ``reference`` (the same draws rescaled to the reference's
1/sqrt(num_layers), its fan-in of a layer-stacked leaf); for SSD models
``decay`` is ``segsum`` (the port's segment sums) or ``cumdiff`` (the
reference's difference of cumulative sums, made from the port's source
by replacing that one line). Parameters come from one seeded generator
on the card. It imports neither jax nor the JAX package, and fails
without a card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'src'))

from repro_torch.configs import get_config, make_batch  # noqa: E402
from repro_torch.models import attention as A, layers as L, model as M, ssd as S  # noqa: E402

SEED = 0
BATCH, PROMPT, EXTRA = 8, 2048, 63

SEGSUM = "    seg = torch.where(strict, la.transpose(2, 3)[..., :, None], 0.0).cumsum(dim=-2)\n"
CUMDIFF = "    seg = cum.transpose(2, 3)[..., :, None] - cum.transpose(2, 3)[..., None, :]\n"


def cumdiff_scan():
    """``ssd._ssd_chunk_scan`` with the reference's decays."""
    src = inspect.getsource(S._ssd_chunk_scan)
    if SEGSUM not in src:
        raise RuntimeError("ssd._ssd_chunk_scan no longer has the segment-sum line")
    ns = dict(vars(S))
    exec(src.replace(SEGSUM, CUMDIFF), ns)
    return ns['_ssd_chunk_scan']


def reference_init(cfg, params):
    """The port's draws rescaled to the reference's fan-in, the layer
    count, for every layer-stacked linear weight."""
    def rescale(p, t):
        if p.init == 'lin' and len(p.shape) == 3:
            return t * (p.shape[1] ** 0.5 / p.shape[0] ** 0.5)
        return t
    return L.tree_map(rescale, M.model_plan(cfg), params)


def first_layer_stat(cfg, params, tokens) -> dict:
    p = M._layer(params['blocks'], 0)
    key = next(iter(p))
    h = L.apply_norm(p[key]['norm1'], M._embed_in(params, cfg, tokens), cfg.norm_eps)
    if key.endswith('attn'):
        pos = torch.arange(PROMPT, device='cuda')[None].expand(tokens.shape[0], PROMPT)
        q, k, _ = A.gqa_qkv(p[key]['attn'], cfg, h, pos)
        g = cfg.num_heads // cfg.num_kv_heads              # q head h reads kv head h // g
        s = torch.einsum('bqhd,bkhd->bhqk', q[:, :256, ::g], k) * cfg.head_dim ** -0.5
        return {'score_std': float(s.std())}
    ps = p[key]['ssd']
    dt = torch.nn.functional.softplus(L.apply_linear(ps['wdt'], h).float()
                                      + ps['dt_bias'].float())
    la = dt * -torch.exp(ps['a_log'].float())
    return {'cum_min': float(la.reshape(la.shape[0], -1, cfg.ssm_chunk, la.shape[-1])
                             .cumsum(2).min())}


def measure(cfg, params, tokens, extra) -> dict:
    x8, x2 = M._embed_in(params, cfg, tokens), M._embed_in(params, cfg, tokens[:2])
    pos = M._positions(cfg, BATCH, PROMPT, x8.device)
    rel = {}
    for n, (p, kind) in enumerate(M._layers(params, cfg)):
        x8, _ = M._apply_block(p, cfg, kind, x8, pos)
        x2, _ = M._apply_block(p, cfg, kind, x2, None if pos is None else pos[:2])
        if n % 8 == 0 or n == cfg.num_layers - 1:
            rel[n] = float((x8[:2] - x2).abs().max() / x2.abs().max())
    del x8, x2
    p8, _ = M.prefill(params, cfg, {'tokens': tokens}, cache_cap=PROMPT)
    p2, _ = M.prefill(params, cfg, {'tokens': tokens[:2]}, cache_cap=PROMPT)
    full, _ = M.forward(params, cfg, {'tokens': torch.cat([tokens[:2], extra], dim=1)})
    ref = full[:, PROMPT - 1]
    del full
    ratio = ((p8[:2, 0] - ref).abs() / (2e-3 + 2e-3 * ref.abs())).max()
    return dict(layer_rel={k: f"{v:.3g}" for k, v in rel.items()},
                prefill_b8_vs_b2=f"{float((p8[:2, 0] - p2[:, 0]).abs().max()):.3g}",
                contract_ratio=f"{float(ratio):.3g}",
                **{k: f"{v:.4g}" for k, v in first_layer_stat(cfg, params, tokens).items()})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', nargs='+', default=['internlm2-1.8b', 'mamba2-1.3b'])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_lm_numerics: needs an NVIDIA GPU")
    torch.set_grad_enabled(False)
    segsum = S._ssd_chunk_scan
    for arch in args.arch:
        cfg = get_config(arch)
        params = M.init_params(torch.Generator(device='cuda').manual_seed(SEED), cfg,
                               torch.float32)
        tokens = make_batch(cfg, batch=BATCH, seq=PROMPT, seed=SEED)['tokens']
        extra = make_batch(cfg, batch=2, seq=EXTRA, seed=SEED + 1)['tokens']
        decays = (('segsum', segsum), ('cumdiff', cumdiff_scan())) \
            if 'ssd' in cfg.block_pattern else ((None, segsum),)
        for init in ('port', 'reference'):
            p = params if init == 'port' else reference_init(cfg, params)
            for decay, scan in decays:
                S._ssd_chunk_scan = scan
                try:
                    rec = measure(cfg, p, tokens, extra)
                finally:
                    S._ssd_chunk_scan = segsum
                print(json.dumps(dict(arch=arch, init=init, **({'decay': decay} if decay
                                                               else {}), **rec)), flush=True)
            del p
        del params
        torch.cuda.empty_cache()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '-i', '0'],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == '__main__':
    main()
