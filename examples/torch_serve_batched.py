"""Batched serving through the PyTorch port: prefill a batch of prompts,
then greedy-decode with the caches (dense GQA, SSM state, the RG-LRU
state and the sliding-window ring; pick the arch). The port's
counterpart of ``examples/serve_batched.py``: the same smoke-size
models, cyclic prompts and output.

    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu --arch recurrentgemma-9b
    python examples/torch_serve_batched.py --arch qwen2-vl-2b      # on the card (default)
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        examples/torch_serve_batched.py --device cpu --mesh 2x2   # four ranks, rank 0 prints

The model is randomly initialized, so the interest is the ENGINE: one
prefill and N decode steps that update the caches in place. The
default prompt (24 tokens) is longer than recurrentgemma-9b's smoke
window (16), so its ring cache wraps. An embeds-mode config
(qwen2-vl-2b) is prompted with the table's rows of the same tokens and
M-RoPE positions ``arange`` in each stream, and decodes text. The
script checks what it serves: the generated tokens equal the greedy
argmax of the full forward over prompt + generated tokens wherever its
top-2 margin is wide. With ``--mesh RxC`` (under
``torch.distributed.run``) every rank serves its blocks of the same
weights (``weights.shard_params``) and the check runs the sharded
forward.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'src'))

import torch  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import make_rules  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.weights import shard_params  # noqa: E402

#: a generated token must equal the full forward's argmax where the
#: forward's top-2 logits differ by more than this
MARGIN = 1e-3


def _batch(cfg, params, toks):
    """The engine's prompt batch: tokens, or their table rows with
    M-RoPE positions for an embeds-mode config."""
    if cfg.input_mode != 'embeds':
        return {'tokens': toks}
    B, S = toks.shape
    out = {'embeds': L.embed_lookup(params['embed'], toks)}
    if cfg.pos_kind == 'mrope':
        out['positions'] = torch.arange(S, dtype=torch.int32,
                                        device=toks.device)[None, None].expand(3, B, S)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='granite-3-8b')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=24)
    ap.add_argument('--gen', type=int, default=12)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--mesh', default='1x1', help='RxC (data x model) ranks')
    args = ap.parse_args()
    rows, cols = (int(v) for v in args.mesh.split('x'))
    if rows * cols > 1:
        import torch.distributed as dist
        if 'LOCAL_RANK' not in os.environ:
            raise SystemExit(f'--mesh {args.mesh}: run under python -m torch.distributed.run '
                             f'--standalone --nproc-per-node {rows * cols}')
        if args.device == 'cuda':
            torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
        dist.init_process_group('nccl' if args.device == 'cuda' else 'gloo')
    try:
        serve(args, rows, cols)
    finally:
        if rows * cols > 1:
            dist.destroy_process_group()


def serve(args, rows: int, cols: int):

    cfg = smoke_config(get_config(args.arch))
    if not cfg.causal:
        raise SystemExit(f'{cfg.name} is encoder-only — no decode step')
    mesh = make_host_mesh(rows, cols, device=args.device)
    rules = make_rules(mesh, mode='serve')
    params = M.init_params(torch.Generator(device=mesh.device).manual_seed(args.seed), cfg,
                           torch.float32)
    local = shard_params(params, cfg, rules, mesh)
    # cyclic prompts (each row a different cycle)
    rng = np.random.default_rng(args.seed)
    toks = np.empty((args.batch, args.prompt_len), np.int32)
    for b in range(args.batch):
        toks[b] = np.resize(rng.integers(1, cfg.vocab_size, size=3), args.prompt_len)
    toks = torch.as_tensor(toks, device=mesh.device)
    with ServeEngine(cfg, mesh, local, batch=args.batch, prompt_len=args.prompt_len,
                     max_len=args.prompt_len + args.gen) as eng:
        t0 = time.perf_counter()
        out = eng.generate(_batch(cfg, params, toks), args.gen)
        if mesh.device.type == 'cuda':
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    with torch.inference_mode():
        seq = torch.cat([toks, out[:, :-1]], dim=1)
        full, _ = M.forward(local, cfg, _batch(cfg, params, seq), rules=rules)
    want = full[:, args.prompt_len - 1:]
    top2 = torch.topk(want, 2, dim=-1).values
    wide = (top2[..., 0] - top2[..., 1]) > MARGIN
    agree = out == torch.argmax(want, dim=-1).to(torch.int32)
    assert bool(agree[wide].all()), 'a generated token is not the full forward argmax'
    if mesh.coordinate != {'data': 0, 'model': 0}:
        return
    print(f'[serve_batched] {cfg.name} on {mesh.device.type}: {args.batch} prompts x '
          f'{args.gen} tokens in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)'
          + (f' mesh={args.mesh}' if rows * cols > 1 else ''))
    for b in range(args.batch):
        print(f'  prompt …{toks[b, -6:].tolist()} -> {out[b].tolist()}')
    print('torch_serve_batched OK')


if __name__ == '__main__':
    main()
