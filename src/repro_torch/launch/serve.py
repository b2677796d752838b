"""Serving launcher: batched prefill + greedy decode of a language model.

Port of ``repro.launch.serve``, with these differences:

* ``--smoke`` / ``--no-smoke``: the smoke config (the default) or the
  published widths. The reference's ``--smoke`` cannot be turned off.
* ``--device cuda|cpu`` (default ``cuda``, which raises without a card)
  and ``--mesh RxC`` name the port's ('data', 'model') mesh where the
  reference took ``--devices`` (fake host devices). A mesh of more than
  one rank runs one process a rank under ``torch.distributed.run``
  (NCCL on ``cuda``, gloo on ``cpu``); outside it, it raises and names
  the command. Rank 0 prints.
* ``--seed`` seeds the parameters and the prompts (numpy): tokens, or
  for an embeds-mode config (qwen2-vl-2b) embeddings with M-RoPE
  positions. Each rank draws its blocks alone (``weights.draw_params``:
  the same whole tree on every mesh, so a mesh serves the 1x1 run's
  weights).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b --no-smoke \\
        --batch 8 --prompt-len 2048 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --device cpu \\
        --prompt-len 40 --gen 8           # a prompt past the smoke window of 16: the ring wraps
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch internlm2-1.8b --mesh 2x2 --device cpu
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', required=True)
    ap.add_argument('--smoke', action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--gen', type=int, default=16)
    ap.add_argument('--mesh', default='1x1')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, make_batch, smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import make_rules
    from repro_torch.serve import ServeEngine
    from repro_torch.weights import draw_params

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if not cfg.causal:
        raise SystemExit(f'{cfg.name} is encoder-only: no decode step')
    rows, cols = (int(t) for t in args.mesh.split('x'))
    ranks = rows * cols
    if ranks > 1:
        if 'LOCAL_RANK' not in os.environ:
            raise SystemExit(
                f'--mesh {args.mesh} runs {ranks} processes: python -m torch.distributed.run '
                f'--standalone --nproc-per-node {ranks} -m repro_torch.launch.serve '
                f'--mesh {args.mesh} ...')
        if args.device == 'cuda':
            torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
        dist.init_process_group('nccl' if args.device == 'cuda' else 'gloo')
    try:
        mesh = make_host_mesh(rows, cols, device=args.device)
        params = draw_params(args.seed, cfg, torch.float32, make_rules(mesh, mode='serve'),
                             mesh)
        batch = make_batch(cfg, batch=args.batch, seq=args.prompt_len, seed=args.seed,
                           device=mesh.device)
        with ServeEngine(cfg, mesh, params, batch=args.batch, prompt_len=args.prompt_len,
                         max_len=args.prompt_len + args.gen) as eng:
            t0 = time.perf_counter()
            toks = eng.generate(batch, args.gen).cpu()
            dt = time.perf_counter() - t0
        if ranks == 1 or dist.get_rank() == 0:
            print(f'[serve] arch={cfg.name} batch={args.batch} '
                  f'gen={args.gen} tokens in {dt:.2f}s '
                  f'({args.batch * args.gen / dt:.1f} tok/s)'
                  + (f' mesh={args.mesh}' if ranks > 1 else ''))
            print('[serve] first row:', toks[0].tolist())
    finally:
        if ranks > 1:
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
