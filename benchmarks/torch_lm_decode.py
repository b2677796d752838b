"""Time the language-model server's prefill and decode on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 benchmarks/torch_lm_decode.py --arch internlm2-1.8b [--batch 8]
        [--prompt-len 2048] [--gen 64] [--reps 3] [--src DIR]

One config at its published widths in fp32 (TF32 off), parameters and
prompts from one seed on the card (``make_batch``; an embeds-mode config
gets its embeddings with ``arange`` positions), served by
``ServeEngine``: one ``generate`` to warm up, then ``--reps`` runs of
prefill and ``--gen`` - 1 greedy decode steps under CUDA events. It
prints the card's name and power limit, then one JSON line:
``prefill_ms`` and ``decode_ms_per_token`` (medians over the runs, and
every run's in ``*_runs``), ``tok_per_s`` (new tokens a second of the
median run, host clock) and the first row's first tokens.

``--src`` imports ``repro_torch`` from another tree's ``src`` (an older
commit, unpacked), so that two versions are compared in one call, in
turns (parent, change, change, parent). It imports neither jax nor the
JAX package, and fails without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='internlm2-1.8b')
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--prompt-len', type=int, default=2048)
    ap.add_argument('--gen', type=int, default=64)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--src', default=os.path.join(ROOT, 'src'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('torch_lm_decode: no CUDA device')
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config, make_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    cfg = get_config(args.arch)
    B, S = args.batch, args.prompt_len
    params = M.init_params(torch.Generator(device='cuda').manual_seed(SEED), cfg,
                           torch.float32)
    batch = make_batch(cfg, batch=B, seq=S, seed=SEED)
    del batch['labels']
    eng = ServeEngine(cfg, make_host_mesh(1, 1), params, batch=B, prompt_len=S,
                      max_len=S + args.gen)
    first = eng.generate(batch, args.gen)
    prefill, decode, walls = [], [], []
    for _ in range(args.reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        logits, caches = eng.prefill(batch)
        ev[1].record()
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        for pos in range(S, S + args.gen - 1):
            logits, caches = eng.decode(caches, tok, pos)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        ev[2].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        prefill.append(ev[0].elapsed_time(ev[1]))
        decode.append(ev[1].elapsed_time(ev[2]) / (args.gen - 1))
        del caches

    def med(v):
        return sorted(v)[len(v) // 2]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(json.dumps({'arch': args.arch, 'src': os.path.relpath(args.src, ROOT), 'batch': B,
                      'prompt': S, 'gen': args.gen, 'prefill_ms': med(prefill),
                      'decode_ms_per_token': med(decode),
                      'tok_per_s': B * args.gen / med(walls), 'prefill_runs': prefill,
                      'decode_runs': decode, 'first_row': first[0, :8].tolist()}), flush=True)


if __name__ == '__main__':
    main()
