"""Train a small LM end to end through the PyTorch port with the full
runtime: synthetic packed data, AdamW + cosine schedule, checkpointing,
straggler monitor. The port's counterpart of ``examples/train_lm.py``:
the same model, data and assert (the loss falls by more than 0.5 nats).

    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 300
    python examples/torch_train_lm.py                 # on the card (default)
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        examples/torch_train_lm.py --device cpu --mesh 2x2   # the sharded trainer

``--mesh RxC`` above 1x1 trains on a ('data', 'model') mesh under
``torch.distributed.run`` (one process a rank; NCCL on the card, gloo on
the CPU): the parameters drawn whole and cut to each rank's blocks under
the train rules, each rank reading its block of every batch, sharded
checkpoints; rank 0 prints.

Defaults to a ~6M-parameter dense model that visibly learns the
synthetic bigram structure within a few hundred steps.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'src'))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config, input_specs, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLM, shard_batch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import StragglerMonitor, TrainDriver  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402
from repro_torch.train.trainstep import jit_train_step  # noqa: E402
from repro_torch.weights import opt_cuts, param_cuts, shard_params  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=300)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=128)
    ap.add_argument('--d-model', type=int, default=128)
    ap.add_argument('--layers', type=int, default=4)
    ap.add_argument('--vocab', type=int, default=512)
    ap.add_argument('--lr', type=float, default=1e-2)
    ap.add_argument('--ckpt-dir', default='')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--mesh', default='1x1', help='ROWSxCOLS data x model mesh')
    args = ap.parse_args()
    rows, cols = (int(t) for t in args.mesh.split('x'))
    if rows * cols > 1:
        if 'LOCAL_RANK' not in os.environ:
            sys.exit(f'--mesh {args.mesh} runs {rows * cols} processes: python -m '
                     f'torch.distributed.run --standalone --nproc-per-node {rows * cols} '
                     f'examples/torch_train_lm.py --mesh {args.mesh} ...')
        if args.device == 'cuda':
            torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
        dist.init_process_group('nccl' if args.device == 'cuda' else 'gloo')
    try:
        train(args, rows, cols)
    finally:
        if rows * cols > 1:
            dist.destroy_process_group()


def train(args, rows: int, cols: int):
    say = print if rows * cols == 1 or dist.get_rank() == 0 else (lambda *a: None)

    cfg = dataclasses.replace(
        smoke_config(get_config('granite-3-8b')),
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(4, args.d_model // 32), num_kv_heads=2,
        head_dim=32, d_ff=args.d_model * 3, vocab_size=args.vocab,
        attn_chunk=args.seq,
        # untied LM head: at tiny scale a tied head couples input/output
        # embedding gradients and stalls early learning (the reference's note)
        tie_embeddings=False)
    mesh = make_host_mesh(rows, cols, device=args.device)
    ckpt = [args.ckpt_dir or tempfile.mkdtemp(prefix='torch_train_lm_')]
    if rows * cols > 1:           # every rank writes its blocks under rank 0's directory
        dist.broadcast_object_list(ckpt, src=0)
    ckpt = ckpt[0]

    sds, axes = input_specs(cfg, ShapeSpec('train', 'train', args.seq, args.batch),
                            torch.float32)
    step, aux = jit_train_step(cfg, mesh, sds, axes, peak_lr=args.lr,
                               warmup_steps=args.steps // 10, total_steps=args.steps,
                               param_dtype=torch.float32)
    rules = aux['rules']
    gen = torch.Generator(device=mesh.device).manual_seed(args.seed)
    params = shard_params(M.init_params(gen, cfg, torch.float32), cfg, rules, mesh)
    say(f'params: {M.param_count(cfg)/1e6:.2f}M  vocab={cfg.vocab_size} '
        f'uniform-loss={np.log(cfg.vocab_size):.3f}  mesh={args.mesh}')
    opt = adamw_init(params)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)

    driver = TrainDriver(step, ckpt, ckpt_every=100, monitor=StragglerMonitor(), log=print,
                         mesh=mesh, cuts={'params': param_cuts(cfg, rules),
                                          'opt': opt_cuts(cfg, rules)})
    params, opt, end = driver.run(
        params, opt, lambda i: shard_batch(data.batch_at(i), mesh, shardings=aux['b_sh']),
        steps=args.steps)

    hist = driver.history
    k = max(len(hist) // 10, 1)
    for i in range(0, len(hist), k):
        w = hist[i:i + k]
        say(f'step {w[0]["step"]:4d}  ce={np.mean([h["ce"] for h in w]):.4f}'
            f'  lr={w[-1]["lr"]:.2e}  {np.mean([h["dt"] for h in w]):.3f}s/step')
    first, last = hist[0]['ce'], np.mean([h['ce'] for h in hist[-20:]])
    say(f'loss: {first:.4f} -> {last:.4f} (uniform {np.log(cfg.vocab_size):.4f})')
    assert last < first - 0.5, 'model failed to learn'
    say('torch_train_lm OK')


if __name__ == '__main__':
    main()
