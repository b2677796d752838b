"""Train a small LM end to end through the PyTorch port with the full
runtime: synthetic packed data, AdamW + cosine schedule, checkpointing,
straggler monitor. The port's counterpart of ``examples/train_lm.py``:
the same model, data and assert (the loss falls by more than 0.5 nats).

    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 300
    python examples/torch_train_lm.py                 # on the card (default)

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

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data import SyntheticLM, shard_batch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import StragglerMonitor, TrainDriver  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402
from repro_torch.train.trainstep import make_train_step  # noqa: E402


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
    args = ap.parse_args()

    cfg = dataclasses.replace(
        smoke_config(get_config('granite-3-8b')),
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(4, args.d_model // 32), num_kv_heads=2,
        head_dim=32, d_ff=args.d_model * 3, vocab_size=args.vocab,
        attn_chunk=args.seq,
        # untied LM head: at tiny scale a tied head couples input/output
        # embedding gradients and stalls early learning (the reference's note)
        tie_embeddings=False)
    mesh = make_host_mesh(1, 1, device=args.device)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix='torch_train_lm_')

    step = make_train_step(cfg, mesh, peak_lr=args.lr, warmup_steps=args.steps // 10,
                           total_steps=args.steps, param_dtype=torch.float32)
    gen = torch.Generator(device=mesh.device).manual_seed(args.seed)
    params = M.init_params(gen, cfg, torch.float32)
    print(f'params: {M.param_count(cfg)/1e6:.2f}M  vocab={cfg.vocab_size} '
          f'uniform-loss={np.log(cfg.vocab_size):.3f}')
    opt = adamw_init(params)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)

    driver = TrainDriver(step, ckpt, ckpt_every=100, monitor=StragglerMonitor(), log=print)
    params, opt, end = driver.run(params, opt,
                                  lambda i: shard_batch(data.batch_at(i), mesh),
                                  steps=args.steps)

    hist = driver.history
    k = max(len(hist) // 10, 1)
    for i in range(0, len(hist), k):
        w = hist[i:i + k]
        print(f'step {w[0]["step"]:4d}  ce={np.mean([h["ce"] for h in w]):.4f}'
              f'  lr={w[-1]["lr"]:.2e}  {np.mean([h["dt"] for h in w]):.3f}s/step')
    first, last = hist[0]['ce'], np.mean([h['ce'] for h in hist[-20:]])
    print(f'loss: {first:.4f} -> {last:.4f} (uniform {np.log(cfg.vocab_size):.4f})')
    assert last < first - 0.5, 'model failed to learn'
    print('torch_train_lm OK')


if __name__ == '__main__':
    main()
