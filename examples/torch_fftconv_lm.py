"""The paper's technique inside an LM, on the PyTorch port: a
long-convolution token mixer executed with the port's own FFT (on the
card, the hand-written kernels, forward and backward). The port's
counterpart of ``examples/fftconv_lm.py``: the same model, data and
assert (the loss falls by more than 0.3 nats).

A constant-decay SSM is exactly a causal convolution, so the sequence
mixer is y = causal_conv(x, k) computed as FFT -> pointwise multiply ->
IFFT over the (2S padded) sequence. The mixer runs through a fused
``fft.plan_op`` operator plan on the ('data', 'model') mesh; the learned
kernel rides as a runtime operand during training, and the gradient is
the adjoint plan's correlation (``models/ssd.py:_FFTConv``).

    PYTHONPATH=src python examples/torch_fftconv_lm.py --device cpu --steps 150
    python examples/torch_fftconv_lm.py               # on the card (default)
"""
import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'src'))

import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402
from repro_torch.train.trainstep import make_train_step  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=150)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=64)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    # an attention-free LM whose every block is the FFT-conv mixer
    cfg = dataclasses.replace(
        smoke_config(get_config('mamba2-1.3b')),
        block_pattern=('fftconv',), num_layers=4, d_model=64,
        vocab_size=256, fftconv_len=args.seq)
    mesh = make_host_mesh(1, 1, device=args.device)

    step = make_train_step(cfg, mesh, peak_lr=3e-3, warmup_steps=10,
                           total_steps=args.steps, param_dtype=torch.float32)
    gen = torch.Generator(device=mesh.device).manual_seed(args.seed)
    params = M.init_params(gen, cfg, torch.float32)
    opt = adamw_init(params)

    def batch_at(i):
        """Period-3 token cycles: exactly learnable by a lag-2 conv tap
        (a content-based mixer is not needed; a relative-offset one is,
        the convolution's home turf)."""
        rng = np.random.default_rng((1000003 * i) % (2**31))
        toks = np.empty((args.batch, args.seq + 1), np.int32)
        for b in range(args.batch):
            toks[b] = np.resize(rng.integers(1, cfg.vocab_size, 3), args.seq + 1)
        return {'tokens': torch.as_tensor(toks[:, :-1]).to(mesh.device),
                'labels': torch.as_tensor(toks[:, 1:]).to(mesh.device)}

    kernels.reset_launch_counts()
    losses = []
    for i in range(args.steps):
        params, opt, m = step(params, opt, batch_at(i))
        losses.append(float(m['ce']))
        if i % max(args.steps // 10, 1) == 0:
            print(f'step {i:4d} ce={losses[-1]:.4f}')
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f'fftconv LM loss: {first:.4f} -> {last:.4f} '
          f'(uniform {np.log(cfg.vocab_size):.4f})')
    print(f'kernel launches: {kernels.launch_counts()}')
    assert last < first - 0.3, 'fftconv mixer failed to learn'
    print('torch_fftconv_lm OK')


if __name__ == '__main__':
    main()
