"""Training launcher: an LM config through the fault-tolerant runtime
(checkpoint/restart, straggler monitor).

Port of ``repro.launch.train``, with these differences:

* ``--smoke`` / ``--no-smoke`` (``--full`` kept): the smoke config (the
  default) or the published widths.
* ``--device cuda|cpu`` (default ``cuda``, which raises without a card)
  and ``--mesh RxC`` name the port's ('data', 'model') mesh where the
  reference took ``--devices`` (fake host devices). The port trains on
  1x1; a larger mesh raises, naming ROADMAP queue 1 item 11i.
* ``--seed`` seeds the parameters (a ``torch.Generator`` on the device)
  and the synthetic data (the reference's data seed is 0, the default).
* ``--ckpt-dir`` defaults to ``repro_torch_ckpt`` under the temporary
  directory.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --device cpu \\
        --steps 20 --ckpt-every 5 --fail-at 13

The last line is ``[train] arch=... steps=... loss first=... last=...
restarts=... straggler_trips=...``, as the reference's. The
``TrainDriver``'s last checkpoint, ``<ckpt-dir>/step_<steps>``, holds
the final parameters and optimizer state.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', required=True)
    ap.add_argument('--smoke', action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument('--full', dest='smoke', action='store_false')
    ap.add_argument('--steps', type=int, default=100)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=64)
    ap.add_argument('--mesh', default='1x1', help='ROWSxCOLS data x model mesh')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--ckpt-dir', default=os.path.join(tempfile.gettempdir(),
                                                       'repro_torch_ckpt'))
    ap.add_argument('--ckpt-every', type=int, default=25)
    ap.add_argument('--microbatches', type=int, default=1)
    ap.add_argument('--lr', type=float, default=1e-3)
    ap.add_argument('--resume', action='store_true')
    ap.add_argument('--fail-at', type=int, default=-1,
                    help='inject a failure at this step (FT demo)')
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticLM, shard_batch
    from repro_torch.launch.mesh import make_host_mesh, require_one_rank
    from repro_torch.models import model as M
    from repro_torch.runtime import FailureInjector, StragglerMonitor, TrainDriver
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.trainstep import make_train_step

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    rows, cols = (int(t) for t in args.mesh.split('x'))
    require_one_rank({'data': rows, 'model': cols}, 'the trainer')
    mesh = make_host_mesh(rows, cols, device=args.device)

    step_fn = make_train_step(cfg, mesh, peak_lr=args.lr,
                              warmup_steps=max(args.steps // 10, 5), total_steps=args.steps,
                              microbatches=args.microbatches, param_dtype=torch.float32)
    gen = torch.Generator(device=mesh.device).manual_seed(args.seed)
    params = M.init_params(gen, cfg, torch.float32)
    opt = adamw_init(params)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                       input_mode=cfg.input_mode, d_model=cfg.d_model,
                       mrope=cfg.pos_kind == 'mrope')
    driver = TrainDriver(
        step_fn, args.ckpt_dir, ckpt_every=args.ckpt_every,
        injector=FailureInjector([args.fail_at] if args.fail_at >= 0 else []),
        monitor=StragglerMonitor(on_trip=lambda s, dt, e: print(
            f'[straggler] step {s}: {dt:.3f}s vs EWMA {e:.3f}s')),
        log=print)

    start = 0
    if args.resume:
        restored = driver.restore(params, opt)
        if restored is not None:
            params, opt, start = restored
            print(f'[train] resumed from step {start}')

    params, opt, end = driver.run(params, opt,
                                  lambda step: shard_batch(data.batch_at(step), mesh),
                                  steps=args.steps, start_step=start)
    hist = driver.history
    print(f"[train] arch={cfg.name} steps={end} "
          f"loss first={hist[0]['ce']:.4f} last={hist[-1]['ce']:.4f} "
          f"restarts={driver.restarts} straggler_trips={driver.monitor.trips}")


if __name__ == '__main__':
    main()
