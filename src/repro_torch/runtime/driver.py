"""Fault-tolerant training driver.

Port of ``repro.runtime.driver``, with the reference's restart
semantics:

* checkpoint/restart: periodic async checkpoints (params + optimizer +
  step); after a failure the driver resumes from the latest manifest in
  its directory. The data pipeline is a pure function of the step, so
  the token stream resumes exactly.
* failure handling: any exception in the step loop falls back to
  restart-from-checkpoint (from scratch where there is none yet);
  :class:`FailureInjector` raises at a chosen step to prove the path.
  A restart budget guards against crash loops.
* straggler mitigation: an EWMA of the step time; a step slower than
  ``trip_factor`` x EWMA counts a trip and calls the re-mesh hook.

A step ends when its loss reaches the host (``float(metrics['loss'])``,
the reference's ``block_until_ready``). A restore builds new tensors on
the device of the ones it replaces.

On a mesh of several ranks (``mesh``, with each leaf's ``cuts``) every
rank runs the loop on its blocks: checkpoints are sharded saves (a
collective, so written on the training thread), an injected failure
fires on every rank at the same step and they restore and resume in
step (after a barrier), and only rank 0 logs. Any other exception
fails the run: a rank cannot rejoin peers that are inside a collective,
so it propagates (``torch.distributed.run`` then stops every rank, and
``--resume`` restarts them from the latest checkpoint).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch.distributed as dist

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                                    save_checkpoint)


class InjectedFailure(RuntimeError):
    """The :class:`FailureInjector`'s fault."""


class FailureInjector:
    """Deterministic fault: raises :class:`InjectedFailure` (a
    RuntimeError) at the given steps (once each), the test double for a
    lost node; on a mesh, on every rank at once."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise InjectedFailure(f'injected node failure at step {step}')


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2
    trip_factor: float = 3.0
    warmup: int = 3
    ewma: float = 0.0
    count: int = 0
    trips: int = 0
    on_trip: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            self.ewma = dt if self.ewma == 0 else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
            return False
        tripped = dt > self.trip_factor * self.ewma
        if tripped:
            self.trips += 1
            if self.on_trip:
                self.on_trip(step, dt, self.ewma)
        else:                      # stragglers don't poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return tripped


class TrainDriver:
    """step_fn(params, opt, batch) -> (params, opt, metrics). ``mesh``
    and ``cuts`` (``{'params': ..., 'opt': ...}`` of ``weights.Cut``): a
    sharded run's mesh and each leaf's cut, for its checkpoints."""

    def __init__(self, step_fn, ckpt_dir: str, *, ckpt_every: int = 50,
                 monitor: Optional[StragglerMonitor] = None,
                 injector: Optional[FailureInjector] = None,
                 max_restarts: int = 3, async_ckpt: bool = True,
                 log: Optional[Callable[[str], None]] = None, mesh=None, cuts=None):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.monitor = monitor or StragglerMonitor()
        self.injector = injector
        self.max_restarts = max_restarts
        self.sharded = mesh is not None and mesh.size > 1
        self.mesh, self.cuts = mesh, cuts
        self.async_ckpt = async_ckpt and not self.sharded
        log = log or (lambda s: None)
        self.log = log if not self.sharded or dist.get_rank() == 0 else (lambda s: None)
        self.restarts = 0
        self.history: list = []

    # -- checkpoint plumbing -------------------------------------------------
    def _save(self, ckpter, step, params, opt):
        tree = {'params': params, 'opt': opt}
        if ckpter is not None:
            ckpter.save(step, tree)
        else:
            save_checkpoint(self.ckpt_dir, step, tree, cuts=self.cuts, mesh=self.mesh)

    def restore(self, like_params, like_opt):
        """Latest checkpoint -> (params, opt, step), new tensors on the
        devices of ``like_params`` / ``like_opt``; None if there is none."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None
        tree = restore_checkpoint(self.ckpt_dir, step, {'params': like_params, 'opt': like_opt},
                                  cuts=self.cuts, mesh=self.mesh)
        return tree['params'], tree['opt'], step

    # -- the loop ------------------------------------------------------------
    def run(self, params, opt, batches: Callable[[int], Dict], *,
            steps: int, start_step: int = 0, shard_fn=None):
        """Run to ``steps`` with restart-on-failure. ``batches(step)``
        returns the global batch for a step; ``shard_fn`` places it."""
        ckpter = AsyncCheckpointer(self.ckpt_dir) if self.async_ckpt else None
        step = start_step
        while step < steps:
            try:
                t0 = time.perf_counter()
                batch = batches(step)
                if shard_fn is not None:
                    batch = shard_fn(batch)
                if self.injector is not None:
                    self.injector.check(step)
                params, opt, metrics = self.step_fn(params, opt, batch)
                float(metrics['loss'])          # the step has finished
                dt = time.perf_counter() - t0
                self.monitor.observe(step, dt)
                self.history.append(
                    {'step': step, 'dt': dt,
                     **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % self.ckpt_every == 0:
                    self._save(ckpter, step, params, opt)
            except Exception as e:
                if self.sharded and not isinstance(e, InjectedFailure):
                    raise
                self.restarts += 1
                self.log(f'[driver] failure at step {step}: {e}; '
                         f'restart {self.restarts}/{self.max_restarts}')
                if self.restarts > self.max_restarts:
                    raise
                if ckpter is not None:
                    ckpter.wait()
                if self.sharded:
                    dist.barrier()
                restored = self.restore(params, opt)
                if restored is None:
                    step = start_step     # no checkpoint yet: from scratch
                else:
                    params, opt, step = restored
                    self.log(f'[driver] resumed from step {step}')
        self._save(ckpter, step, params, opt)
        if ckpter is not None:
            ckpter.close()
        return params, opt, step
