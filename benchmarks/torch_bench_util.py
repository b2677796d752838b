"""What the port's ``benchmarks/torch_bench_*.py`` scripts share: the
mesh they time on, the clock, their counted runs on the fake 4 x 4 and
their JSON records.

* :func:`init_world` and :func:`timing_mesh`: the default process group
  under ``torch.distributed.run`` (NCCL on cards, gloo on the CPU), and
  a 1 x 1 mesh on ``--device`` or a ``--mesh`` of its ranks;
* ``time_us`` (``torch_paper_fig3``'s): the median microseconds of a
  call, CUDA events on the card, the host clock on the CPU;
  :func:`time_us_synced` the same with a barrier before each call, for
  a collective whose ranks must start together;
* :func:`need_device` (``--device cuda`` with no card exits, no
  fallback), :func:`all_ranks` (a check every rank agrees on);
* :func:`write_rows`: the records under ``--out``, ``--refresh``
  merging rows by the reference script's ``_row_key``;
* :func:`counted`: a script's ``--count`` run in a subprocess of its
  own, which holds a ``fake`` process group of 16 ranks as rank 0 and
  counts each plan's one call on ``meta`` tensors of a 4 x 4 mesh with
  ``launch.hlostats`` (a process holds one default group, so the count
  never shares one with a real mesh).

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'src'))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402
from torch_paper_fig3 import card as fig3_card, emit, time_us  # noqa: E402,F401 (the clock)

#: the counted mesh, the reference's 4 x 4
COUNT_MESH = (4, 4)


def init_world(device: str, ranks: int, what: str) -> None:
    """The default process group of ``torch.distributed.run``'s ranks
    (NCCL on cards, gloo on the CPU), each rank on its own card; raises
    ``SystemExit`` outside the launcher."""
    if dist.is_initialized():
        return
    if 'LOCAL_RANK' not in os.environ:
        raise SystemExit(f'{what}: run under python -m torch.distributed.run '
                         f'--standalone --nproc-per-node {ranks}')
    if device == 'cuda':
        torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
    dist.init_process_group('nccl' if device == 'cuda' else 'gloo')


def timing_mesh(mesh_name: str, device: str):
    """The mesh the wall times are taken on: 1 x 1 on ``device``, or
    ``RxC`` over ``torch.distributed.run``'s ranks."""
    rows, cols = (int(v) for v in mesh_name.split('x'))
    if rows * cols > 1:
        init_world(device, rows * cols, f'--mesh {mesh_name}')
    return make_fft_mesh(rows, cols, device=device)


def need_device(device: str) -> None:
    """No silent fallback: ``--device cuda`` without a card exits."""
    if device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('--device cuda: no CUDA device; pass --device cpu')


def time_us_synced(fn, device: str, warmup: int = 2, iters: int = 5) -> float:
    """:func:`time_us` with every rank of the default group at a barrier
    before each call (outside the timed span): a collective's time then
    starts when its last rank arrives, not when the first one does."""
    if not dist.is_initialized():
        return time_us(fn, device, warmup=warmup, iters=iters)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        dist.barrier()
        if device == 'cuda':
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def slowest(us: float) -> float:
    """The largest of each rank's ``us`` (itself on one rank)."""
    if not dist.is_initialized():
        return us
    t = torch.tensor([us], dtype=torch.float64,
                     device='cuda' if dist.get_backend() == 'nccl' else 'cpu')
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def all_ranks(ok: bool, device: str) -> bool:
    """True where every rank's ``ok`` is: one rank's failed check stops
    every rank, rather than leaving its peers in the next collective."""
    if not dist.is_initialized():
        return ok
    t = torch.tensor([1 if ok else 0], device='cuda' if device == 'cuda' else 'cpu')
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def card(device: str) -> str:
    """``nvidia-smi``'s name and power limit of the card in use, or the host."""
    return fig3_card() if device == 'cuda' else 'cpu (host clock)'


def count_mesh():
    """The fake group's 4 x 4 mesh on ``meta`` (in a ``--count`` run)."""
    from repro_torch.launch import dryrun
    dryrun.init_fake_world(COUNT_MESH[0] * COUNT_MESH[1])
    return make_fft_mesh(*COUNT_MESH, device='meta')


def count_call(fn) -> dict:
    """One call of ``fn`` counted: ``ops`` (dispatched operations),
    ``launches`` (hand-written kernels), ``wire_bytes`` (collective
    operand bytes, the reference's convention), ``wire_ring_bytes``
    (with the ring factors) and ``collectives``."""
    from repro_torch.launch import hlostats
    with hlostats.count() as st:
        fn()
    a = st.analyze()
    return dict(ops=a['ops'], launches=sum(k['launches'] for k in a['kernels'].values()),
                kernels={k: v['launches_by_body'] for k, v in a['kernels'].items()},
                wire_bytes=a['collective_bytes_total'],
                wire_ring_bytes=a['collective_wire_total'],
                hbm_bytes_proxy=a['hbm_bytes_proxy'],
                collectives=float(sum(a['collective_counts'].values())))


def counted(script: str, args) -> dict:
    """The ``--count`` run of ``script`` with ``args`` in a subprocess:
    its JSON (rows keyed ``strategy/kind``)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'count.json')
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))
        for k in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'LOCAL_WORLD_SIZE', 'MASTER_ADDR',
                  'MASTER_PORT', 'TORCHELASTIC_RUN_ID', 'GROUP_RANK'):
            env.pop(k, None)
        subprocess.run([sys.executable, script, '--count', out, *args], check=True, env=env,
                       timeout=900)
        with open(out) as fh:
            return json.load(fh)


def write_rows(path: str, benchmark: str, device: str, rows: list, row_key,
               refresh: bool, **extra) -> list:
    """Write ``rows`` to ``path`` as ``{'benchmark', 'device', 'results'}``
    (plus ``extra``); with ``refresh`` the rows already there whose
    ``row_key`` no new row has are kept ahead of them, as the reference
    scripts' ``--refresh`` merges. Returns the rows written."""
    if refresh and os.path.exists(path):
        try:
            with open(path) as fh:
                old = json.load(fh).get('results', [])
        except (OSError, ValueError):
            old = []
        fresh = {row_key(r) for r in rows}
        kept = [r for r in old if row_key(r) not in fresh]
        rows = kept + rows
        print(f"# --refresh: kept {len(kept)} existing rows")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as fh:
        json.dump(dict(benchmark=benchmark, device=card(device), results=rows, **extra), fh,
                  indent=1)
    print(f"wrote {path} ({len(rows)} rows)")
    return rows
