"""What ``torch_bench_rfft.py`` and ``torch_bench_fftconv.py`` share: the
mesh they time on, the clock, and their counted runs on the fake 4 x 4.

* :func:`timing_mesh`: a 1 x 1 mesh on ``--device``, or under
  ``torch.distributed.run`` a ``--mesh`` of its ranks (NCCL on cards,
  gloo on the CPU);
* ``time_us`` (``torch_paper_fig3``'s): the median microseconds of a
  call, CUDA events on the card, the host clock on the CPU;
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

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'src'))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402
from torch_paper_fig3 import card as fig3_card, time_us  # noqa: E402,F401 (the clock)

#: the counted mesh, the reference's 4 x 4
COUNT_MESH = (4, 4)


def timing_mesh(mesh_name: str, device: str):
    """The mesh the wall times are taken on: 1 x 1 on ``device``, or
    ``RxC`` over ``torch.distributed.run``'s ranks."""
    rows, cols = (int(v) for v in mesh_name.split('x'))
    if rows * cols > 1:
        if 'LOCAL_RANK' not in os.environ:
            raise SystemExit(f'--mesh {mesh_name}: run under python -m torch.distributed.run '
                             f'--standalone --nproc-per-node {rows * cols}')
        if device == 'cuda':
            torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
        dist.init_process_group('nccl' if device == 'cuda' else 'gloo')
    return make_fft_mesh(rows, cols, device=device)


def slowest(us: float) -> float:
    """The largest of each rank's ``us`` (itself on one rank)."""
    if not dist.is_initialized():
        return us
    t = torch.tensor([us], dtype=torch.float64,
                     device='cuda' if dist.get_backend() == 'nccl' else 'cpu')
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


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
