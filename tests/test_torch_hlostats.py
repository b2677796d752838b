"""The port's step statistics (``repro_torch.launch.hlostats``) against
hand-computed counts.

The reference's own test of its HLO analyzer (``tests/test_hlostats.py``)
fails on the installed jax, so the port is held to that test's numbers,
not to the reference: ten iterations of ``tanh(c @ w)`` on a (2, 4)
mesh, each gathering the (64, 64) block over the 4 ranks of 'y', count
10 * 2 * 64 * 64 * 256 product flops, 10 all-gathers of 64 * 64 * 4
operand bytes, and 8 partitions. It runs on a ``fake`` process group of
8 ranks in a subprocess (a process holds one default group), with a
backward through ``comm.enter`` (one all-reduce of the cotangent) and
through ``all_gather(alike=False)`` (one reduce-scatter). The gloo case
(2 ranks a group) is ``tests/test_torch_multirank.py::test_multirank_hlostats_gloo``.
The counters' own rules (copies, views, live bytes, composites under
``inference_mode``, ``meta`` results made from their shapes) run here
in-process on the CPU.
"""
import json
import os
import subprocess
import sys

import torch

from repro_torch.launch import hlostats

HERE = os.path.dirname(os.path.abspath(__file__))

WORKER = r'''
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=8)
from repro_torch import comm
from repro_torch.launch import hlostats
from repro_torch.launch.mesh import make_fft_mesh
mesh = make_fft_mesh(2, 4, device='cpu')
out = {}
for dev in ('meta', 'cpu'):
    c = torch.ones(64, 256, device=dev)
    w = torch.full((256, 64), 1e-3, device=dev)
    with hlostats.count() as st:
        for _ in range(10):
            c = comm.all_gather(torch.tanh(c @ w), mesh, 'y', 1)
    out[dev] = st.analyze()
x = torch.ones(64, 256, device='meta', requires_grad=True)
w = torch.ones(256, 64, device='meta')
with hlostats.count() as st:
    (comm.enter(x, mesh, 'y') @ w).sum().backward()
out['enter'] = st.analyze()
x = torch.ones(64, 64, device='meta', requires_grad=True)
with hlostats.count() as st:
    (comm.all_gather(x, mesh, 'y', 1, alike=False) @ torch.ones(256, 8, device='meta')).sum().backward()
out['apart'] = st.analyze()
print('STATS ' + json.dumps(out))
'''


def _fake_group_stats():
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, '..', 'src'))
    r = subprocess.run([sys.executable, '-c', WORKER], capture_output=True, text=True,
                       timeout=300, env=env)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith('STATS ')]
    assert line, r.stdout + r.stderr
    return json.loads(line[0][len('STATS '):])


def test_loop_and_backward_on_the_fake_group():
    out = _fake_group_stats()
    for dev in ('meta', 'cpu'):
        st = out[dev]
        assert st['dot_flops'] == 10 * 2 * 64 * 64 * 256, dev
        assert st['collective_bytes']['all-gather'] == 10 * 64 * 64 * 4
        assert st['collective_counts'] == {'all-gather': 10}
        assert st['num_partitions'] == 8
        # (g - 1) / g of the gathered (64, 256) result, g = 4
        assert st['collective_wire_bytes']['all-gather'] == 10 * 64 * 256 * 4 * 3 / 4
        assert st['dot_flops_by_dtype'] == {'float32': st['dot_flops']}
    enter = out['enter']
    assert enter['collective_counts'] == {'all-reduce': 1}
    assert enter['collective_bytes']['all-reduce'] == 64 * 256 * 4
    assert enter['collective_wire_bytes']['all-reduce'] == 2 * 64 * 256 * 4 * 3 / 4
    # the forward product and the cotangent's (w needs no gradient)
    assert enter['dot_flops'] == 2 * (2 * 64 * 256 * 64)
    apart = out['apart']
    assert apart['collective_counts'] == {'all-gather': 1, 'reduce-scatter': 1}
    assert apart['collective_bytes'] == {'all-gather': 64 * 64 * 4,
                                         'reduce-scatter': 64 * 256 * 4}


def test_counters_on_the_cpu():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with hlostats.count() as st:
        y = a @ b                              # mm: 2 * 8 * 16 * 4
        z = torch.baddbmm(torch.zeros(3, 8, 4), a.expand(3, 8, 16), b.expand(3, 16, 4))
        t = a.t()                              # a view: nothing counted
        u = t.contiguous()                     # a copy, as clone
        v = a.float()                          # same dtype: no op
    s = st.analyze()
    assert s['dot_flops'] == 2 * 8 * 16 * 4 * (1 + 3)
    assert s['copies'] == {'clone': 8 * 16 * 4}
    assert s['collective_counts'] == {} and s['num_partitions'] == 1
    assert y.shape == (8, 4) and z.shape == (3, 8, 4) and u.is_contiguous() and v is a


def test_composites_under_inference_mode_count_their_products():
    x = torch.randn(2, 3, 4, dtype=torch.bfloat16)
    w = torch.randn(4, 5, dtype=torch.bfloat16)
    counts = []
    for inference in (False, True):
        with torch.inference_mode(inference), hlostats.count() as st:
            torch.nn.functional.linear(x, w.t())
            torch.einsum('bij,jk->bik', x, w)
            torch.matmul(x, w)
        counts.append(st.analyze()['dot_flops_by_dtype'])
    assert counts[0] == counts[1] == {'bfloat16': 3 * 2 * 2 * 3 * 4 * 5}


def test_live_bytes_peak():
    """Storages made inside the block count until freed; an in-place
    write and a view make none."""
    x = torch.zeros(1024)                      # made outside: not counted
    with hlostats.count() as st:
        a = x * 2                              # 4 KiB
        b = a + 1                              # 8 KiB live
        del a
        c = b * 3                              # 8 KiB live again
        c.add_(1)
        c[:10].zero_()
        del b, c
    assert st.peak_live_bytes == 2 * 4096
    assert st.live_bytes == 0


def test_meta_results_match_the_meta_kernels():
    """A functional op's ``meta`` result made from the table has the
    shape, strides and dtype its kernel gives, on a hit as on a miss."""
    x = torch.empty(4, 6, 8, device='meta').transpose(1, 2)
    with hlostats.count():
        r1 = [torch.sin(x), x.sum(-1), torch.cat([x, x], 1), x.float() * 2]
        r2 = [torch.sin(x), x.sum(-1), torch.cat([x, x], 1), x.float() * 2]
        cpu = [torch.arange(4), torch.arange(4)]          # a factory for the CPU stays there
    want = [torch.sin(x), x.sum(-1), torch.cat([x, x], 1), x.float() * 2]
    assert all(t.device.type == 'cpu' for t in cpu)
    for got in (r1, r2):
        for g, w in zip(got, want):
            assert (g.shape, g.stride(), g.dtype, g.device) == (w.shape, w.stride(), w.dtype,
                                                                w.device)
