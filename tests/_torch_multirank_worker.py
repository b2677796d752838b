"""Worker: the port's distributed FFT on 4 gloo CPU ranks (2 x 2 mesh).

Run in a subprocess so the test process never initialises a process
group:

    python tests/_torch_multirank_worker.py OUT.json PORT [cpu|cuda]

``cpu`` (the default) runs 4 gloo ranks on the CPU with the plain
PyTorch versions; ``cuda`` runs 4 NCCL ranks on 4 cards with the CUDA
kernels.

Every rank makes the same global operand from a seed, takes its block
under the plan's input layout, runs forward and inverse with
``comm='all_to_all'``, and compares its blocks with the same blocks of
the port's single-process result (1 x 1 mesh), of ``np.fft.fftn``, and,
for a 16-bit wire, of the native-wire result. Rank 0 writes one record
per case: the largest gaps over all ranks, each divided by the largest
magnitude of its reference.

Real plans (``REAL_CASES``) take a real operand. Their half axis travels
zero-padded to ``nh_pad`` bins; a rank's block of the spectrum is held
against the bins of ``np.fft.rfftn`` (and of the single-process spectrum,
zero-padded) that its padded block covers, those below n//2 + 1 only
when ``padded_spectrum`` is off.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'src'))

import repro_torch.fft as fft  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402

WORLD = 4
BATCH = 2

#: (name, shape, plan options)
CASES = [
    ('r3_stockham', (16, 16, 16), dict(method='stockham')),
    ('r3_four_step', (16, 16, 16), dict(method='four_step')),
    ('r3_auto', (16, 16, 16), dict(method='auto')),
    ('r3_restore', (16, 16, 16), dict(method='stockham', restore_layout=True)),
    ('r3_mesh_axes_yx', (16, 16, 16), dict(method='stockham', mesh_axes=('y', 'x'))),
    ('r3_block', (16, 16, 16), dict(method='block')),
    ('r2_block', (16, 32), dict(method='block')),
    ('r2_stockham', (16, 32), dict(method='stockham')),
    ('r2_four_step', (16, 32), dict(method='four_step')),
    ('r2_layout_yx', (16, 32), dict(method='stockham', layout=(('y', 'x'), None))),
    ('r3_fp16', (16, 16, 16), dict(method='stockham', wire_dtype='fp16')),
    ('r3_bf16', (16, 16, 16), dict(method='stockham', wire_dtype='bf16')),
    ('r2_fp16', (16, 32), dict(method='four_step', wire_dtype='fp16')),
    ('r2_bf16', (16, 32), dict(method='four_step', wire_dtype='bf16')),
]

#: (name, shape, rplan options)
REAL_CASES = [
    ('real_stockham_padded', (16, 16, 16), dict(method='stockham', padded_spectrum=True)),
    ('real_block_padded', (16, 16, 16), dict(method='block', padded_spectrum=True)),
    ('real_stockham', (16, 16, 16), dict(method='stockham')),
    ('real_block', (16, 16, 16), dict(method='block')),
    ('real_four_step', (16, 16, 16), dict(method='four_step')),
    ('real_restore', (16, 16, 16), dict(method='stockham', restore_layout=True)),
    ('real_r2_stockham', (16, 32), dict(method='stockham')),
    ('real_r2_block_padded', (16, 32), dict(method='block', padded_spectrum=True)),
]


def _gap(got, want):
    """(max |got - want|, max |want|) over this rank's block."""
    return float((got - want).abs().max()), float(want.abs().max())


def _case(mesh, single, shape, kw):
    rng = np.random.default_rng(list(shape))
    x = rng.standard_normal((BATCH,) + shape) + 1j * rng.standard_normal((BATCH,) + shape)
    xt = torch.as_tensor(x.astype(np.complex64), device=mesh.device)
    axes = tuple(range(1, len(shape) + 1))
    want_np = torch.as_tensor(np.fft.fftn(x, axes=axes).astype(np.complex64),
                              device=mesh.device)
    p = fft.plan(shape, mesh, comm='all_to_all', **kw)
    single_kw = {k: v for k, v in kw.items() if k not in ('wire_dtype', 'layout', 'mesh_axes')}
    p1 = fft.plan(shape, single, comm='all_to_all', **single_kw)
    y1 = p1.forward(xt)
    y = p.forward(mesh.shard(xt, p.in_layout, batch_ndim=1))
    x2 = p.inverse(y)
    rec = {
        'fwd_vs_single': _gap(y, mesh.shard(y1, p.out_layout, batch_ndim=1)),
        'fwd_vs_numpy': _gap(y, mesh.shard(want_np, p.out_layout, batch_ndim=1)),
        'roundtrip': _gap(x2, mesh.shard(xt, p.in_layout, batch_ndim=1)),
        'shape_ok': (tuple(y.shape) == (BATCH,) + p.local_shape(p.out_layout)
                     and tuple(x2.shape) == (BATCH,) + p.local_shape(p.in_layout)),
    }
    if kw.get('wire_dtype', 'native') != 'native':
        native = p.with_options(wire_dtype='native')
        rec['fwd_vs_native_wire'] = _gap(y, native.forward(mesh.shard(xt, p.in_layout, 1)))
    return rec


def _real_case(mesh, single, shape, kw):
    rng = np.random.default_rng(list(shape) + [1])
    x = rng.standard_normal((BATCH,) + shape)
    xt = torch.as_tensor(x.astype(np.float32), device=mesh.device)
    p = fft.rplan(shape, mesh, comm='all_to_all', **kw)
    p1 = fft.rplan(shape, single, comm='all_to_all', method=kw['method'])
    nh = shape[-1] // 2 + 1
    nh_pad = p.with_options(padded_spectrum=True).spectrum_shape[-1]
    lay = p.with_options(padded_spectrum=True).out_layout
    pad = (0, nh_pad - nh)
    axes = tuple(range(1, len(shape) + 1))
    want_np = torch.nn.functional.pad(torch.as_tensor(
        np.fft.rfftn(x, axes=axes).astype(np.complex64), device=mesh.device), pad)
    want_single = torch.nn.functional.pad(p1.forward(xt), pad)
    # the global bins this rank's padded block covers, and those it keeps
    bins = mesh.shard(torch.arange(nh_pad, device=mesh.device).expand(want_np.shape),
                      lay, batch_ndim=1)
    mine = bins.reshape(-1, bins.shape[-1])[0]
    keep = mine if kw.get('padded_spectrum') else mine[mine < nh]

    def block(g):
        return mesh.shard(g, lay, batch_ndim=1)[..., :keep.numel()]

    y = p.forward(mesh.shard(xt, p.in_layout, batch_ndim=1))
    x2 = p.inverse(y)
    return {
        'fwd_vs_single': _gap(y, block(want_single)),
        'fwd_vs_numpy': _gap(y, block(want_np)),
        'roundtrip': _gap(x2, mesh.shard(xt, p.in_layout, batch_ndim=1)),
        'shape_ok': (tuple(y.shape) == (BATCH,) + p.spectrum_local_shape()
                     and y.shape[-1] == keep.numel()
                     and tuple(x2.shape) == (BATCH,) + p.local_shape(p.in_layout)),
    }


def run(rank: int, port: int, out: str, device: str) -> None:
    if device == 'cuda':
        torch.cuda.set_device(rank)
    dist.init_process_group('nccl' if device == 'cuda' else 'gloo',
                            init_method=f'tcp://localhost:{port}',
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_fft_mesh(2, 2, device=device)
        single = make_fft_mesh(1, 1, device=device)
        mine = {name: _case(mesh, single, shape, kw) for name, shape, kw in CASES}
        mine.update({name: _real_case(mesh, single, shape, kw)
                     for name, shape, kw in REAL_CASES})
        every = [None] * WORLD
        dist.all_gather_object(every, mine)
        if rank == 0:
            merged = {}
            for name, _, _ in CASES + REAL_CASES:
                recs = [r[name] for r in every]
                m = {'shape_ok': all(r['shape_ok'] for r in recs)}
                for key in recs[0]:
                    if key != 'shape_ok':
                        err = max(r[key][0] for r in recs)
                        ref = max(r[key][1] for r in recs)
                        m[key] = err / ref
                merged[name] = m
            with open(out, 'w') as fh:
                json.dump(merged, fh)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    device = sys.argv[3] if len(sys.argv) > 3 else 'cpu'
    mp.spawn(run, args=(int(sys.argv[2]), sys.argv[1], device), nprocs=WORLD, join=True)
