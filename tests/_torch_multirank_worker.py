"""Worker: the port's distributed FFT on gloo CPU ranks (or NCCL cards).

Run in a subprocess so the test process never initialises a process
group:

    python tests/_torch_multirank_worker.py OUT.json PORT [cpu|cuda]
        [--mesh 2x2] [--pods 1] [--suite base|strategies|pod|op] [--ref REF.npz]

``cpu`` (the default) runs one gloo rank a mesh position on the CPU with
the plain PyTorch versions; ``cuda`` runs NCCL ranks, one card each,
with the CUDA kernels. ``--mesh`` is the ('x', 'y') mesh (2 x 2 by
default; 1 x 2, 1 x 4 and 2 x 4 too); ``--pods 2`` makes it a
('pod', 'x', 'y') mesh of that many pods.

Every rank makes the same global operand from a seed, takes its block
under the plan's input layout, runs forward and inverse, and compares
its blocks with the same blocks of the port's single-process result
(1 x 1 mesh), of ``np.fft.fftn``, and, for a 16-bit wire, of the
native-wire result. Rank 0 writes one record per case: the largest gaps
over all ranks, each divided by the largest magnitude of its reference.

Suite ``base`` (2 x 2):

* ``CASES`` and ``REAL_CASES`` with ``comm='all_to_all'``;
* the overlap cases (``OVERLAP_CASES``, ``REAL_OVERLAP_CASES``) at 64^3,
  where every pencil reaches the tensor-core bodies on the card, with a
  batch of one so the chunks split a mesh-local axis. Those with no
  options plan as a user would (``comm='auto'``, the selector's
  strategy, overlap depth and method; ``resolved`` records the pick);
  the others ask for ``overlap_chunks=2``. Each is also held against
  the same plan with ``overlap_chunks=1`` (``*_vs_unchunked``);
* the rank-1 cases (``RANK1_CASES``, n = 4096 = 64 x 64), planned
  without ``comm``: the default plan resolves to ``hierarchical``.

Suite ``strategies`` (``STRATEGY_PLANS`` under each of ``ppermute``,
``hierarchical`` and the mesh's pod tree, ``POD_TREES``): every plan is
also run with ``comm='all_to_all'`` and held against it, forward and
inverse (``*_vs_all_to_all``); and ``SWAPS`` holds each strategy's bare
swap against the all-to-all's on random blocks for every mesh-axis
group and a few (shard_pos, mem_pos) pairs.

Suite ``pod`` (``POD_CASES``, ``--mesh 1x2 --pods 2``): plans with
``batch_spec='pod'``, rank 3 and rank 1, complex and real (the padded
spectrum). Every rank passes its pod's slice of a batch of 4, its block
of it; its blocks are held against the same blocks of the global
results: numpy's, the single-process plan's on the whole batch and,
with ``--ref``, the JAX package's on a 2 x 1 x 2 mesh.

Suite ``op`` (``OP_CASES`` of the mesh: rank 3 on 2 x 2, rank 1 on
1 x 4): ``plan_op(..., op=spectral_mul)`` with one runtime factor, held
against the single-process operator, its own unfused composition
(forward, ``spectral_mul``, inverse, all on the mesh), numpy and, with
``--ref``, the JAX package's executors on the same mesh; the factor
baked ('plan' form, a global array) and, given the single-process
plan's own spectrum of it, in the 'spectrum' form, against the runtime
operator.

``--ref`` names an ``.npz`` of global reference results by case name
(``tests/_torch_jax_reference.py`` writes it); the worker itself never
imports jax.

Real plans take a real operand. A rank-2/3 plan's half axis travels
zero-padded to ``nh_pad`` bins; a rank's block of the spectrum is held
against the bins of ``np.fft.rfftn`` (and of the single-process
spectrum, zero-padded) that its padded block covers, those below
n//2 + 1 only when ``padded_spectrum`` is off. A rank-1 real plan's
spectrum is whole on every rank.
"""
import argparse
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

#: (name, shape, plan options) at 64^3, planned without ``comm``
OVERLAP_CASES = [
    ('ovl_default', (64, 64, 64), dict()),
    ('ovl_stockham', (64, 64, 64), dict(method='stockham', overlap_chunks=2)),
    ('ovl_block', (64, 64, 64), dict(method='block', overlap_chunks=2)),
    ('ovl_fp16', (64, 64, 64), dict(method='four_step', overlap_chunks=2,
                                    wire_dtype='fp16')),
]

#: (name, shape, rplan options) at 64^3, planned without ``comm``
REAL_OVERLAP_CASES = [
    ('real_ovl_default', (64, 64, 64), dict()),
    ('real_ovl_four_step', (64, 64, 64), dict(method='four_step', overlap_chunks=2)),
]

#: (name, shape, plan options), n = 4096 = 64 x 64, planned without ``comm``
RANK1_CASES = [
    ('r1_default', (4096,), dict()),
    ('r1_stockham', (4096,), dict(method='stockham')),
    ('r1_overlap', (4096,), dict(method='stockham', overlap_chunks=2)),
    ('r1_fp16', (4096,), dict(method='stockham', wire_dtype='fp16')),
    ('r1_real_default', (4096,), dict(real=True)),
    ('r1_real_stockham', (4096,), dict(real=True, method='stockham')),
]

#: (name, shape, plan options) run under every strategy of ``strategies_for``
STRATEGY_PLANS = [
    ('r3', (16, 16, 16), dict(method='stockham')),
    ('r3_real', (16, 16, 16), dict(real=True, method='stockham')),
    ('r2', (16, 32), dict(method='stockham')),
    ('r1', (4096,), dict(method='stockham')),
    ('r1_real', (4096,), dict(real=True, method='stockham')),
    ('r3_overlap', (16, 16, 16), dict(method='stockham', overlap_chunks=2)),
    ('r1_overlap', (4096,), dict(method='stockham', overlap_chunks=2)),
    ('r3_fp16', (16, 16, 16), dict(method='stockham', wire_dtype='fp16')),
]

#: the pod tree each mesh runs beside 'ppermute' and 'hierarchical'
POD_TREES = {'2x2': 'pod_tree:x.2*y.2', '1x4': 'pod_tree:y.2*y.2',
             '2x4': 'pod_tree:x.2*y.2*y.2'}


def strategies_for(mesh: str):
    return ('ppermute', 'hierarchical', POD_TREES[mesh])


#: (shard_pos, mem_pos) of the bare swaps, on blocks of (8, 8, 16, 8)
SWAPS = [(0, 1), (1, 0), (2, 3), (3, 1)]

#: (name, shape, plan options) of suite 'pod': a batch of 4 sharded over 'pod'
POD_BATCH = 4
POD_CASES = [
    ('pod_r3', (16, 16, 16), dict(method='stockham')),
    ('pod_r3_real', (16, 16, 16), dict(method='stockham', real=True, padded_spectrum=True)),
    ('pod_r1', (4096,), dict(method='stockham')),
    ('pod_r1_real', (4096,), dict(method='stockham', real=True)),
]

#: (name, shape, plan_op options) of suite 'op', by mesh; each with one
#: runtime factor on a batch of 2
OP_CASES = {
    '2x2': [('op_r3_real', (16, 16, 16), dict(real=True, method='stockham')),
            ('op_r3', (16, 16, 16), dict(real=False, method='stockham'))],
    '1x4': [('op_r1_real', (4096,), dict(real=True, method='stockham')),
            ('op_r1', (4096,), dict(real=False, method='stockham'))],
}


def operands(shape, real: bool, batch: int, seed: int):
    """The global numpy operand of a case (``batch=0``: no batch dim),
    the same on every rank and in the reference."""
    rng = np.random.default_rng(list(shape) + [seed])
    full = ((batch,) if batch else ()) + tuple(shape)
    x = rng.standard_normal(full)
    if not real:
        x = x + 1j * rng.standard_normal(full)
    return x.astype(np.float32 if real else np.complex64)


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


def _vs_unchunked(p, x_in, y, x2):
    """The plan against itself with ``overlap_chunks=1``: forward on the
    same block, inverse on the same spectrum."""
    q = p.with_options(overlap_chunks=1)
    return {'fwd_vs_unchunked': _gap(y, q.forward(x_in)),
            'inv_vs_unchunked': _gap(x2, q.inverse(y))}


def _case(mesh, single, shape, kw, batch=BATCH, comm='all_to_all'):
    rng = np.random.default_rng(list(shape))
    x = rng.standard_normal((batch,) + shape) + 1j * rng.standard_normal((batch,) + shape)
    xt = torch.as_tensor(x.astype(np.complex64), device=mesh.device)
    axes = tuple(range(1, len(shape) + 1))
    want_np = torch.as_tensor(np.fft.fftn(x, axes=axes).astype(np.complex64),
                              device=mesh.device)
    p = fft.plan(shape, mesh, **(dict(comm=comm) if comm else {}), **kw)
    single_kw = {k: v for k, v in kw.items()
                 if k not in ('wire_dtype', 'layout', 'mesh_axes', 'overlap_chunks')}
    p1 = fft.plan(shape, single, comm='all_to_all', **dict(single_kw, method=p.method))
    y1 = p1.forward(xt)
    x_in = mesh.shard(xt, p.in_layout, batch_ndim=1)
    y = p.forward(x_in)
    x2 = p.inverse(y)
    rec = {
        'fwd_vs_single': _gap(y, mesh.shard(y1, p.out_layout, batch_ndim=1)),
        'fwd_vs_numpy': _gap(y, mesh.shard(want_np, p.out_layout, batch_ndim=1)),
        'roundtrip': _gap(x2, mesh.shard(xt, p.in_layout, batch_ndim=1)),
        'shape_ok': (tuple(y.shape) == (batch,) + p.local_shape(p.out_layout)
                     and tuple(x2.shape) == (batch,) + p.local_shape(p.in_layout)),
        'resolved': [p.comm, p.overlap_chunks, p.method],
    }
    if kw.get('wire_dtype', 'native') != 'native':
        native = p.with_options(wire_dtype='native')
        rec['fwd_vs_native_wire'] = _gap(y, native.forward(mesh.shard(xt, p.in_layout, 1)))
    if p.overlap_chunks > 1:
        rec.update(_vs_unchunked(p, x_in, y, x2))
    rec.update(_vs_all_to_all(p, x_in, y, x2))
    return rec


def _vs_all_to_all(p, x_in, y, x2):
    """A plan on another strategy against the same plan on all_to_all,
    forward on the same block and inverse on the same spectrum."""
    if p.comm == 'all_to_all':
        return {}
    q = p.with_options(comm='all_to_all')
    return {'fwd_vs_all_to_all': _gap(y, q.forward(x_in)),
            'inv_vs_all_to_all': _gap(x2, q.inverse(y))}


def _real_case(mesh, single, shape, kw, batch=BATCH, comm='all_to_all'):
    rng = np.random.default_rng(list(shape) + [1])
    x = rng.standard_normal((batch,) + shape)
    xt = torch.as_tensor(x.astype(np.float32), device=mesh.device)
    p = fft.rplan(shape, mesh, **(dict(comm=comm) if comm else {}), **kw)
    p1 = fft.rplan(shape, single, comm='all_to_all', method=p.method)
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

    x_in = mesh.shard(xt, p.in_layout, batch_ndim=1)
    y = p.forward(x_in)
    x2 = p.inverse(y)
    rec = {
        'fwd_vs_single': _gap(y, block(want_single)),
        'fwd_vs_numpy': _gap(y, block(want_np)),
        'roundtrip': _gap(x2, x_in),
        'shape_ok': (tuple(y.shape) == (batch,) + p.spectrum_local_shape()
                     and y.shape[-1] == keep.numel()
                     and tuple(x2.shape) == (batch,) + p.local_shape(p.in_layout)),
        'resolved': [p.comm, p.overlap_chunks, p.method],
    }
    if p.overlap_chunks > 1:
        rec.update(_vs_unchunked(p, x_in, y, x2))
    rec.update(_vs_all_to_all(p, x_in, y, x2))
    return rec


def _real1d_case(mesh, single, shape, kw, batch=BATCH, comm='all_to_all'):
    """A rank-1 rplan: the spectrum is whole on every rank."""
    rng = np.random.default_rng(list(shape) + [1])
    x = rng.standard_normal((batch,) + shape)
    xt = torch.as_tensor(x.astype(np.float32), device=mesh.device)
    p = fft.rplan(shape, mesh, **(dict(comm=comm) if comm else {}), **kw)
    single_kw = {k: v for k, v in kw.items() if k not in ('wire_dtype', 'overlap_chunks')}
    p1 = fft.rplan(shape, single, comm='all_to_all', **dict(single_kw, method=p.method))
    want_np = torch.as_tensor(np.fft.rfft(x).astype(np.complex64), device=mesh.device)
    x_in = mesh.shard(xt, p.in_layout, batch_ndim=1)
    y = p.forward(x_in)
    x2 = p.inverse(y)
    rec = {
        'fwd_vs_single': _gap(y, p1.forward(xt)),
        'fwd_vs_numpy': _gap(y, want_np),
        'roundtrip': _gap(x2, x_in),
        'shape_ok': (tuple(y.shape) == (batch, shape[0] // 2 + 1)
                     and tuple(x2.shape) == tuple(x_in.shape)),
        'resolved': [p.comm, p.overlap_chunks, p.method],
    }
    if p.overlap_chunks > 1:
        rec.update(_vs_unchunked(p, x_in, y, x2))
    rec.update(_vs_all_to_all(p, x_in, y, x2))
    return rec


def _any_case(mesh, single, shape, kw, comm=None):
    kw = dict(kw)
    if not kw.pop('real', False):
        return _case(mesh, single, shape, kw, comm=comm)
    if len(shape) == 1:
        return _real1d_case(mesh, single, shape, kw, comm=comm)
    return _real_case(mesh, single, shape, kw, comm=comm)


def _swaps(mesh, names):
    """Each strategy's bare swap against all_to_all's on the same random
    block, for every mesh-axis group and (shard_pos, mem_pos) of
    ``SWAPS``: name -> True where every one is bitwise equal."""
    from repro_torch.comm import strategies
    gen = torch.Generator().manual_seed(dist.get_rank())
    x = torch.randn((8, 8, 16, 8), generator=gen).to(mesh.device)
    a2a = strategies.get('all_to_all')
    out = {}
    for name in names:
        same = True
        for axis in ('x', 'y', ('x', 'y')):
            for sp, mp in SWAPS:
                kw = dict(shard_pos=sp, mem_pos=mp)
                want = a2a.swap_start(x, mesh, axis, **kw).wait()
                got = strategies.get(name).swap_start(x, mesh, axis, **kw).wait()
                same = same and got.shape == want.shape and torch.equal(got, want)
        out[name] = same
    return out


def _pod_case(mesh, single, shape, kw, ref):
    """A plan with ``batch_spec='pod'``: this rank's block of its pod's
    slice of the batch."""
    kw = dict(kw)
    real = kw.pop('real', False)
    x = operands(shape, real, POD_BATCH, 3)
    xt = torch.as_tensor(x, device=mesh.device)
    make = fft.rplan if real else fft.plan
    p = make(shape, mesh, batch_spec='pod', **kw)
    axes = tuple(range(1, len(shape) + 1))
    want = torch.as_tensor(
        (np.fft.rfftn(x, axes=axes) if real else np.fft.fftn(x, axes=axes)).astype(np.complex64))
    # a padded half spectrum is as long as the mesh's plan pads it
    pad = (0, p.spectrum_shape[-1] - want.shape[-1])
    y1 = torch.nn.functional.pad(make(shape, single, comm='all_to_all', **kw).forward(xt), pad)
    want = torch.nn.functional.pad(want, pad)

    def block(g, layout):
        g = torch.as_tensor(g).to(mesh.device)
        return mesh.shard(g, layout, batch_ndim=1, batch_spec='pod')

    x_in = block(xt, p.in_layout)
    y = p.forward(x_in)
    x2 = p.inverse(y)
    rec = {
        'fwd_vs_single': _gap(y, block(y1, p.out_layout)),
        'fwd_vs_numpy': _gap(y, block(want, p.out_layout)),
        'roundtrip': _gap(x2, x_in),
        'shape_ok': (tuple(y.shape) == (POD_BATCH // mesh.shape['pod'],)
                     + p.spectrum_local_shape()
                     and tuple(x2.shape) == tuple(x_in.shape)),
        'resolved': [p.comm, p.overlap_chunks, p.method],
    }
    if ref is not None:
        rec['fwd_vs_reference'] = _gap(y, block(ref.astype(np.complex64), p.out_layout))
    return rec


def _op_case(mesh, single, shape, kw, ref):
    """``plan_op`` with one runtime factor, against the single-process
    operator, its unfused composition on the mesh, numpy and the
    reference; the factor baked in both forms against it."""
    kw = dict(kw)
    real = kw.pop('real')
    x, k = operands(shape, real, BATCH, 5), operands(shape, real, 0, 6)
    xt, kt = (torch.as_tensor(a, device=mesh.device) for a in (x, k))
    op = fft.plan_op(shape, mesh, op=fft.spectral_mul, real=real, n_spectra=1, **kw)
    op1 = fft.plan_op(shape, single, op=fft.spectral_mul, real=real, n_spectra=1,
                      **dict(kw, method=op.method, comm='all_to_all'))
    lay = op.in_layout
    x_in, k_in = mesh.shard(xt, lay, batch_ndim=1), mesh.shard(kt, lay)
    y = op.apply(x_in, k_in)
    # the unfused composition on the mesh: the plain plan of the same
    # resolved options (the padded spectrum of a real rank-2/3 plan)
    p = fft.plan(shape, mesh, real=real, padded_spectrum=op.padded_spectrum,
                 method=op.method, comm=op.comm, overlap_chunks=op.overlap_chunks)
    s, sk = p.forward(x_in), p.forward(k_in)
    unfused = p.inverse(torch.complex(*fft.spectral_mul(s.real, s.imag, (sk.real, sk.imag))))
    axes, kaxes = tuple(range(1, len(shape) + 1)), tuple(range(len(shape)))
    if real:
        want = np.fft.irfftn(np.fft.rfftn(x, axes=axes) * np.fft.rfftn(k, axes=kaxes),
                             s=shape, axes=axes)
    else:
        want = np.fft.ifftn(np.fft.fftn(x, axes=axes) * np.fft.fftn(k, axes=kaxes), axes=axes)
    want = torch.as_tensor(want.astype(x.dtype), device=mesh.device)
    baked = fft.plan_op(shape, mesh, op=fft.spectral_mul, real=real, spectra=(k,), **kw)
    for _ in range(3):
        yb = baked.apply(x_in)
    # the single-process plan's own spectrum of the factor, np.fft order
    own = (fft.rplan if real else fft.plan)(shape, single, method=op.method).forward(kt)
    spec = fft.plan_op(shape, mesh, op=fft.spectral_mul, real=real, spectra=(own.cpu(),),
                       spectra_form='spectrum', **kw)
    rec = {
        'vs_single': _gap(y, mesh.shard(op1.apply(xt, kt), lay, batch_ndim=1)),
        'vs_unfused': _gap(y, unfused),
        'vs_numpy': _gap(y, mesh.shard(want, lay, batch_ndim=1)),
        'baked_vs_runtime': _gap(yb, y),
        'spectrum_vs_runtime': _gap(spec.apply(x_in), y),
        'shape_ok': tuple(y.shape) == tuple(x_in.shape) and y.dtype == x_in.dtype,
        'resolved': [op.comm, op.overlap_chunks, op.method, baked.bake_count],
    }
    if ref is not None:
        g = torch.as_tensor(ref.astype(x.dtype), device=mesh.device)
        rec['vs_reference'] = _gap(y, mesh.shard(g, lay, batch_ndim=1))
    return rec


def _suite(mesh, single, mesh_name: str, suite: str, refs=None) -> dict:
    refs = {} if refs is None else refs
    if suite == 'pod':
        return {name: _pod_case(mesh, single, shape, kw, refs.get(name))
                for name, shape, kw in POD_CASES}
    if suite == 'op':
        return {name: _op_case(mesh, single, shape, kw, refs.get(name))
                for name, shape, kw in OP_CASES[mesh_name]}
    if suite == 'base':
        mine = {name: _case(mesh, single, shape, kw) for name, shape, kw in CASES}
        mine.update({name: _real_case(mesh, single, shape, kw)
                     for name, shape, kw in REAL_CASES})
        mine.update({name: _case(mesh, single, shape, kw, batch=1, comm=None)
                     for name, shape, kw in OVERLAP_CASES})
        mine.update({name: _real_case(mesh, single, shape, kw, batch=1, comm=None)
                     for name, shape, kw in REAL_OVERLAP_CASES})
        mine.update({name: _any_case(mesh, single, shape, kw)
                     for name, shape, kw in RANK1_CASES})
        return mine
    mine = {}
    for comm in strategies_for(mesh_name):
        for name, shape, kw in STRATEGY_PLANS:
            mine[f'{comm}/{name}'] = _any_case(mesh, single, shape, kw, comm=comm)
    return mine


def run(rank: int, port: int, out: str, device: str, mesh_name: str, suite: str,
        pods: int = 1, ref=None) -> None:
    rows, cols = (int(v) for v in mesh_name.split('x'))
    world = rows * cols * pods
    if device == 'cuda':
        torch.cuda.set_device(rank)
    else:
        # the ranks share the host's cores: one thread each, or their
        # thread pools spin against one another (ten times slower at 64^3)
        torch.set_num_threads(1)
    dist.init_process_group('nccl' if device == 'cuda' else 'gloo',
                            init_method=f'tcp://localhost:{port}',
                            rank=rank, world_size=world)
    try:
        mesh = make_fft_mesh(rows, cols, pods=pods, device=device)
        single = make_fft_mesh(1, 1, device=device)
        refs = dict(np.load(ref)) if ref else None
        mine = _suite(mesh, single, mesh_name, suite, refs)
        swaps = _swaps(mesh, strategies_for(mesh_name)) if suite == 'strategies' else {}
        every = [None] * world
        dist.all_gather_object(every, (mine, swaps))
        if rank == 0:
            merged = {}
            for name in mine:
                recs = [r[0][name] for r in every]
                m = {'shape_ok': all(r['shape_ok'] for r in recs),
                     'resolved': recs[0]['resolved']}
                for key in recs[0]:
                    if key not in ('shape_ok', 'resolved'):
                        err = max(r[key][0] for r in recs)
                        ref = max(r[key][1] for r in recs)
                        m[key] = err / ref
                merged[name] = m
            for name in swaps:
                merged[f'swap/{name}'] = all(r[1][name] for r in every)
            with open(out, 'w') as fh:
                json.dump(merged, fh)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('out')
    ap.add_argument('port', type=int)
    ap.add_argument('device', nargs='?', default='cpu', choices=('cpu', 'cuda'))
    ap.add_argument('--mesh', default='2x2', choices=sorted(POD_TREES) + ['1x2'])
    ap.add_argument('--pods', type=int, default=1)
    ap.add_argument('--suite', default='base', choices=('base', 'strategies', 'pod', 'op'))
    ap.add_argument('--ref', default=None, help='.npz of global reference results by case')
    args = ap.parse_args()
    rows, cols = (int(v) for v in args.mesh.split('x'))
    mp.spawn(run, args=(args.port, args.out, args.device, args.mesh, args.suite, args.pods,
                        args.ref),
             nprocs=rows * cols * args.pods, join=True)
