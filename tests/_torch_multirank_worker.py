"""Worker: the port's distributed FFT on gloo CPU ranks (or NCCL cards).

Run in a subprocess so the test process never initialises a process
group:

    python tests/_torch_multirank_worker.py OUT.json PORT [cpu|cuda]
        [--mesh 2x2] [--pods 1] [--suite base|strategies|pod|op|grad|serve]
        [--ref REF.npz] [--serve-n N]

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

Suite ``grad`` (``GRAD_CASES``, 2 x 2, needs ``--ref``): the gradient
of a global loss, ``sum(c * |y|^2)`` with fixed random weights ``c``,
through ``plan.forward`` (complex, planar) and through a real
``plan_op`` apply with one runtime factor, each rank calling
``torch.autograd.grad`` on its own part of the loss; the swaps' backward
exchanges the cotangents. Each rank's block of the gradient is held
against the same block of the JAX package's ``jax.grad`` on one device
(the gradient of a global loss does not depend on the mesh or the
strategy), as a relative L2 over all ranks (keys ``l2_*``).

Suite ``serve`` (2 x 2): one ``repro_torch.serve.FFTEngine`` a rank,
``flush()`` only (a multi-rank mesh refuses the drainer, checked too),
serving ``SERVE_SHAPE`` from global numpy operands (``serve_operands``):
complex, real and planar forwards, the inverses of the complex results
and ``register_op`` requests (a baked factor), each rank passing its
blocks. Every result is held bitwise against the same rank's
per-request ``plan.forward``/``inverse``/``apply`` and, with ``--ref``,
against the JAX package's engine (its fused-operator executor for the
op requests) as a relative L2 over all ranks. With ``--serve-n N`` it
serves 8 complex N^3 requests instead, made on each rank's device, and
times the stream (``us_per_request``, the slowest rank's, median of 3)
beside the same requests through ``plan.forward`` one at a time.

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


#: (name, options of both plans) of suite 'grad', 16^3 four_step, batch 2
GRAD_SHAPE = (16, 16, 16)
GRAD_CASES = [
    ('grad_all_to_all', dict(comm='all_to_all')),
    ('grad_ppermute', dict(comm='ppermute')),
    ('grad_hierarchical', dict(comm='hierarchical')),
    ('grad_fp16', dict(comm='all_to_all', wire_dtype='fp16')),
    ('grad_overlap', dict(comm='all_to_all', overlap_chunks=2)),
]


def grad_operands():
    """The grad suite's global numpy operands: the complex plan's input,
    the real operator's input and factor, and the loss weights of each."""
    x = operands(GRAD_SHAPE, False, BATCH, 7)
    xr, k = operands(GRAD_SHAPE, True, BATCH, 8), operands(GRAD_SHAPE, True, 0, 9)
    rng = np.random.default_rng(10)
    c, cr = (rng.random((BATCH,) + GRAD_SHAPE).astype(np.float32) for _ in range(2))
    return x, xr, k, c, cr


def _l2(got, want):
    """(squared L2 error, squared L2 norm of ``want``) of this rank's block."""
    return float(((got - want) ** 2).sum()), float((want ** 2).sum())


def _grad_case(mesh, kw, ref):
    x, xr, k, c, cr = grad_operands()
    dev = mesh.device
    p = fft.plan(GRAD_SHAPE, mesh, method='four_step', **kw)
    re, im = (mesh.shard(torch.as_tensor(a, device=dev), p.in_layout, batch_ndim=1)
              .requires_grad_() for a in (x.real.copy(), x.imag.copy()))
    cy = mesh.shard(torch.as_tensor(c, device=dev), p.out_layout, batch_ndim=1)
    yr, yi = p.forward((re, im))
    gr, gi = torch.autograd.grad((cy * (yr ** 2 + yi ** 2)).sum(), (re, im))
    wire = kw.get('wire_dtype', 'native')
    want = ref[f'grad_plan_{wire}']
    wr, wi = (mesh.shard(torch.as_tensor(np.ascontiguousarray(a), device=dev), p.in_layout,
                         batch_ndim=1) for a in (want.real, want.imag))
    op = fft.plan_op(GRAD_SHAPE, mesh, op=fft.spectral_mul, real=True, n_spectra=1,
                     method='four_step', **kw)
    lay = op.in_layout
    x_in = mesh.shard(torch.as_tensor(xr, device=dev), lay, batch_ndim=1).requires_grad_()
    k_in = mesh.shard(torch.as_tensor(k, device=dev), lay)
    cx = mesh.shard(torch.as_tensor(cr, device=dev), lay, batch_ndim=1)
    y = op.apply(x_in, k_in)
    g, = torch.autograd.grad((cx * y ** 2).sum(), x_in)
    want_op = mesh.shard(torch.as_tensor(ref[f'grad_op_{wire}'], device=dev), lay,
                         batch_ndim=1)
    e_re, n_re = _l2(gr, wr)
    e_im, n_im = _l2(gi, wi)
    return {'l2_plan': (e_re + e_im, n_re + n_im), 'l2_op': _l2(g, want_op),
            'shape_ok': gr.shape == re.shape and g.shape == x_in.shape,
            'resolved': [p.comm, p.overlap_chunks, p.method, op.comm, op.overlap_chunks]}


#: the serve suite's transform and its stream: (kind, requests)
SERVE_SHAPE = (16, 16, 16)
SERVE_STREAM = (('complex', 5), ('real', 3), ('planar', 2), ('op', 3))
#: requests of the timed stream (``--serve-n``)
SERVE_BENCH_REQUESTS = 8


def serve_operands():
    """The serve suite's global numpy requests by kind, and the op's
    baked factor ('k')."""
    ops = {'k': operands(SERVE_SHAPE, True, 0, 20)}
    for i, (kind, n) in enumerate(SERVE_STREAM):
        if kind == 'planar':
            ops[kind] = [tuple(operands(SERVE_SHAPE, True, 0, 100 * i + 2 * j + d)
                               for d in range(2)) for j in range(n)]
        else:
            ops[kind] = [operands(SERVE_SHAPE, kind != 'complex', 0, 100 * i + j)
                         for j in range(n)]
    return ops


def _spectrum_block(p, mesh, g):
    """This rank's block of a real plan's global np-order spectrum ``g``:
    the first bins of its padded block, as the plan's forward keeps."""
    pp = p.with_options(padded_spectrum=True)
    g = torch.nn.functional.pad(torch.as_tensor(g, device=mesh.device),
                                (0, pp.spectrum_shape[-1] - g.shape[-1]))
    return mesh.shard(g, pp.out_layout)[..., :p.spectrum_local_shape()[-1]]


def _serve_case(mesh, ref):
    from repro_torch.serve import FFTEngine
    ops = serve_operands()
    dev = mesh.device
    try:
        FFTEngine(SERVE_SHAPE, mesh, max_wait_ms=2.0)
    except ValueError as e:
        refused = 'multi-rank drainer' in str(e)
    else:
        refused = False
    eng = FFTEngine(SERVE_SHAPE, mesh, max_coalesce=4, schedule_table=None)
    pc, pr = eng.plan_for(False), eng.plan_for(True)
    op = eng.register_op('conv', op=fft.spectral_mul, real=True, spectra=(ops['k'],))

    def blk(g, lay):
        return mesh.shard(torch.as_tensor(g, device=dev), lay)
    xs = {'complex': [blk(x, pc.in_layout) for x in ops['complex']],
          'real': [blk(x, pr.in_layout) for x in ops['real']],
          'planar': [tuple(blk(a, pc.in_layout) for a in x) for x in ops['planar']],
          'op': [blk(x, op.in_layout) for x in ops['op']]}
    tickets = {k: [] for k in xs}
    for j in range(max(len(v) for v in xs.values())):     # interleaved kinds
        for kind, v in xs.items():
            if j < len(v):
                tickets[kind].append(eng.submit(v[j], op='conv' if kind == 'op' else None))
    eng.flush()
    got = {k: [t.result() for t in ts] for k, ts in tickets.items()}
    got['inverse'] = eng.transform(got['complex'], direction='inv')
    one = {'complex': [pc.forward(x) for x in xs['complex']],
           'real': [pr.forward(x) for x in xs['real']],
           'planar': [pc.forward(x) for x in xs['planar']],
           'op': [op.apply(x) for x in xs['op']],
           'inverse': [pc.inverse(y) for y in got['complex']]}
    flat = [(a, b) for k in one for y, z in zip(got[k], one[k])
            for a, b in (zip(y, z) if isinstance(y, tuple) else ((y, z),))]
    rec = {'bitwise': all(torch.equal(a, b) for a, b in flat),
           'drainer_refused': refused, 'shape_ok': True,
           'resolved': [list(eng.schedule(False)), list(eng.schedule(True)),
                        list(eng.schedule(op='conv')), eng.dispatch_stats()['groups']]}
    if ref is not None:
        for kind, ys in got.items():
            err = nrm = 0.0
            for j, y in enumerate(ys):
                g = ref[f'serve_{kind}_{j}']
                if kind == 'real':
                    want = _spectrum_block(pr, mesh, g)
                else:
                    want = blk(g, {'complex': pc.out_layout, 'planar': pc.out_layout,
                                   'inverse': pc.in_layout, 'op': op.in_layout}[kind])
                if isinstance(y, tuple):
                    y = torch.complex(*y)
                e, r = _l2(torch.view_as_real(y) if y.is_complex() else y,
                           torch.view_as_real(want) if want.is_complex() else want)
                err, nrm = err + e, nrm + r
            rec[f'l2_{kind}'] = (err, nrm)
    return rec


def _serve_bench(mesh, n):
    """The timed stream: ``SERVE_BENCH_REQUESTS`` complex n^3 requests,
    each rank's blocks made on its device, ``flush()``; the wall time of
    the stream from the first submit to the last result, the card
    synchronized, median of 3, a request; and of the same requests
    through ``plan.forward`` one at a time."""
    import statistics
    import time
    from repro_torch.serve import FFTEngine
    eng = FFTEngine((n,) * 3, mesh, max_coalesce=4, schedule_table=None)
    p = eng.plan_for(False)
    gen = torch.Generator(device=mesh.device).manual_seed(1000 + dist.get_rank())
    shape = p.local_shape(p.in_layout)
    xs = [torch.complex(torch.randn(shape, generator=gen, device=mesh.device),
                        torch.randn(shape, generator=gen, device=mesh.device))
          for _ in range(SERVE_BENCH_REQUESTS)]

    cuda = mesh.device.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def wall(fn):
        times = []
        for _ in range(3):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            times.append((time.perf_counter() - t0) / len(xs) * 1e6)
        return statistics.median(times), out

    def stream():
        tickets = [eng.submit(x) for x in xs]
        eng.flush()
        return [t.result() for t in tickets]
    stream()                                              # warm
    g0 = eng.dispatch_stats()['groups']
    us, ys = wall(stream)
    groups = (eng.dispatch_stats()['groups'] - g0) // 3   # a stream
    seq_us, _ = wall(lambda: [p.forward(x) for x in xs])
    bitwise = all(torch.equal(y, p.forward(x)) for x, y in zip(xs, ys))
    return {'bitwise': bitwise, 'shape_ok': True, 'us_per_request': us,
            'us_sequential_per_request': seq_us,
            'peak_gib': torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0,
            'resolved': [list(eng.schedule(False)), p.comm, p.method, groups]}


def _grad_gather(mesh):
    """A real rank-1 plan's forward gathers the spectrum: the gradient
    of a loss of the whole spectrum (every rank's alike) through it
    against the one-rank plan's, this rank's block of the operand."""
    single = make_fft_mesh(1, 1, device=mesh.device.type)
    x = torch.as_tensor(operands((4096,), True, BATCH, 11), device=mesh.device)
    c = torch.as_tensor(np.random.default_rng(12).random((BATCH, 2049)).astype(np.float32),
                        device=mesh.device)
    grads = []
    for m in (mesh, single):
        p = fft.rplan((4096,), m, method='four_step')
        xl = m.shard(x, p.in_layout, batch_ndim=1).requires_grad_()
        g, = torch.autograd.grad((c * p.forward(xl).abs() ** 2).sum(), xl)
        grads.append((g, p))
    (g, p), (want, _) = grads
    return {'l2_gather': _l2(g, mesh.shard(want, p.in_layout, batch_ndim=1)),
            'refused': False, 'shape_ok': g.shape == (BATCH, 4096 // mesh.size),
            'resolved': [p.comm]}


def _suite(mesh, single, mesh_name: str, suite: str, refs=None, serve_n=0) -> dict:
    refs = {} if refs is None else refs
    if suite == 'serve':
        if serve_n:
            return {f'serve_{serve_n}': _serve_bench(mesh, serve_n)}
        return {'serve': _serve_case(mesh, refs or None)}
    if suite == 'grad':
        mine = {name: _grad_case(mesh, kw, refs) for name, kw in GRAD_CASES}
        mine['grad_gather'] = _grad_gather(mesh)
        return mine
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
        pods: int = 1, ref=None, serve_n: int = 0) -> None:
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
        mine = _suite(mesh, single, mesh_name, suite, refs, serve_n)
        swaps = _swaps(mesh, strategies_for(mesh_name)) if suite == 'strategies' else {}
        every = [None] * world
        dist.all_gather_object(every, (mine, swaps))
        if rank == 0:
            merged = {}
            for name in mine:
                recs = [r[0][name] for r in every]
                m = {'resolved': recs[0]['resolved']}
                for key in recs[0]:
                    if isinstance(recs[0][key], bool):
                        m[key] = all(r[key] for r in recs)
                    elif key.startswith('us_') or key == 'peak_gib':
                        m[key] = max(r[key] for r in recs)      # the slowest rank
                    elif key.startswith('l2_'):
                        err = sum(r[key][0] for r in recs)
                        m[key] = (err / sum(r[key][1] for r in recs)) ** 0.5
                    elif key != 'resolved':
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
    ap.add_argument('--suite', default='base',
                    choices=('base', 'strategies', 'pod', 'op', 'grad', 'serve'))
    ap.add_argument('--serve-n', type=int, default=0,
                    help='suite serve: time 8 complex N^3 requests instead')
    ap.add_argument('--ref', default=None, help='.npz of global reference results by case')
    args = ap.parse_args()
    rows, cols = (int(v) for v in args.mesh.split('x'))
    mp.spawn(run, args=(args.port, args.out, args.device, args.mesh, args.suite, args.pods,
                        args.ref, args.serve_n),
             nprocs=rows * cols * args.pods, join=True)
