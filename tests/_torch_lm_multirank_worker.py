"""Worker: the port's comm surface and sharded language-model server on
gloo CPU ranks (or NCCL cards).

Run in a subprocess so the test process never initialises a process
group:

    python tests/_torch_lm_multirank_worker.py OUT PORT [cpu|cuda]
        [--mesh 2x2|1x4|1x3] [--suite comm|lm|ops|bench|train|trainbench]
        [--ref REF.npz] [--rows ARCH:DTYPE[:LAYERS] ...] [--group a|b]

Every rank makes the same global operands and parameters from seeds and
takes its blocks of them. Rank 0 writes OUT: a JSON of records
(``comm``, ``bench``) or an ``.npz`` of whole results (``lm``, ``ops``).

* ``comm`` (an ('x', 'y') mesh): ``comm.swap_axes``, ``apply_swap``,
  ``redistribute`` and ``pod_fold`` under every registered strategy on
  ``COMM_X``, each rank's result against its block of the reference's
  (``--ref``, from ``_torch_lm_jax_reference.py``), bitwise;
  ``group_size`` / ``group_index`` against the reference's; autograd
  through ``swap_axes`` against the explicit reverse swap (bitwise); the
  real rank-1 plan's gathered spectrum, its gradient against the one-rank
  plan's.
* ``lm`` (a ('data', 'model') mesh): ``ServeEngine`` on each config of
  ``LM_ARCHS`` at smoke size, fp32, parameters drawn whole (seed
  ``PARAM_SEED``) and cut by ``weights.shard_params``: the generated
  tokens, and the prefill and decode logits teacher-forced on the
  reference's tokens (``--ref``); an MoE config also at ``NO_DROP_CF``
  (its logits held against the one-rank port's); ``SP_ARCHS`` through
  ``make_prefill_step(sp=True)``.
* ``ops``: ``ulysses_attention`` (``ULYSSES_CASES``) and
  ``moe_ep_explicit`` (``MOE_CASES``) on this rank's blocks, with
  ``overlap_chunks`` 1 and 2, gathered whole.
* ``bench`` (``cuda``, 1 x 4, 2 x 2 or 1 x 3): the multi-card rows of
  ``benchmarks/torch_multirank_cuda.py --suite lm`` (``BENCH_ROWS``).
* ``train`` (``--group``, the cases of one test file, ``TRAIN_CASES``):
  the sharded trainer (``jit_train_step``) on meshes of 2 x 2, 1 x 4 and
  4 x 1 at smoke size, fp32: each step's metrics and the gathered
  parameters and optimizer state (the reference's from
  ``_torch_lm_jax_reference.py train``), the FFT-conv LM beside the
  one-rank port; group ``a`` also the sharded checkpoint restored on
  other meshes, the new collectives' backward, and ``draw_params`` on
  every mesh.
* ``trainbench`` (``cuda``, 2 x 2 or 1 x 4): the four-card rows of
  ``benchmarks/torch_multirank_cuda.py --suite train``
  (``TRAIN_BENCH_ROWS``); on ``cpu`` a rehearsal of them at smoke size.
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, '..', 'src'))

from repro_torch import comm  # noqa: E402
from repro_torch import fft  # noqa: E402
from repro_torch.configs import get_config, input_specs, make_batch, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh, make_host_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.parallel import (Parallel, gather_tree, make_rules, shard_tree,  # noqa: E402
                                  spec_for)
from repro_torch.parallel.sharding import local_block  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.engine import make_prefill_step  # noqa: E402
from repro_torch.data import shard_batch  # noqa: E402
from repro_torch.train import jit_train_step, make_train_step  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402
from repro_torch.weights import (_shard, draw_params, opt_to_reference,  # noqa: E402
                                 params_to_reference, shard_params, unshard_params)

# ---------------------------------------------------------------------------
# Cases (the reference script imports these)
# ---------------------------------------------------------------------------

#: the comm suite's global operand, (8, 8, 8) float32
COMM_SHAPE, COMM_SEED = (8, 8, 8), 31
#: (name, input layout, mesh axis, mem_pos) of the swaps
SWAP_CASES = [('swap_y', ('x', 'y', None), 'y', 2),
              ('swap_x', ('x', 'y', None), 'x', 2),
              ('swap_xy', (('x', 'y'), None, None), ('x', 'y'), 1)]
#: (name, source layout, destination layout)
REDIST_CASES = [('redist', ('x', 'y', None), (None, 'x', 'y')),
                ('redist_xy', (('x', 'y'), None, None), (None, None, ('x', 'y')))]
#: (name, input layout, pod axis, batch_pos): the gathered axis comes out whole
FOLD_CASES = [('fold_x', ('x', None, None), 'x', 0), ('fold_y', (None, 'y', None), 'y', 1)]
GROUP_AXES = ('x', 'y', ('x', 'y'))


def comm_operand() -> np.ndarray:
    return np.random.default_rng(COMM_SEED).standard_normal(COMM_SHAPE).astype(np.float32)


def out_layout(layout, mesh_axis, mem_pos):
    lay = list(layout)
    lay[lay.index(mesh_axis)] = None
    lay[mem_pos] = mesh_axis
    return tuple(lay)


def fold_layout(layout, pod_axis):
    return tuple(None if a == pod_axis else a for a in layout)


#: the served configs at smoke size, fp32, 4 prompts, 4 new tokens
LM_ARCHS = ('internlm2-1.8b', 'qwen1.5-32b', 'dbrx-132b', 'deepseek-v2-236b',
            'recurrentgemma-9b', 'mamba2-1.3b', 'qwen2-vl-2b')
LM_BATCH, LM_STEPS, PARAM_SEED, PROMPT_SEED = 4, 4, 5, 6
#: prompt lengths (each a multiple of 4, the EP and SP degrees):
#: recurrentgemma-9b's past its smoke window of 16, qwen2-vl-2b's a 4 x 4
#: patch grid and 4 text positions
PROMPTS = {'recurrentgemma-9b': 24, 'qwen2-vl-2b': 20}
PROMPT = 8
#: an MoE config's capacity factor at which no (token, expert) pair
#: drops, for the comparison with the one-rank port (whose groups differ)
NO_DROP_CF = 8.0
#: the configs also prefilled through ``make_prefill_step(sp=True)``
SP_ARCHS = ('internlm2-1.8b', 'recurrentgemma-9b')


#: configs whose query heads the 'model' group does not divide (each rank
#: its ``attention.head_range``): case -> (arch, heads, kv heads, mesh),
#: the arch's smoke config with these head counts, served (``lm``) and
#: trained (``TRAIN_CASES['b']``) on that mesh only: MHA with qkv bias
#: and GQA with groups of 3, 6 heads over 4; MQA with embeds and M-RoPE,
#: 5 heads over 2
UNEVEN = {'mha6': ('qwen1.5-32b', 6, 6, '1x4'), 'gqa6': ('internlm2-1.8b', 6, 2, '1x4'),
          'odd5': ('qwen2-vl-2b', 5, 1, '2x2')}


def base_arch(arch: str):
    """(the published arch, the smoke config's overrides) of a case name:
    an arch, or a key of ``UNEVEN``."""
    if arch in UNEVEN:
        base, H, KH, _ = UNEVEN[arch]
        return base, dict(num_heads=H, num_kv_heads=KH)
    return arch, {}


def lm_config(arch, cf=None):
    base, over = base_arch(arch)
    cfg = dataclasses.replace(smoke_config(get_config(base)), **over)
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


def lm_archs(mesh_name: str) -> tuple:
    """The ``lm`` suite's cases on a mesh: every arch of ``LM_ARCHS``,
    then the ``UNEVEN`` cases of that mesh."""
    return LM_ARCHS + tuple(a for a, c in UNEVEN.items() if c[3] == mesh_name)


def mrope_positions(B: int, S: int, grid: int) -> np.ndarray:
    """(3, B, S) int32: a grid x grid patch grid, then text in all three
    streams (``test_torch_lm_model.mrope_positions``)."""
    n = grid * grid
    r, c = np.divmod(np.arange(n), grid)
    img = np.stack([np.zeros(n, np.int64), r, c])
    text = np.broadcast_to(grid + np.arange(S - n), (3, S - n))
    return np.ascontiguousarray(np.broadcast_to(
        np.concatenate([img, text], axis=1)[:, None], (3, B, S))).astype(np.int32)


def lm_prompts(cfg) -> dict:
    S = PROMPTS.get(cfg.name, PROMPT)
    rng = np.random.default_rng(PROMPT_SEED)
    if cfg.input_mode == 'embeds':
        return {'embeds': rng.standard_normal((LM_BATCH, S, cfg.d_model)).astype(np.float32),
                'positions': mrope_positions(LM_BATCH, S, 4)}
    return {'tokens': rng.integers(0, cfg.vocab_size, (LM_BATCH, S)).astype(np.int32)}


def lm_params(cfg, device='cpu'):
    return M.init_params(torch.Generator(device=device).manual_seed(PARAM_SEED), cfg,
                         torch.float32)


#: (name, B, S, H, KH, D, overlap_chunks) of ``ulysses_attention``:
#: KH = 4 swaps k, v (and pipelines where both head counts divide 2 p);
#: KH = 1 takes the gathered-sequence fallback
ULYSSES_CASES = [('ulysses_gqa', 2, 16, 8, 4, 16, 1), ('ulysses_gqa_c2', 2, 16, 8, 4, 16, 2),
                 ('ulysses_mqa', 2, 16, 8, 1, 16, 1), ('ulysses_mqa_c2', 2, 16, 8, 1, 16, 2)]
ULYSSES_CHUNK = 8
#: (name, arch, overlap_chunks) of ``moe_ep_explicit`` on layer 0's MoE
#: parameters at smoke size; x is (4, 8, d_model)
MOE_CASES = [('moe_dbrx', 'dbrx-132b', 1), ('moe_dbrx_c2', 'dbrx-132b', 2),
             ('moe_deepseek', 'deepseek-v2-236b', 1)]
MOE_SHAPE = (4, 8)


def ulysses_operands(B, S, H, KH, D):
    rng = np.random.default_rng(41)
    return tuple(rng.standard_normal((B, S, h, D)).astype(np.float32) for h in (H, KH, KH))


def moe_operands(arch):
    """(cfg, layer 0's whole MoE parameters (torch), x (numpy))."""
    cfg = lm_config(arch)
    p = M._layer(lm_params(cfg)['blocks'], 0)[f'0_{cfg.block_pattern[0]}']['moe']
    x = np.random.default_rng(43).standard_normal(MOE_SHAPE + (cfg.d_model,))
    return cfg, p, x.astype(np.float32)


#: the sharded trainer's parity cases by test file: (name, arch, mesh,
#: sp); the FFT-conv LM ('fftconv') is held against the one-rank port
TRAIN_CASES = {
    'a': [('2x2/internlm2-1.8b', 'internlm2-1.8b', '2x2', False),
          ('2x2/qwen1.5-32b', 'qwen1.5-32b', '2x2', False),
          ('2x2/dbrx-132b', 'dbrx-132b', '2x2', False),
          ('2x2/deepseek-v2-236b', 'deepseek-v2-236b', '2x2', False),
          ('2x2/internlm2-1.8b/sp', 'internlm2-1.8b', '2x2', True),
          ('2x2/hubert-xlarge', 'hubert-xlarge', '2x2', False)],
    'b': [('2x2/recurrentgemma-9b', 'recurrentgemma-9b', '2x2', False),
          ('2x2/mamba2-1.3b', 'mamba2-1.3b', '2x2', False),
          ('2x2/qwen2-vl-2b', 'qwen2-vl-2b', '2x2', False),
          ('1x4/internlm2-1.8b', 'internlm2-1.8b', '1x4', False),
          ('1x4/dbrx-132b', 'dbrx-132b', '1x4', False),
          ('4x1/internlm2-1.8b', 'internlm2-1.8b', '4x1', False),
          ('4x1/dbrx-132b', 'dbrx-132b', '4x1', False),
          ('2x2/fftconv', 'fftconv', '2x2', False)]
    + [(f'{c[3]}/{name}', name, c[3], False) for name, c in UNEVEN.items()],
}
#: a train case's global batch (rows, positions), microbatches, steps,
#: batch seed (step k draws seed + k) and schedule
TRAIN_SHAPE, TRAIN_MICRO, TRAIN_STEPS, TRAIN_SEED = (8, 32), 2, 2, 9
#: the meshes each group's world of four ranks builds (the first, 2 x 2,
#: also restores the checkpoint of group 'a''s internlm2-1.8b case on the others)
TRAIN_MESHES = {'a': ('2x2', '1x4', '4x1'), 'b': ('2x2', '1x4', '4x1')}
TRAIN_KW = dict(peak_lr=1e-4, warmup_steps=2, total_steps=10)


def train_config(arch: str):
    """A train case's config: smoke size, remat on (each period's FSDP
    gathers recomputed in the backward); 'fftconv' is mamba2-1.3b's
    smoke config with every block the FFT-conv mixer."""
    if arch == 'fftconv':
        cfg = dataclasses.replace(lm_config('mamba2-1.3b'), block_pattern=('fftconv',))
    else:
        cfg = lm_config(arch)
    return dataclasses.replace(cfg, remat=True)


def train_batches(cfg) -> list:
    """Each step's global batch (numpy, ``make_batch`` from a seed; M-RoPE
    positions over a 4 x 4 patch grid)."""
    B, S = TRAIN_SHAPE
    out = []
    for k in range(TRAIN_STEPS):
        b = {n: t.numpy() for n, t in make_batch(cfg, batch=B, seq=S, seed=TRAIN_SEED + k,
                                                 device='cpu').items()}
        if 'positions' in b:
            b['positions'] = mrope_positions(B, S, 4)
        out.append(b)
    return out


def flat_tree(tree, prefix: str) -> dict:
    """A nested dict of arrays as ``{prefix/key/...: array}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f'{prefix}/{k}'))
        return out
    return {prefix: np.asarray(tree)}


# ---------------------------------------------------------------------------
# Suites
# ---------------------------------------------------------------------------

def _comm_suite(mesh, mesh_name, ref) -> dict:
    x = torch.as_tensor(comm_operand())
    out = {}
    for strategy in comm.names():
        for name, lay, ax, mem in SWAP_CASES:
            xl = mesh.shard(x, lay)
            want = mesh.shard(torch.as_tensor(ref[f'{strategy}/{name}']),
                              out_layout(lay, ax, mem))
            y = comm.swap_axes(xl, mesh, ax, shard_pos=lay.index(ax), mem_pos=mem,
                               strategy=strategy)
            y2, lay2 = comm.apply_swap(xl, lay, mesh, ax, mem, strategy=strategy)
            out[f'{strategy}/{name}'] = bool(torch.equal(y, want))
            out[f'{strategy}/{name}/apply_swap'] = (bool(torch.equal(y2, want))
                                                    and lay2 == out_layout(lay, ax, mem))
            # autograd: the adjoint of a swap is the reverse swap
            xg = xl.clone().requires_grad_()
            c = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
            g, = torch.autograd.grad((c * comm.swap_axes(
                xg, mesh, ax, shard_pos=lay.index(ax), mem_pos=mem, strategy=strategy)).sum(),
                xg)
            back = comm.swap_axes(c, mesh, ax, shard_pos=mem, mem_pos=lay.index(ax),
                                  strategy=strategy)
            out[f'{strategy}/{name}/grad'] = bool(torch.equal(g, back))
        for name, src, dst in REDIST_CASES:
            y = comm.redistribute(mesh.shard(x, src), src, dst, mesh, strategy=strategy)
            want = mesh.shard(torch.as_tensor(ref[f'{strategy}/{name}']), dst)
            out[f'{strategy}/{name}'] = bool(torch.equal(y, want))
    for name, lay, ax, pos in FOLD_CASES:
        y = comm.pod_fold(mesh.shard(x, lay), mesh, ax, pos)
        want = mesh.shard(torch.as_tensor(ref[name]), fold_layout(lay, ax))
        out[name] = bool(torch.equal(y, want))
    for ax in GROUP_AXES:
        key = ax if isinstance(ax, str) else '+'.join(ax)
        want = ref[f'group_index/{key}'][mesh.group_index(('x', 'y'))]
        out[f'group/{key}'] = (comm.group_index(mesh, ax) == int(want)
                               and comm.group_size(mesh, ax) == int(ref[f'group_size/{key}']))
    out['gather_rows_grad'] = _gather_rows_grad(mesh)
    return out


def _gather_rows_grad(mesh) -> list:
    """The real rank-1 plan's forward gathers the spectrum: the gradient of
    a loss of the whole spectrum through it, this rank's block against the
    one-rank plan's: (squared error, squared norm)."""
    single = make_fft_mesh(1, 1, device=mesh.device.type)
    x = torch.as_tensor(np.random.default_rng(11).standard_normal((2, 4096)).astype(np.float32),
                        device=mesh.device)
    c = torch.as_tensor(np.random.default_rng(12).random((2, 2049)).astype(np.float32),
                        device=mesh.device)
    grads = []
    for m in (mesh, single):
        p = fft.rplan((4096,), m, method='four_step')
        xl = m.shard(x, p.in_layout, batch_ndim=1).requires_grad_()
        g, = torch.autograd.grad((c * p.forward(xl).abs() ** 2).sum(), xl)
        grads.append((g, p))
    (g, p), (want, _) = grads
    want = mesh.shard(want, p.in_layout, batch_ndim=1)
    return [float(((g - want) ** 2).sum()), float((want ** 2).sum())]


def _teacher_forced(eng, prompts, tokens):
    """Prefill's and each decode step's logits fed ``tokens`` (B, T):
    (B, T, V); the engine's caches updated in place."""
    logits, caches = eng.prefill(prompts)
    out = [logits[:, -1]]
    for t in range(tokens.shape[1] - 1):
        logits, caches = eng.decode(caches, tokens[:, t:t + 1], eng.prompt_len + t)
        out.append(logits[:, -1])
    return torch.stack(out, 1)


def _serve(cfg, mesh, prompts, ref_tokens):
    """(generated tokens, teacher-forced logits) of the sharded engine."""
    rules = make_rules(mesh, mode='serve')
    params = shard_params(lm_params(cfg, mesh.device.type), cfg, rules, mesh)
    S = PROMPTS.get(cfg.name, PROMPT)
    with ServeEngine(cfg, mesh, params, batch=LM_BATCH, prompt_len=S,
                     max_len=S + LM_STEPS) as eng:
        toks = eng.generate(prompts, LM_STEPS)
        logits = _teacher_forced(eng, prompts, ref_tokens)
        _, caches = eng.prefill(prompts)
    # the caches prefill builds are laid out as cache_axes says
    empty = M.init_cache(cfg, LM_BATCH, S + LM_STEPS, rules=rules)
    same = all(a.shape == b.shape for a, b in zip(tree_leaves(caches), tree_leaves(empty)))
    return toks, logits, params, torch.tensor(same and len(tree_leaves(empty)) > 0)


def _lm_suite(mesh, mesh_name, ref) -> dict:
    out = {}
    cfg = lm_config(LM_ARCHS[0])
    rules, whole, axes = make_rules(mesh, mode='serve'), lm_params(cfg), M.param_axes(cfg)
    back = gather_tree(shard_tree(whole, axes, rules, mesh), whole, axes, rules, mesh)
    out['gather_tree_roundtrip'] = torch.tensor(all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(whole))))
    for arch in lm_archs(mesh_name):
        cfg = lm_config(arch)
        prompts = {k: torch.as_tensor(v) for k, v in lm_prompts(cfg).items()}
        ref_tokens = torch.as_tensor(ref[f'{arch}/tokens'])
        toks, logits, params, out[f'{arch}/cache_layout'] = _serve(cfg, mesh, prompts,
                                                                   ref_tokens)
        out[f'{arch}/tokens'], out[f'{arch}/logits'] = toks, logits
        if cfg.moe:
            c8 = lm_config(arch, NO_DROP_CF)
            _, out[f'{arch}/logits_cf8'], *_ = _serve(c8, mesh, prompts, ref_tokens)
        if arch in SP_ARCHS:
            S = prompts['tokens'].shape[1]
            step, _ = make_prefill_step(cfg, mesh, {'tokens': (LM_BATCH, S)},
                                        {'tokens': ('batch', 'seq')}, cache_cap=S + LM_STEPS,
                                        sp=True)
            logits, caches = step(params, prompts)
            out[f'{arch}/sp_logits'] = logits[:, -1]
    return {k: v.cpu().numpy() for k, v in out.items()}


def _ops_suite(mesh, mesh_name) -> dict:
    out = {}
    rules = make_rules(mesh, mode='serve')
    for name, B, S, H, KH, D, chunks in ULYSSES_CASES:
        qkv = [torch.as_tensor(a) for a in ulysses_operands(B, S, H, KH, D)]
        spec = ('data', 'model')
        local = [local_block(t, spec, mesh) for t in qkv]
        o = A.ulysses_attention(*local, mesh, causal=True, chunk=ULYSSES_CHUNK,
                                overlap_chunks=chunks)
        o = comm.all_gather(comm.all_gather(o, mesh, 'model', 1), mesh, 'data', 0)
        out[name] = o
    for name, arch, chunks in MOE_CASES:
        cfg, p, x = moe_operands(arch)
        pl = _shard(p, L.axes_from_plan(MoE.moe_plan(cfg)), rules, mesh)
        xl = local_block(torch.as_tensor(x), spec_for(rules, x.shape, ('batch', None, None)),
                         mesh)
        y, _ = MoE.moe_ep_explicit(pl, cfg, xl, Parallel(rules), overlap_chunks=chunks)
        out[name] = comm.all_gather(y, mesh, 'data', 0)
    return {k: v.cpu().numpy() for k, v in out.items()}


#: the train suite's records' trees and metrics
TRAIN_TREES = ('params', 'opt/master', 'opt/m', 'opt/v')
TRAIN_METRICS = ('loss', 'ce', 'aux', 'grad_norm')


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f'shapes {got.shape} and {want.shape}')
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (n if n > 0 else 1.0))


def train_gaps(got, want, case: str, got_case: str = None) -> dict:
    """A train case's gaps, relative L2, between two records (npz
    dicts): ``step<k>/<metric>``, ``step<k>/<tree>`` (the whole tree as
    one vector), and ``step<k>/<tree>/leaf`` (its worst leaf)."""
    got_case = got_case or case
    out = {}
    for k in range(TRAIN_STEPS):
        for m in TRAIN_METRICS:
            out[f'step{k}/{m}'] = rel_l2(got[f'{got_case}/step{k}/{m}'],
                                         want[f'{case}/step{k}/{m}'])
        for t in TRAIN_TREES:
            keys = sorted(x[len(case) + 1:] for x in want if x.startswith(f'{case}/step{k}/{t}/'))
            if not keys:
                raise AssertionError(f'{case}: no {t} at step {k}')
            a = [np.ravel(got[f'{got_case}/{x}']) for x in keys]
            b = [np.ravel(want[f'{case}/{x}']) for x in keys]
            out[f'step{k}/{t}'] = rel_l2(np.concatenate(a), np.concatenate(b))
            out[f'step{k}/{t}/leaf'] = max(rel_l2(x, y) for x, y in zip(a, b))
    return out


def run_train_group(tmp, group: str):
    """(the reference's record, this worker's) for ``TRAIN_CASES[group]``:
    ``_torch_lm_jax_reference.py train`` and the ``train`` suite as two
    subprocesses side by side, writing under ``tmp``."""
    import socket
    import subprocess
    ref, got = os.path.join(tmp, 'reference.npz'), os.path.join(tmp, 'worker.npz')
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, '_torch_lm_jax_reference.py'),
                               ref, 'train', group]),
             subprocess.Popen([sys.executable, os.path.abspath(__file__), got, str(port),
                               '--suite', 'train', '--group', group])]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if codes != [0, 0]:
        raise AssertionError(f'reference and worker exited {codes}')
    return dict(np.load(ref)), dict(np.load(got))


def _train_case(cfg, mesh, sp: bool, batches) -> tuple:
    """The sharded step (``jit_train_step``) for ``TRAIN_STEPS`` steps from
    the whole parameters (``lm_params``) cut by ``shard_params``: each
    step's metrics and the gathered parameters and optimizer state after
    it (rank 0's record), and the final blocks."""
    B, S = TRAIN_SHAPE
    sds, axes = input_specs(cfg, ShapeSpec('train', 'train', S, B), torch.float32)
    step, aux = jit_train_step(cfg, mesh, sds, axes, param_dtype=torch.float32,
                               microbatches=TRAIN_MICRO, sp=sp, **TRAIN_KW)
    rules = aux['rules']
    params = shard_params(lm_params(cfg), cfg, rules, mesh)
    opt = adamw_init(params)
    out = {}
    for k, batch in enumerate(batches):
        b = shard_batch(batch, mesh, shardings=aux['b_sh'], microbatches=TRAIN_MICRO)
        params, opt, m = step(params, opt, b)
        for key in ('loss', 'ce', 'aux', 'grad_norm'):
            out[f'step{k}/{key}'] = np.float64(m[key])
        out.update(flat_tree(params_to_reference(params, rules, mesh, cfg), f'step{k}/params'))
        out.update(flat_tree(opt_to_reference(opt, rules, mesh, cfg), f'step{k}/opt'))
    return out, params, opt, rules


def _one_rank_case(cfg, batches) -> dict:
    """The one-rank port's steps on a 1 x 1 CPU mesh, recorded as
    :func:`_train_case`'s."""
    mesh = make_host_mesh(1, 1, device='cpu')
    step = make_train_step(cfg, mesh, param_dtype=torch.float32, microbatches=TRAIN_MICRO,
                           **TRAIN_KW)
    params = lm_params(cfg)
    opt = adamw_init(params)
    out = {}
    for k, batch in enumerate(batches):
        params, opt, m = step(params, opt, shard_batch(batch, mesh))
        for key in ('loss', 'ce', 'aux', 'grad_norm'):
            out[f'step{k}/{key}'] = np.float64(m[key])
        out.update(flat_tree(params_to_reference(params), f'step{k}/params'))
        out.update(flat_tree(opt_to_reference(opt), f'step{k}/opt'))
    return out


def _local_like(cfg, rules, mesh) -> dict:
    """``{'params', 'opt'}`` of this rank's block shapes on the ``meta``
    device (fp32; the step a host int32)."""
    from repro_torch.parallel.sharding import local_shape

    def meta(p):
        return torch.empty(local_shape(p.shape, spec_for(rules, p.shape, p.axes), mesh),
                           device='meta')
    blocks = L.tree_map(meta, M.model_plan(cfg))
    return {'params': blocks, 'opt': {'step': torch.empty((), dtype=torch.int32, device='meta'),
                                      'master': blocks, 'm': blocks, 'v': blocks}}


def _ckpt_case(cfg, params, opt, rules, mesh, meshes, tmp) -> dict:
    """The state after the steps saved sharded on ``mesh`` and restored
    whole (one rank), on each mesh of ``meshes``, and from a one-rank
    checkpoint onto ``mesh``: each gathered tree bitwise equal to the
    saved state's."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.weights import opt_cuts, param_cuts
    tree = {'params': params, 'opt': opt}
    cuts = {'params': param_cuts(cfg, rules), 'opt': opt_cuts(cfg, rules)}
    want = {'params': unshard_params(params, cfg, rules, mesh),
            'opt': {'step': opt['step'], **{k: unshard_params(opt[k], cfg, rules, mesh)
                                           for k in ('master', 'm', 'v')}}}
    sharded, single = os.path.join(tmp, 'sharded'), os.path.join(tmp, 'single')
    save_checkpoint(sharded, 7, tree, cuts=cuts, mesh=mesh)
    if dist.get_rank() == 0:
        save_checkpoint(single, 7, want)           # the one-rank layout
    dist.barrier()

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    out = {'ckpt/latest': latest_step(sharded) == 7,
           'ckpt/files': len(os.listdir(os.path.join(sharded, 'step_00000007')))}
    whole_like = L.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device='meta'), want)
    out['ckpt/restore_1x1'] = same(restore_checkpoint(sharded, 7, whole_like, device='cpu'),
                                      want)
    for name, m in meshes.items():
        r = make_rules(m, mode='train')
        got = restore_checkpoint(sharded, 7, _local_like(cfg, r, m), device='cpu',
                                 cuts={'params': param_cuts(cfg, r), 'opt': opt_cuts(cfg, r)},
                                 mesh=m)
        back = {'params': unshard_params(got['params'], cfg, r, m),
                'opt': {'step': got['opt']['step'],
                        **{k: unshard_params(got['opt'][k], cfg, r, m)
                           for k in ('master', 'm', 'v')}}}
        out[f'ckpt/restore_{name}'] = same(back, want)
    got = restore_checkpoint(single, 7, _local_like(cfg, rules, mesh), device='cpu',
                             cuts=cuts, mesh=mesh)
    out['ckpt/reshard_one_rank'] = same(got, tree)
    return out


def _collective_grads(mesh) -> dict:
    """The new collectives and their backward on this mesh against what
    one rank computes from every rank's seeded operands: per check, the
    largest absolute gap (0 where they are bitwise)."""
    rank = dist.get_rank()

    def operand(r, shape, salt):
        return torch.randn(shape, generator=torch.Generator().manual_seed(100 * salt + r),
                           dtype=torch.float64)

    def members(axis):
        return mesh.group(axis)[1]
    out = {}
    for axis in ('data', 'model', ('data', 'model')):
        key = axis if isinstance(axis, str) else '+'.join(axis)
        ms, me = members(axis), comm.group_index(mesh, axis)
        p = len(ms)
        # reduce_scatter: this rank's block of the group's sum
        x = operand(rank, (4 * p, 3), 1)
        want = sum(operand(r, (4 * p, 3), 1) for r in ms).narrow(0, 4 * me, 4)
        out[f'reduce_scatter/{key}'] = float((comm.reduce_scatter(x, mesh, axis, 0)
                                              - want).abs().max())
        # the gather used apart: its cotangent the group's sum, sliced
        x = operand(rank, (3, 2), 2).requires_grad_()
        c = operand(rank, (3, 2 * p), 3)
        g, = torch.autograd.grad((c * comm.all_gather(x, mesh, axis, 1, alike=False)).sum(), x)
        want = sum(operand(r, (3, 2 * p), 3) for r in ms).narrow(1, 2 * me, 2)
        out[f'gather_apart/{key}'] = float((g - want).abs().max())
        # the gather used alike: its cotangent this rank's own slice
        g, = torch.autograd.grad((c * comm.all_gather(x, mesh, axis, 1)).sum(), x)
        out[f'gather_alike/{key}'] = float((g - c.narrow(1, 2 * me, 2)).abs().max())
        # enter: identity forward, the group's sum of the cotangents
        x = operand(0, (5,), 4).requires_grad_()
        y = comm.enter(x, mesh, axis)
        g, = torch.autograd.grad((operand(rank, (5,), 5) * y).sum(), x)
        want = sum(operand(r, (5,), 5) for r in ms)
        out[f'enter/{key}'] = max(float((g - want).abs().max()),
                                  float((y - x).detach().abs().max()))
    return out


def _train_suite(meshes, group: str, tmp: str) -> dict:
    out = {}
    for name, arch, mesh_name, sp in TRAIN_CASES[group]:
        cfg, mesh = train_config(arch), meshes[mesh_name]
        batches = train_batches(cfg)
        t0 = time.perf_counter()
        rec, params, opt, rules = _train_case(cfg, mesh, sp, batches)
        out.update({f'{name}/{k}': v for k, v in rec.items()})
        if arch == 'fftconv' and dist.get_rank() == 0:
            out.update({f'{name}/one/{k}': v for k, v in _one_rank_case(cfg, batches).items()})
        if name == '2x2/internlm2-1.8b':
            out.update(_ckpt_case(cfg, params, opt, rules, mesh,
                                  {k: v for k, v in meshes.items() if k != mesh_name}, tmp))
        out[f'{name}/seconds'] = time.perf_counter() - t0
    if group == 'a':
        out.update(_collective_grads(meshes['2x2']))
        out.update(_draws(meshes))
    return {k: np.asarray(v) for k, v in out.items()}


#: the configs whose ``draw_params`` trees are compared across meshes
DRAW_ARCHS = ('internlm2-1.8b', 'dbrx-132b', 'recurrentgemma-9b')


def _draws(meshes) -> dict:
    """``draw_params`` on each mesh under the train and the serve rules,
    gathered whole (``unshard_params``): bitwise the 1 x 1 draw."""
    out = {}
    one = make_host_mesh(1, 1, device='cpu')
    for arch in DRAW_ARCHS:
        cfg = lm_config(arch)
        want = draw_params(3, cfg, torch.float32, make_rules(one, mode='train'), one)
        for name, mesh in meshes.items():
            for mode in ('train', 'serve'):
                rules = make_rules(mesh, mode=mode)
                got = unshard_params(draw_params(3, cfg, torch.float32, rules, mesh), cfg,
                                     rules, mesh)
                out[f'draw/{arch}/{name}/{mode}'] = all(
                    torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    return out


# ---------------------------------------------------------------------------
# The four-card rows (cuda)
# ---------------------------------------------------------------------------

#: the rows by mesh: (config, parameter dtype, (prompts, tokens a prompt),
#: layers), every config at its published widths, at its published depth
#: where layers is None. dbrx-132b in fp32 at 16 of its 40 layers (four
#: cards hold its weights and its self-check's forward, whose 2 x 2111
#: tokens every rank dispatches whole at a capacity factor near 4) is the
#: witness of its bf16 row's routing: its self-check routes freely, where
#: the bf16 row's forces the engine's expert choices (``_bench_moe_check``)
BENCH_ROWS = {'1x4': [('qwen1.5-32b', torch.float32, (8, 2048), None),
                      ('dbrx-132b', torch.bfloat16, (8, 2048), None),
                      ('dbrx-132b', torch.float32, (2, 2048), 16)],
              '2x2': [('internlm2-1.8b', torch.float32, (8, 2048), None)],
              # three cards divide no head count: each rank its head range
              # (16 over 3: 5, 5, 6; 40: 13, 13, 14). 3 divides neither
              # d_model nor d_ff of either, so their projections and MLPs
              # stay whole on every card: qwen1.5-32b holds about 64 GiB of
              # bf16 weights a card, and its dry-run count on a fake 1 x 3
              # put 8 prompts at 89 GiB a card, 2 at 70
              '1x3': [('internlm2-1.8b', torch.float32, (8, 2048), None),
                      ('qwen1.5-32b', torch.bfloat16, (2, 2048), None)]}
#: the config drawn whole on every rank and also served by rank 0 alone
#: on its card, the one-card run its sharded logits are held against
ONE_CARD_ARCH, ONE_CARD_REL, ONE_CARD_MARGIN = 'internlm2-1.8b', 1e-5, 1e-3
BENCH_SEED = 0


def row_name(arch: str, dtype, layers) -> str:
    """A bench row's name, ``arch:dtype[:layers]`` (``--rows``)."""
    name = f"{arch}:{str(dtype).replace('torch.', '')}"
    return name if layers is None else f'{name}:{layers}'


def _bench_row(cs, mesh, arch, dtype, shape, layers) -> dict:
    """One four-card row: serve ``arch`` on ``mesh`` (``layers`` of it, or
    all where None; timed as
    ``chip_smoke.py``'s ``[lm]``: medians of 3, CUDA events; one decode
    step under the profiler), its self-check against its own sharded full
    forward (an MoE config at a capacity factor where no pair drops), and
    for ``ONE_CARD_ARCH`` the one-card run. Returns this rank's record."""
    B, S = shape
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    rules = make_rules(mesh, mode='serve')
    cuda = mesh.device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole = None
    if arch == ONE_CARD_ARCH:
        whole = M.init_params(torch.Generator(device=mesh.device).manual_seed(BENCH_SEED), cfg,
                              dtype)
        params = shard_params(whole, cfg, rules, mesh)
        if dist.get_rank() != 0:
            whole = None
    else:
        params = draw_params(BENCH_SEED, cfg, dtype, rules, mesh)
    draw_s = time.perf_counter() - t0
    batch = cs.lm_prompt(cfg, B, S, BENCH_SEED, device=mesh.device)
    eng = ServeEngine(cfg, mesh, params, batch=B, prompt_len=S, max_len=S + cs.LM_GEN)
    with cs.moe_routing() as rec:
        toks = eng.generate(batch, cs.LM_GEN)
    ep = mesh.shape['model']
    rec_out = {}
    if cfg.moe:      # the prefill's routing: each rank's tokens, B/dp x S/ep
        pre = [r for r in rec if r[0] == (B // mesh.shape['data']) * (S // ep)]
        counts = torch.tensor([sum(int(r[2]) for r in pre), sum(r[3] for r in pre)],
                              dtype=torch.float64, device=mesh.device)
        dist.all_reduce(counts)
        rec_out['prefill_dropped_share'] = float(counts[0] / counts[1])
        start = _max_over_ranks(cs._no_drop_factor(cfg, pre, cfg.capacity_factor), mesh)
    del rec
    runs, caches = [], None
    for _ in range(3):
        caches = None                       # one run's caches alive at a time
        *r, caches = cs._lm_generate(eng, batch, cs.LM_ROWS)
        if not torch.equal(r[0], toks):
            raise AssertionError(f'{arch}: a timed run generated other tokens')
        runs.append(r)
    med = [sorted(r[i] for r in runs)[1] for i in (1, 2, 3)]
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    # one decode step under the profiler (every rank: the step's collectives)
    prof = (cs.profile(lambda: eng.decode(caches, toks[:, -1:], S + cs.LM_GEN - 1))
            if cuda else {})
    del caches
    kept = runs[-1][4]
    del runs
    bf16 = dtype == torch.bfloat16
    if cfg.moe:
        del kept
        checks = _bench_moe_check(cs, cfg, mesh, rules, params, batch, start, bf16)
    else:
        ref = _sharded_full(cs, cfg, rules, mesh, params, batch, toks)
        checks = cs._lm_compare(cfg, ref, toks, kept, bf16=bf16)
        del ref, kept
    if arch == ONE_CARD_ARCH:
        checks.update(_one_card(cs, cfg, eng, whole, batch, toks))
    del whole
    bounds = cs._lm_bounds(cfg, M.abstract_params(cfg, dtype), B, S)
    return dict(arch=arch, mesh='x'.join(str(n) for n in mesh.shape.values()),
                dtype=str(dtype).replace('torch.', ''), layers=cfg.num_layers, batch=B,
                prompt=S, gen=cs.LM_GEN, prefill_ms=med[0], decode_ms_per_token=med[1],
                tok_per_s=B * cs.LM_GEN / med[2], generate_s=med[2], peak_gib=peak,
                draw_s=draw_s, first_row=toks[0, :8].tolist(), decode_profile=prof,
                prefill_bound_ms=float(bounds['prefill_bound_ms']) / mesh.size,
                decode_bound_ms=float(bounds['decode_bound_ms']) / mesh.size,
                decode_bound_by=bounds['decode_bound_by'], **rec_out, **checks)


def _max_over_ranks(v: float, mesh) -> float:
    t = torch.tensor([v], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _sharded_full(cs, cfg, rules, mesh, params, batch, toks):
    """The sharded full forward over ``LM_ROWS`` rows of the prompt and the
    tokens generated after it (every rank the same rows): each generated
    step's logits."""
    S = batch['tokens'].shape[1]
    with torch.inference_mode():
        full, _ = M.forward(params, cfg, cs._continue_in_text(params, cfg, batch, toks[:, :-1],
                                                              cs.LM_ROWS),
                            rules=rules)
    return full[:, S - 1:].clone()


@contextlib.contextmanager
def _routes(record=None, force=None):
    """``moe.route`` with its top-k choices recorded (``record``: each
    call's idx, in call order) or replaced (``force``: each call's idx, in
    call order; the gates renormalized from the call's own probabilities
    at the forced experts, as ``route`` normalizes its own)."""
    inner, calls = MoE.route, iter(force or ())

    def spy(router_w, x, cfg):
        gates, idx, probs = inner(router_w, x, cfg)
        if force is not None:
            idx = next(calls).to(idx.device)
            gates = torch.take_along_dim(probs, idx.long(), dim=-1)
            gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
        if record is not None:
            record.append(idx.clone())
        return gates, idx, probs
    MoE.route = spy
    try:
        yield
    finally:
        MoE.route = inner


def _gap(kept, ref) -> dict:
    """The largest per-step relative L2 (worst row) and max abs gap."""
    rel = (torch.linalg.vector_norm(kept - ref, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1)).amax()
    return dict(free_rel_l2=f'{float(rel):.3g}',
                free_max_abs=f'{float((kept - ref).abs().max()):.3g}')


def _bench_moe_check(cs, cfg, mesh, rules, params, batch, cf: float, bf16: bool) -> dict:
    """``chip_smoke._moe_self_check`` on the mesh: the rows' engine and the
    sharded forward at a capacity factor at which no rank drops a pair,
    raised after each try to the largest load any rank routed. In fp32
    the forward routes itself. In bf16 it is held to the limits with the
    engine's expert choices (routing teacher-forced, as the tokens are):
    prefill, decode and the forward sum the row-parallel partials in other
    orders, and in bf16 that flips near-tie top-k choices, each flip a
    discrete change of a token's expert mix; the fp32 row of the same
    config (``BENCH_ROWS``) is the check of its free routing. The free
    forward's gap is reported either way (``free_rel_l2``,
    ``free_max_abs``)."""
    S = batch['tokens'].shape[1]
    rows = {k: v[:cs.LM_ROWS] for k, v in batch.items()}
    L = cfg.num_layers
    for _ in range(cs.LM_NO_DROP_TRIES):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        eng = ServeEngine(c, mesh, params, batch=cs.LM_ROWS, prompt_len=S,
                          max_len=S + cs.LM_GEN)
        chosen = []
        with cs.moe_routing() as rec:
            with _routes(record=chosen):
                toks, *_, kept, caches = cs._lm_generate(eng, rows, cs.LM_ROWS)
            del caches
            ref = free = _sharded_full(cs, c, rules, mesh, params, rows, toks)
            if bf16:
                # layer l's choices over prompt and generated tokens: its
                # prefill call, then its call in each decode step
                forced = [torch.cat(chosen[l::L], dim=1) for l in range(L)]
                with _routes(force=forced):
                    ref = _sharded_full(cs, c, rules, mesh, params, rows, toks)
        if _max_over_ranks(sum(int(r[2]) for r in rec), mesh) == 0:
            out = cs._lm_compare(c, ref, toks, kept, bf16=bf16)
            return dict(out, self_capacity_factor=cf, routing='forced' if bf16 else 'free',
                        **_gap(kept, free))
        cf = _max_over_ranks(cs._no_drop_factor(cfg, rec, cf), mesh)
        del ref, kept, free
    raise AssertionError(f'{cfg.name}: pairs still drop at capacity factor {cf}')


def _one_card(cs, cfg, eng, whole, batch, toks) -> dict:
    """Rank 0 serves the whole parameters alone on its card; its logits,
    teacher-forced on the mesh's tokens, against the mesh's (relative L2
    over every row and step), and its greedy tokens against the mesh's
    where its top-2 margin exceeds ``ONE_CARD_MARGIN``."""
    mine = _teacher_forced(eng, batch, toks)
    out = {}
    if dist.get_rank() == 0:
        S = batch['tokens'].shape[1]
        with ServeEngine(cfg, make_host_mesh(1, 1, device=eng.device.type), whole,
                         batch=toks.shape[0], prompt_len=S,
                         max_len=S + cs.LM_GEN) as one:
            want = _teacher_forced(one, batch, toks)
        rel = float(torch.linalg.vector_norm(mine - want) / torch.linalg.vector_norm(want))
        top2 = torch.topk(want, 2, dim=-1).values
        wide = (top2[..., 0] - top2[..., 1]) > ONE_CARD_MARGIN
        agree = toks == torch.argmax(want, dim=-1).to(torch.int32)
        if not (rel <= ONE_CARD_REL and bool(agree[wide].all())):
            raise AssertionError(f'{cfg.name}: the mesh against one card: rel L2 {rel:.3e}, '
                                 f'tokens equal where wide: {bool(agree[wide].all())}')
        out = dict(one_card_rel_l2=rel, one_card_steps_below_margin=int((~wide).sum()))
        del want
    dist.barrier()
    return out


def _bench_suite(mesh, mesh_name, only=None) -> list:
    """Every row of ``BENCH_ROWS[mesh_name]`` (those ``only`` names, where
    given): per row, the slowest rank's times and the largest peak."""
    sys.path.insert(0, os.path.join(HERE, '..'))
    import chip_smoke as cs      # its timing, bounds and checks
    rows = []
    for arch, dtype, shape, layers in BENCH_ROWS[mesh_name]:
        if only and row_name(arch, dtype, layers) not in only:
            continue
        mine = _bench_row(cs, mesh, arch, dtype, shape, layers)
        every = [None] * mesh.size
        dist.all_gather_object(every, mine)
        row = dict(every[0])
        for k in ('prefill_ms', 'decode_ms_per_token', 'generate_s', 'peak_gib', 'draw_s'):
            row[k] = max(r[k] for r in every)
        row['tok_per_s'] = min(r['tok_per_s'] for r in every)
        rows.append(row)
        if dist.get_rank() == 0:
            print('[lm4] ' + ' '.join(f'{k}={v}' for k, v in row.items()), flush=True)
        cs._free_card()
    return rows


# ---------------------------------------------------------------------------
# The sharded trainer's four-card rows (cuda)
# ---------------------------------------------------------------------------

#: by mesh: (config, global batch (rows, positions), microbatches, steps,
#: held against rank 0 alone on its card); every config at its published
#: widths and depth ('fftconv': ``chip_smoke._fftconv_cfg``), fp32, remat
#: on, each rank drawing its blocks (``draw_params``, the same whole tree
#: on every mesh)
TRAIN_BENCH_ROWS = {'2x2': [('recurrentgemma-9b', (4, 4096), 2, 3, False),
                            ('internlm2-1.8b', (8, 2048), 2, 6, True),
                            ('fftconv', (4, 2048), 1, 6, True)],
                    '1x4': [('recurrentgemma-9b', (4, 4096), 2, 3, False)]}
TRAIN_BENCH_SEED = 0
#: the mesh's run against one card's: each step's loss, ce and grad norm,
#: and the gathered parameters after the last step, relative L2
TRAIN_ONE_CARD_REL = 1e-5
#: a rehearsal on gloo CPU ranks (``cpu``) runs each row's smoke config
#: at this many positions
TRAIN_REHEARSAL_SEQ = 32


def _bench_train_cfg(cs, arch: str, cuda: bool):
    cfg = (cs._fftconv_cfg(get_config('mamba2-1.3b')) if arch == 'fftconv'
           else get_config(arch))
    return cfg if cuda else dataclasses.replace(smoke_config(cfg), remat=True)


def _timed(fn, cuda: bool) -> float:
    """``fn()``'s time in ms: CUDA events on a card, the host clock on
    the CPU."""
    if not cuda:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


class _CardSampler:
    """The card's SM clock (MHz) and power draw (W), read by ``nvidia-smi``
    every 100 ms while the block runs: ``.sm_mhz`` the median clock,
    ``.power_w`` the median draw (None where nothing was read)."""

    def __init__(self, index: int):
        self.cmd = ['nvidia-smi', '-i', str(index), '--query-gpu=clocks.sm,power.draw',
                    '--format=csv,noheader,nounits', '-lms', '100']
        self.sm_mhz = self.power_w = None

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True)
        except OSError:         # no nvidia-smi: nothing read
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return False
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(',')])
            except ValueError:
                pass
        if rows:
            self.sm_mhz, self.power_w = (sorted(c)[len(c) // 2] for c in zip(*rows))
        return False


def _train_steps(step, params, opt, batches, cuda: bool):
    """Run the steps: (params, opt, each step's ms, each step's metrics as
    host floats; on a card each step's median SM clock and power draw
    under ``sm_mhz`` and ``power_w``)."""
    ms, mets = [], []
    for b in batches:
        box = {}

        def one(b=b):
            box['out'] = step(params, opt, b)
        with (_CardSampler(torch.cuda.current_device()) if cuda
              else contextlib.nullcontext()) as card:
            ms.append(_timed(one, cuda))
        params, opt, m = box['out']
        mets.append({k: float(v) for k, v in m.items()})
        if cuda:
            mets[-1].update(sm_mhz=card.sm_mhz, power_w=card.power_w)
    return params, opt, ms, mets


def _bench_train_row(cs, mesh, arch, shape, micro, steps, one_card) -> dict:
    """One four-card row: ``steps`` sharded steps of ``arch`` on ``mesh``,
    timed, with the card's clock and power draw during each; the FFT
    kernels' launches; on a card one more step under the profiler; for
    ``one_card`` rows, rank 0's run of the same whole parameters and
    batches alone on its card. Returns this rank's record."""
    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import fft_matmul, fft_pencil
    cuda = mesh.device.type == 'cuda'
    cfg = _bench_train_cfg(cs, arch, cuda)
    B, S = shape if cuda else (shape[0], TRAIN_REHEARSAL_SEQ)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sds, axes = input_specs(cfg, ShapeSpec('train', 'train', S, B), torch.float32)
    step, aux = jit_train_step(cfg, mesh, sds, axes, param_dtype=torch.float32,
                               microbatches=micro)
    rules = aux['rules']
    t0 = time.perf_counter()
    params = draw_params(TRAIN_BENCH_SEED, cfg, torch.float32, rules, mesh)
    opt = adamw_init(params)
    draw_s = time.perf_counter() - t0
    data = SyntheticLM(cfg.vocab_size, S, B, seed=TRAIN_BENCH_SEED, input_mode=cfg.input_mode,
                       d_model=cfg.d_model, mrope=cfg.pos_kind == 'mrope')
    host = [data.batch_at(i) for i in range(steps)]
    batches = [shard_batch(h, mesh, shardings=aux['b_sh'], microbatches=micro) for h in host]
    kernels.reset_launch_counts()
    params, opt, ms, mets = _train_steps(step, params, opt, batches, cuda)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    mma, radix8 = fft_matmul.launches_mma, fft_pencil.launches_radix8
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    for m in mets:
        if not (all(math.isfinite(v) for k, v in m.items() if k not in ('sm_mhz', 'power_w'))
                and m['grad_norm'] > 0
                and 0 < m['ce'] < 2 * math.log(cfg.vocab_size)):
            raise AssertionError(f"train {arch} on {mesh}: a step's metrics {m}")
    if arch == 'fftconv' and cuda:
        # each rank transforms its batch block: 12 of each kernel a layer a
        # step, every one on the tensor-core or radix-8 body
        per_step = {k: v * cs.FFTCONV_APPLIES * cfg.num_layers
                    for k, v in cs.FFTCONV_PER_APPLY.items()}
        if (launches != {k: v * steps for k, v in per_step.items()}
                or mma != launches['fft_matmul'] or radix8 != launches['fft_pencil']):
            raise AssertionError(f'train fftconv on {mesh}: launched {launches} (mma {mma}, '
                                 f'radix8 {radix8}), want {per_step} a step')
    tokens = B * S
    flops = cs._train_flops(cfg, tokens, S)
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    rec = dict(arch=arch, mesh='x'.join(str(n) for n in mesh.shape.values()),
               layers=cfg.num_layers, d_model=cfg.d_model, batch=B, seq=S, microbatches=micro,
               steps=steps, step_ms=med, steps_ms=ms, tok_per_s=tokens / med * 1e3,
               peak_gib=peak, draw_s=draw_s, flop=flops,
               bound_ms=flops / cs.FP32_FLOP_PER_S * 1e3 / mesh.size,
               loss=[m['loss'] for m in mets], ce=[m['ce'] for m in mets],
               grad_norm=[m['grad_norm'] for m in mets], launches=launches,
               launches_mma=mma, launches_radix8=radix8,
               sm_mhz=[m.get('sm_mhz') for m in mets], power_w=[m.get('power_w') for m in mets])
    whole = unshard_params(params, cfg, rules, mesh) if one_card else None
    if cuda:
        # where the time goes: one more step under the profiler, every rank
        rec['profile'] = cs.profile(lambda: step(params, opt, batches[0]),
                                    sums={'nccl_ms': r'^ncclDevKernel',
                                          'gemm_ms': r'gemm|cutlass|sm90'})
    del params, opt
    if one_card:
        rec.update(_train_one_card(cfg, mesh, whole, host, micro, mets, cuda))
    return rec


def _train_one_card(cfg, mesh, whole, host, micro, mets, cuda) -> dict:
    """Rank 0 trains the same whole parameters (drawn on a 1 x 1 mesh: the
    same tree) on the same batches alone on its card; its loss, ce and
    grad norm each step, and its parameters after the last, against the
    mesh's (held to ``TRAIN_ONE_CARD_REL``)."""
    out = {}
    if dist.get_rank() == 0:
        one = make_host_mesh(1, 1, device=mesh.device.type)
        params = draw_params(TRAIN_BENCH_SEED, cfg, torch.float32,
                             make_rules(one, mode='train'), one)
        opt = adamw_init(params)
        step = make_train_step(cfg, one, microbatches=micro, param_dtype=torch.float32)
        params, opt, ms, want = _train_steps(step, params, opt,
                                             [shard_batch(h, one) for h in host], cuda)
        del opt
        gaps = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mets, want))
                for k in ('loss', 'ce', 'grad_norm')}
        num = sum(float(torch.sum((a.double() - b.double()) ** 2))
                  for a, b in zip(tree_leaves(whole), tree_leaves(params)))
        den = sum(float(torch.sum(b.double() ** 2)) for b in tree_leaves(params))
        gaps['params'] = (num / den) ** 0.5
        if not all(v <= TRAIN_ONE_CARD_REL for v in gaps.values()):
            raise AssertionError(f'{cfg.name}: the mesh against one card: {gaps}')
        out = dict(one_card_rel={k: f'{v:.3g}' for k, v in gaps.items()},
                   one_card_step_ms=sorted(ms[1:])[len(ms[1:]) // 2], one_card_steps_ms=ms,
                   one_card_sm_mhz=[m.get('sm_mhz') for m in want])
        del params
    del whole
    dist.barrier()
    return out


def _trainbench_suite(mesh, mesh_name) -> list:
    """Every row of ``TRAIN_BENCH_ROWS[mesh_name]``: per row, the slowest
    rank's step time and the largest peak, rank 0's record otherwise."""
    sys.path.insert(0, os.path.join(HERE, '..'))
    if mesh.device.type == 'cuda':
        import chip_smoke as cs      # its bounds and profiler
    else:                            # a rehearsal: chip_smoke refuses a host without a card
        available, torch.cuda.is_available = torch.cuda.is_available, lambda: True
        try:
            import chip_smoke as cs
        finally:
            torch.cuda.is_available = available
    rows = []
    for arch, shape, micro, steps, one_card in TRAIN_BENCH_ROWS[mesh_name]:
        mine = _bench_train_row(cs, mesh, arch, shape, micro, steps, one_card)
        every = [None] * mesh.size
        dist.all_gather_object(every, mine)
        row = dict(every[0])
        for k in ('step_ms', 'peak_gib', 'draw_s'):
            row[k] = max(r[k] for r in every)
        row['tok_per_s'] = min(r['tok_per_s'] for r in every)
        row['launches_by_rank'] = [r['launches'] for r in every]
        for k in ('steps_ms', 'sm_mhz', 'power_w'):
            row[f'{k}_by_rank'] = [r[k] for r in every]
        rows.append(row)
        if dist.get_rank() == 0:
            print('[train4] ' + ' '.join(f'{k}={v}' for k, v in row.items()), flush=True)
        if mesh.device.type == 'cuda':
            cs._free_card()
    return rows


def run(rank: int, port: int, out: str, device: str, mesh_name: str, suite: str,
        ref=None, rows_only=None, train_group='a') -> None:
    rows, cols = (int(v) for v in mesh_name.split('x'))
    world = rows * cols
    if device == 'cuda':
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group('nccl' if device == 'cuda' else 'gloo',
                            init_method=f'tcp://localhost:{port}', rank=rank, world_size=world)
    try:
        refs = dict(np.load(ref)) if ref else {}
        if suite == 'comm':
            mine = _comm_suite(make_fft_mesh(rows, cols, device=device), mesh_name,
                               {k[len(mesh_name) + 1:]: v for k, v in refs.items()
                                if k.startswith(mesh_name + '/')})
            every = [None] * world
            dist.all_gather_object(every, mine)
            if rank == 0:
                merged = {k: (all(r[k] for r in every) if isinstance(v, bool)
                              else (sum(r[k][0] for r in every)
                                    / sum(r[k][1] for r in every)) ** 0.5)
                          for k, v in mine.items()}
                with open(out, 'w') as fh:
                    json.dump(merged, fh)
            return
        if suite == 'train':
            meshes = {m: make_host_mesh(*(int(v) for v in m.split('x')), device=device)
                      for m in TRAIN_MESHES[train_group]}
            t0 = time.perf_counter()
            mine = _train_suite(meshes, train_group, os.path.dirname(os.path.abspath(out)))
            if rank == 0:
                np.savez(out, seconds=time.perf_counter() - t0, **mine)
            return
        mesh = make_host_mesh(rows, cols, device=device)
        if suite in ('bench', 'trainbench'):
            rec = (_bench_suite(mesh, mesh_name, rows_only) if suite == 'bench'
                   else _trainbench_suite(mesh, mesh_name))
            if rank == 0:
                with open(out, 'w') as fh:
                    json.dump(rec, fh)
            return
        t0 = time.perf_counter()
        mine = (_lm_suite(mesh, mesh_name, {k[len(mesh_name) + 1:]: v for k, v in refs.items()
                                            if k.startswith(mesh_name + '/')})
                if suite == 'lm' else _ops_suite(mesh, mesh_name))
        if rank == 0:
            np.savez(out, seconds=time.perf_counter() - t0, **mine)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('out')
    ap.add_argument('port', type=int)
    ap.add_argument('device', nargs='?', default='cpu', choices=('cpu', 'cuda'))
    ap.add_argument('--mesh', default='2x2', choices=('2x2', '1x4', '1x3'))
    ap.add_argument('--suite', default='lm',
                    choices=('comm', 'lm', 'ops', 'bench', 'train', 'trainbench'))
    ap.add_argument('--group', default='a', choices=tuple(TRAIN_CASES),
                    help='train: the cases of this test file (TRAIN_CASES)')
    ap.add_argument('--ref', default=None, help='.npz of the reference results')
    ap.add_argument('--rows', nargs='+', default=None,
                    help='bench: only these rows (arch:dtype[:layers])')
    args = ap.parse_args()
    rows, cols = (int(v) for v in args.mesh.split('x'))
    mp.spawn(run, args=(args.port, args.out, args.device, args.mesh, args.suite, args.ref,
                        args.rows, args.group),
             nprocs=rows * cols, join=True)
