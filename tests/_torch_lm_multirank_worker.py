"""Worker: the port's comm surface and sharded language-model server on
gloo CPU ranks (or NCCL cards).

Run in a subprocess so the test process never initialises a process
group:

    python tests/_torch_lm_multirank_worker.py OUT PORT [cpu|cuda]
        [--mesh 2x2|1x4] [--suite comm|lm|ops|bench] [--ref REF.npz]
        [--rows ARCH:DTYPE[:LAYERS] ...]

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
* ``bench`` (``cuda``, 1 x 4 or 2 x 2): the four-card rows of
  ``benchmarks/torch_multirank_cuda.py --suite lm`` (``BENCH_ROWS``).
"""
import argparse
import contextlib
import dataclasses
import json
import os
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
from repro_torch.configs import get_config, smoke_config  # noqa: E402
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
from repro_torch.weights import _shard, draw_params, shard_params  # noqa: E402

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


def lm_config(arch, cf=None):
    cfg = smoke_config(get_config(arch))
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


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
    for arch in LM_ARCHS:
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
              '2x2': [('internlm2-1.8b', torch.float32, (8, 2048), None)]}
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


def run(rank: int, port: int, out: str, device: str, mesh_name: str, suite: str,
        ref=None, rows_only=None) -> None:
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
        mesh = make_host_mesh(rows, cols, device=device)
        if suite == 'bench':
            rec = _bench_suite(mesh, mesh_name, rows_only)
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
    ap.add_argument('--mesh', default='2x2', choices=('2x2', '1x4'))
    ap.add_argument('--suite', default='lm', choices=('comm', 'lm', 'ops', 'bench'))
    ap.add_argument('--ref', default=None, help='.npz of the reference results')
    ap.add_argument('--rows', nargs='+', default=None,
                    help='bench: only these rows (arch:dtype[:layers])')
    args = ap.parse_args()
    rows, cols = (int(v) for v in args.mesh.split('x'))
    mp.spawn(run, args=(args.port, args.out, args.device, args.mesh, args.suite, args.ref,
                        args.rows),
             nprocs=rows * cols, join=True)
