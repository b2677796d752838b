"""Multi-pod dry run: rank 0's step of every (arch x shape x mesh) cell at
full width and depth, counted, on no card.

Port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell's step for 256 or 512 fake XLA devices and reads the compiled
program. The port's steps are eager, so the dry run *runs* rank 0's own
step once, on ``meta`` tensors (shapes and dtypes, no memory, no
values), in a process that holds a ``fake`` process group of 256 or 512
ranks as rank 0 (collectives return at once and move nothing), and
counts what the step dispatches (:mod:`repro_torch.launch.hlostats`):

* the mesh is :func:`repro_torch.launch.mesh.make_production_mesh` on
  that group: 16 x 16 ('data', 'model') or 2 x 16 x 16 ('pod', 'data',
  'model');
* rank 0's blocks: the parameters (``model.abstract_params``, bf16 as
  the reference's) and, for train, the AdamW state
  (``optim.abstract_opt``; its ``step`` the host counter it always
  is), cut by the specs the step factory returns (``local_shape``); a
  decode step's caches (``cache_shardings``); the batch
  (``configs.input_specs``);
* the step: ``jit_train_step``'s (``microbatches``: 4 for train, 1
  otherwise by default), ``make_prefill_step``'s or
  ``make_decode_step``'s at ``cache_len = seq_len - 1``.

Each record has the reference's file name and fields: ``status``
(``ok``, ``skipped`` with the reference's ``skip_reason``, ``failed``
with ``error``), ``memory`` (a rank's bytes: its arguments, its outputs,
the peak of the step's live intermediates as ``temp_size_in_bytes``, and
``fits_80gib``; the serving steps take the whole batch on every rank,
so its bytes stand beside the block's), ``heads`` (the query and kv
heads of rank 0 and of the 'model' rank with the most: where the group
does not divide the heads, that rank's step is counted too, its memory
and roofline under ``heads.most``, and ``fits_80gib`` holds for both),
``hlo`` (the step statistics),
``model_flops`` (6ND / 2ND / 2NB with the active parameters), ``params``,
``active_params`` and ``roofline`` with NVIDIA H100 constants.

The constants are the NVIDIA H100 SXM5 80 GB datasheet's at 700 W
(dense, no sparsity), not measurements: fp32 67 TFLOP/s (the port runs
fp32 products with TF32 off), bf16 989 TFLOP/s, HBM 3.35 TB/s; links
of eight cards a node (consecutive global ranks), NVLink 450 GB/s each
way a card within a node, InfiniBand NDR 50 GB/s each way a card across
nodes. A collective's time is its wire bytes over the slowest link its
group crosses: every group of the production meshes crosses nodes
('model' spans two nodes of eight, 'data' and 'pod' stride over them).

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        [--sp] [--microbatches 0] [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
import traceback
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs, skip_reason
from repro_torch.launch import hlostats
from repro_torch.launch.hlostats import tensors_in
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import tree_map
from repro_torch.parallel.sharding import local_shape, make_rules, named_sharding, tree_specs
from repro_torch.train import optim

#: NVIDIA H100 SXM5 80 GB datasheet, 700 W, dense (not measurements)
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12, 'float16': 989e12}
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way a card, within a node
IB_BW = 50e9                 # bytes/s each way a card, InfiniBand NDR 400 Gb/s
GPUS_PER_NODE = 8
HBM_BYTES = 80 * 2 ** 30     # the flag's budget, 80 GiB a card
PARAM_DTYPE = torch.bfloat16


def init_fake_world(world_size: int) -> None:
    """A ``fake`` process group of ``world_size`` ranks in this process,
    as rank 0 (collectives return at once and move nothing). A process
    that already holds a group must hold at least that many ranks."""
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(f'the dry run needs {world_size} ranks; this process holds a '
                               f'group of {dist.get_world_size()}')
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    # 'meta' too: a point-to-point batch asks its group for the tensors' device's backend
    dist.init_process_group('cpu:fake,cuda:fake,meta:fake', store=FakeStore(), rank=0,
                            world_size=world_size)


@functools.lru_cache(maxsize=None)
def production_mesh(multi_pod: bool):
    """The production mesh on the fake group (made once: it makes groups)."""
    init_fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device='cpu')


def _blocks(tree, specs, mesh):
    """This rank's block of each whole ``meta`` leaf, on ``meta``."""
    return tree_map(lambda t, sh: torch.empty(local_shape(t.shape, sh[1], mesh), dtype=t.dtype,
                                              device='meta'), tree, specs)


def rank_blocks(cfg, mesh, mode: str):
    """This rank's blocks on ``meta`` under the ``mode`` rules (the step
    factories' specs): ``(params, AdamW state)``, the state's ``step``
    the host counter. ``mesh``: anything with the mesh's ``.shape``."""
    rules = make_rules(mesh, mode=mode)
    p_abs, p_axes = M.abstract_params(cfg, PARAM_DTYPE), M.param_axes(cfg)
    o_abs = optim.abstract_opt(p_abs)
    params = _blocks(p_abs, tree_specs(rules, p_abs, p_axes), mesh)
    opt = _blocks(o_abs, tree_specs(rules, o_abs, optim.opt_axes(p_axes)), mesh)
    opt['step'] = torch.zeros((), dtype=torch.int32)
    return params, opt


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_in(tree))


def build_cell(cfg, shape, mesh, *, sp: bool = False, microbatches: int = 1):
    """Rank 0's step and its arguments for one cell: ``(call, args,
    batch)``, ``call()`` runs the step once, ``args`` the step's arguments
    by role (this rank's blocks), ``batch`` the batch's (block, whole)
    bytes."""
    batch_sds, batch_axes = input_specs(cfg, shape)
    whole = _nbytes(batch_sds)
    if shape.kind == 'train':
        from repro_torch.train.trainstep import jit_train_step
        step, aux = jit_train_step(cfg, mesh, batch_sds, batch_axes, sp=sp,
                                   microbatches=microbatches, param_dtype=PARAM_DTYPE)
        params, opt = rank_blocks(cfg, mesh, 'train')
        batch = _blocks(batch_sds, aux['b_sh'], mesh)
        return (lambda: step(params, opt, batch)), dict(params=params, opt=opt,
                                                        batch=batch), (_nbytes(batch), whole)
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    if shape.kind == 'prefill':
        step, aux = make_prefill_step(cfg, mesh, batch_sds, batch_axes, sp=sp)
        params = rank_blocks(cfg, mesh, 'serve')[0]
        block = _nbytes(_blocks(batch_sds, aux['b_sh'], mesh))
        return (lambda: step(params, batch_sds)), dict(params=params), (block, whole)
    B = shape.global_batch
    step, aux = make_decode_step(cfg, mesh, batch=B, cache_cap=shape.seq_len)
    params = rank_blocks(cfg, mesh, 'serve')[0]
    caches = tree_map(lambda t, ax: torch.empty(M.cache_block_shape(cfg, t.shape, ax, aux['rules']),
                                                dtype=t.dtype, device='meta'),
                      aux['caches'], M.cache_axes(cfg, B, shape.seq_len))
    tokens = batch_sds['tokens']
    t_sh = {'tokens': named_sharding(aux['rules'], tokens.shape, batch_axes['tokens'])}
    block = _nbytes(_blocks({'tokens': tokens}, t_sh, mesh))
    return ((lambda: step(params, caches, tokens, shape.seq_len - 1)),
            dict(params=params, caches=caches), (block, _nbytes(tokens)))


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D prefill, 2*N*B decode
    (N = active params for MoE)."""
    n = M.active_param_count(cfg)
    if shape.kind == 'train':
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == 'prefill':
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def link_of(ranks) -> str:
    """'nvlink' for a group inside one node of ``GPUS_PER_NODE``
    consecutive global ranks, else 'infiniband'."""
    return 'nvlink' if len({r // GPUS_PER_NODE for r in ranks}) == 1 else 'infiniband'


def wire_by_link(st: hlostats.StepStats) -> Dict[str, Dict[str, float]]:
    """Wire bytes by collective kind and by the slowest link its group crosses."""
    out: Dict[str, Dict[str, float]] = {}
    for (kind, ranks), b in st.wire_by_group.items():
        link = out.setdefault(kind, {})
        link[link_of(ranks)] = link.get(link_of(ranks), 0.0) + b
    return out


def roofline_terms(stats: Dict) -> Dict:
    """Three per-step time lower bounds of one rank (seconds), with the
    datasheet constants above: the products at the peak of their dtype
    and the hand-written kernels' flops (``kernel_flops``) at fp32's,
    ``hbm_bytes_proxy`` (the kernels' bytes in it) over HBM, and each
    collective's wire bytes over its link
    (``stats['collective_wire_by_link']``)."""
    compute_s = sum(f / PEAK_FLOPS[dt] for dt, f in stats['dot_flops_by_dtype'].items())
    compute_s += stats.get('kernel_flops', 0.0) / PEAK_FLOPS['float32']
    mem_bytes = stats['hbm_bytes_proxy']
    bw = {'nvlink': NVLINK_BW, 'infiniband': IB_BW}
    by_kind = {k: sum(b / bw[link] for link, b in links.items())
               for k, links in stats['collective_wire_by_link'].items()}
    terms = {'compute_s': compute_s, 'memory_s': mem_bytes / HBM_BW,
             'collective_s': float(sum(by_kind.values()))}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = {k: (v / bound if bound else 0.0) for k, v in terms.items()}
    return {**terms, 'collective_s_by_kind': by_kind, 'dominant': dom, 'bound_s': bound,
            'fraction_of_bound': frac, 'mem_bytes_est': mem_bytes}


def _memory(args: Dict, out, st: hlostats.StepStats, batch: Tuple[int, int]) -> Dict:
    held = {id(t.untyped_storage()) for t in tensors_in(args)}
    outs = tensors_in(out)
    by_role = {k: _nbytes(v) for k, v in args.items()}
    by_role.setdefault('batch', batch[0])      # a serving step cuts its block itself
    mem = {
        'argument_size_in_bytes': sum(by_role.values()),
        'output_size_in_bytes': _nbytes(outs),
        'temp_size_in_bytes': st.peak_live_bytes,
        # outputs the step wrote in place into its arguments
        'alias_size_in_bytes': sum(t.numel() * t.element_size() for t in outs
                                   if id(t.untyped_storage()) in held),
        'by_role': by_role,
        'batch_block_bytes': batch[0],
        'batch_whole_bytes': batch[1],
    }
    mem['fits_80gib'] = mem['argument_size_in_bytes'] + mem['temp_size_in_bytes'] <= HBM_BYTES
    return mem


def rank_heads(cfg, mesh) -> Dict:
    """The query and kv heads the rank of ``mesh`` (a mesh as a rank sees
    it) attends with, and its index on 'model'."""
    from repro_torch.models.attention import head_range, kv_head_range
    tp, r = mesh.shape['model'], mesh.coordinate['model']
    H, KH = cfg.num_heads, cfg.num_kv_heads
    lo, hi = head_range(H, tp, r)
    if H % tp == 0 and KH % tp:            # every kv head, attending with its own
        klo, khi = 0, KH
    else:
        klo, khi = kv_head_range(H, KH, tp, r)
    return {'model_index': r, 'q_heads': hi - lo, 'kv_heads': khi - klo}


def most_heads_index(cfg, tp: int) -> int:
    """The first 'model' index whose head range is the largest."""
    from repro_torch.models.attention import head_range
    counts = [hi - lo for lo, hi in (head_range(cfg.num_heads, tp, r) for r in range(tp))]
    return counts.index(max(counts))


def _count(cfg, shape, mesh, sp: bool, microbatches: int):
    """Build one rank's step on ``mesh`` and count one run: (build s, step
    s, its memory record, the statistics, the counter)."""
    t0 = time.time()
    call, args, batch = build_cell(cfg, shape, mesh, sp=sp, microbatches=microbatches)
    t1 = time.time()
    with hlostats.count() as st:
        out = call()
    t2 = time.time()
    stats = st.analyze()
    stats['num_partitions'] = mesh.size
    stats['collective_wire_by_link'] = wire_by_link(st)
    return t1 - t0, t2 - t1, _memory(args, out, st, batch), stats


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, sp: bool = False,
             microbatches: int = 0, out_dir: str = 'results/dryrun_torch') -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if microbatches <= 0:
        microbatches = 4 if shape.kind == 'train' else 1
    mesh_tag = 'multipod_2x16x16' if multi_pod else 'pod_16x16'
    rec = {'arch': arch, 'shape': shape_name, 'mesh': mesh_tag, 'kind': shape.kind, 'sp': sp,
           'microbatches': microbatches}
    skip = skip_reason(cfg, shape)
    if skip:
        rec['status'] = 'skipped'
        rec['skip_reason'] = skip
        return _emit(rec, out_dir)
    try:
        mesh = production_mesh(multi_pod)
        build_s, step_s, memory, stats = _count(cfg, shape, mesh, sp, microbatches)
        n_chips = mesh.size                       # the fake group may hold more
        if set(cfg.block_pattern) & {'attn', 'local_attn', 'mla'}:
            rec['heads'] = {'rank0': rank_heads(cfg, mesh)}
            most = most_heads_index(cfg, mesh.shape['model'])
            if most != rec['heads']['rank0']['model_index']:
                # the rank with the most heads holds the most cache and
                # attention: count its step too, and judge the fit on both
                other = mesh.seen_from(most)      # 'model' is the last axis
                *_, mem2, stats2 = _count(cfg, shape, other, sp, microbatches)
                rec['heads']['most'] = {**rank_heads(cfg, other), 'memory': mem2,
                                        'roofline': roofline_terms(stats2)}
                memory['fits_80gib_rank0'] = memory['fits_80gib']
                memory['fits_80gib'] = memory['fits_80gib'] and mem2['fits_80gib']
            else:
                rec['heads']['most'] = rec['heads']['rank0']
        rec.update(
            status='ok', n_chips=n_chips, build_s=round(build_s, 2), step_s=round(step_s, 2),
            memory=memory, hlo=stats,
            model_flops=model_flops(cfg, shape), params=M.param_count(cfg),
            active_params=M.active_param_count(cfg),
            compute_dtype=str(PARAM_DTYPE).replace('torch.', ''),
            constants='NVIDIA H100 SXM5 80 GB datasheet, 700 W: not measured')
        roof = roofline_terms(stats)
        rec['roofline'] = roof
        total = stats['dot_flops'] * n_chips
        rec['useful_flop_ratio'] = rec['model_flops'] / total if total else 0.0
        ideal_s = rec['model_flops'] / (n_chips * PEAK_FLOPS[rec['compute_dtype']])
        rec['roofline_fraction'] = ideal_s / roof['bound_s'] if roof['bound_s'] else 0.0
    except Exception as e:      # a failed cell is a finding: record it, run the next
        rec['status'] = 'failed'
        rec['error'] = f'{type(e).__name__}: {e}'
        rec['traceback'] = traceback.format_exc()[-4000:]
    return _emit(rec, out_dir)


def _emit(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{rec['mesh']}__{rec['arch']}__{rec['shape']}"
                      + ('__sp' if rec.get('sp') else '') + '.json')
    slim = {k: v for k, v in rec.items() if k != 'traceback'}
    with open(fn, 'w') as f:
        json.dump(slim, f, indent=1)
    status = rec['status']
    extra = ''
    if status == 'ok':
        r, m = rec['roofline'], rec['memory']
        gib = (m['argument_size_in_bytes'] + m['temp_size_in_bytes']) / 2 ** 30
        extra = (f" dom={r['dominant']} bound={r['bound_s'] * 1e3:.2f}ms (datasheet)"
                 f" frac={rec['roofline_fraction']:.3f} rank_gib={gib:.2f}"
                 f" fits_80gib={m['fits_80gib']} step={rec['step_s']:.1f}s")
    elif status == 'failed':
        extra = ' ' + rec['error'][:120]
    elif status == 'skipped':
        extra = ' ' + rec['skip_reason']
    print(f"[dryrun] {rec['mesh']} {rec['arch']} {rec['shape']}: {status}{extra}", flush=True)
    if rec.get('traceback'):
        print(rec['traceback'], file=sys.stderr)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='all')
    ap.add_argument('--shape', default='all')
    ap.add_argument('--mesh', default='both', choices=['single', 'multi', 'both'])
    ap.add_argument('--sp', action='store_true', help='Ulysses sequence parallelism for prefill')
    ap.add_argument('--microbatches', type=int, default=0,
                    help='0 = auto (4 for train, 1 otherwise)')
    ap.add_argument('--out', default='results/dryrun_torch')
    args = ap.parse_args(argv)
    archs = list(ARCHS) if args.arch == 'all' else args.arch.split(',')
    shapes = list(SHAPES) if args.shape == 'all' else args.shape.split(',')
    meshes = {'single': [False], 'multi': [True], 'both': [False, True]}[args.mesh]
    init_fake_world(512 if True in meshes else 256)
    failed = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mp, sp=args.sp, microbatches=args.microbatches,
                               out_dir=args.out)
                failed += rec['status'] == 'failed'
    sys.exit(1 if failed else 0)


if __name__ == '__main__':
    main()
