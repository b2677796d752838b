"""One ownership swap per redistribution strategy, pod tree, wire dtype and
size, timed on the port's meshes beside the cost model's cycles: the
table ``comm='auto'`` reads.

Port of ``benchmarks/bench_redistribute.py``. Under ``torch.distributed.run``
every mesh of ``--meshes`` (default ``2x2,1x4``) is built over the one
world of ranks, as the reference sweeps its meshes in one process: NCCL
on the cards (``--device cuda``, the default), gloo with ``--device
cpu``. On each mesh, for each axis group (``'x'``, ``'y'``, ``('x',
'y')``; a group of one rank has no collective and is skipped with a
line) and each per-rank size, each rank holds a ``(rows, mem_dim)``
block and swaps it as the plans do (``shard_pos=0, mem_pos=1``):

* ``dtype`` is the wire format of the timed component array: ``'c64'``
  (float32), ``'c128'`` (float64), and ``'f16'`` / ``'bf16'``, a
  float32 block cast to 16 bits around the collective by
  ``strategies.swap_start_wire(..., wire_dtype=)`` (the tags of
  ``cost.WIRE_MEASURED_DTYPE``);
* ``strategy`` is each registered name and each of the mesh's pod trees
  (``cost.enumerate_trees``: ``pod_tree:x.2*y.2`` on 2 x 2,
  ``pod_tree:y.4`` and ``pod_tree:y.2*y.2`` on 1 x 4);
* sizes are the reference's (1,024 to 262,144 elements a rank), and on
  the card also 2^20, 2^22, 2^24 and 2^25: ``MeasuredTable.swap_us``
  answers within half to twice the measured range only, and one
  component of 512^3 on four ranks is 2^25 elements.

Every strategy's result is held bit for bit against ``all_to_all``'s on
the same block (every rank's verdict combined) before it is timed, so no
wrong swap is ever timed. ``us`` is the slowest rank's median of 5
swaps, each after a barrier of all ranks (CUDA events on the card); ``model_cycles`` is ``comm.get(strategy).cost(...)``, as the
reference's column. In full mode the run asserts, after writing its
rows (so a refuted claim still leaves the table), the reference's claim,
that the fp16 wire beats the native one for some (mesh, group,
strategy), at the per-rank size of the port's headline cell (one
component of 512^3 over the world's ranks; the reference's size was its
32^3 over 16 host devices). Last, with this run's rows loaded as a
``MeasuredTable``, it prints ``cost.select``'s pick for ``(512,)*3`` on
each mesh beside its pick with ``measured=None``.

Rank 0 prints the CSV rows (``name,us_per_call,derived``) and writes
``--out`` (default ``results/bench_torch_redistribute.json``, never the
repo root: a table there would move every ``comm='auto'`` pick); point
``REPRO_TORCH_MEASURED_COSTS`` at it to plan with it. ``--refresh``
merges rows by (mesh, group, strategy, dtype, local_elems). ``--smoke``
is the reference's subset (the ``('x', 'y')`` group, 2,048 elements,
c64 and f16, ``all_to_all`` and the first tree) and asserts no time.

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 -- \\
        benchmarks/torch_bench_redistribute.py [--meshes 2x2,1x4] [--smoke] \\
        [--refresh] [--device cuda|cpu]

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_util as U  # noqa: E402

from repro_torch import comm  # noqa: E402
from repro_torch.comm import cost, strategies  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402

GROUPS = ('x', 'y', ('x', 'y'))
#: per-rank (mem_dim, rows), the reference's: mem_dim divides by the group
SIZES = [(16, 64), (32, 64), (64, 256), (256, 1024)]
#: the card's extension, up to one component of 512^3 on four ranks
CARD_SIZES = [(1024, 1024), (2048, 2048), (4096, 4096), (4096, 8192)]
#: (tag, operand dtype, wire format): the native grid, then the 16-bit wires
CELLS = [('c64', torch.float32, 'native'), ('c128', torch.float64, 'native'),
         ('f16', torch.float32, 'fp16'), ('bf16', torch.float32, 'bf16')]
#: the headline transform whose per-rank component the fp16 gate reads
GATE_N = 512


def _row_key(r):
    return (r.get('mesh'), r.get('group'), r.get('strategy'),
            r.get('dtype'), r.get('local_elems'))


def gname(group) -> str:
    return group if isinstance(group, str) else '*'.join(group)


def sweep(mesh, mesh_name: str, args, sizes, lead: bool) -> list:
    """Every (group, size, strategy, dtype) cell of one mesh: rows (the
    lead rank prints them)."""
    say = print if lead else (lambda *a, **k: None)
    mesh_shape = dict(mesh.shape)
    trees = cost.enumerate_trees(tuple(mesh_shape), mesh_shape)
    names = comm.names() + trees
    cells = CELLS
    groups = GROUPS
    if args.smoke:
        names, cells, groups = ('all_to_all',) + trees[:1], [CELLS[0], CELLS[2]], [('x', 'y')]
    gen = torch.Generator(device=mesh.device).manual_seed(1000 + mesh.position)
    rows = []
    for group in groups:
        p = strategies.static_group_size(group, mesh_shape)
        if p == 1:
            say(f"# {mesh_name}/{gname(group)}: one rank, no collective to time (skipped)")
            continue
        for mem_dim, nrows in sizes:
            if mem_dim % p:
                continue
            elems = mem_dim * nrows
            for tag, dtype, wire in cells:
                x = torch.randn((nrows, mem_dim), generator=gen, device=mesh.device,
                                dtype=dtype)

                def swap(name, x=x, wire=wire):
                    return strategies.swap_start_wire(
                        comm.get(name), x, mesh, group, shard_pos=0, mem_pos=1,
                        wire_dtype=wire).wait()

                want = swap('all_to_all')
                for name in names:
                    got = swap(name)
                    if not U.all_ranks(torch.equal(got, want), args.device):
                        raise AssertionError(f"{mesh_name}/{gname(group)}/{name}/{tag}/e{elems}: "
                                             "the swap differs from all_to_all's")
                    del got
                    us = U.slowest(U.time_us_synced(lambda: swap(name), args.device))
                    if wire == 'native':
                        # byte-equivalent f32 count for the model column
                        f32_eq = elems * (2 if tag == 'c128' else 1)
                        model = comm.get(name).cost(group, mesh_shape, f32_eq / 2.0,
                                                    'fp32').cycles
                    else:
                        model = comm.get(name).cost(group, mesh_shape, elems / 2.0,
                                                    'fp16').cycles
                    if lead:
                        U.emit(f"redistribute/{mesh_name}/{gname(group)}/{name}/{tag}/e{elems}",
                               us, f"model_cycles={model:.0f}")
                    rows.append(dict(mesh=mesh_name, group=gname(group), strategy=name, p=p,
                                     local_elems=elems, dtype=tag, us=us, model_cycles=model))
                del x, want
    return rows


def fp16_gate(rows: list, gate_elems: int, say) -> None:
    """The reference's claim: the fp16 wire beats the native one for at
    least one (mesh, group, strategy) at ``gate_elems`` a rank."""
    nat = {(r['mesh'], r['group'], r['strategy']): r['us'] for r in rows
           if r['dtype'] == 'c64' and r['local_elems'] == gate_elems}
    f16 = {(r['mesh'], r['group'], r['strategy']): r['us'] for r in rows
           if r['dtype'] == 'f16' and r['local_elems'] == gate_elems}
    wins = sorted(k for k in f16 if k in nat and f16[k] < nat[k])
    for k in sorted(f16):
        say(f"#   gate e{gate_elems} {'/'.join(k)}: f16 {f16[k]:.3f} us, "
            f"c64 {nat.get(k, float('nan')):.3f} us")
    assert wins, (f"fp16 wire beat native wall time on NO (mesh, group, strategy) at "
                  f"the {GATE_N}^3 per-rank size ({gate_elems} elems)")
    say(f"# fp16 wire beats native at e{gate_elems} on {len(wins)}/{len(f16)} configs, "
        f"e.g. {wins[0]}")


def selector(rows: list, meshes, say) -> list:
    """``cost.select``'s pick for ``(512,)*3`` on each mesh with this
    run's rows as the measured table, beside the analytic pick."""
    table = cost.MeasuredTable(rows)
    out = []
    for name, (r, c) in meshes:
        shape = {'x': r, 'y': c}
        picks = {}
        for label, measured in (('measured', table), ('analytic', None)):
            sel = cost.select((GATE_N,) * 3, ('x', 'y', None), shape, measured=measured)
            picks[label] = dict(strategy=sel.strategy, overlap_chunks=sel.overlap_chunks,
                                method=sel.method)
        say(f"# selector {GATE_N}^3 on {name}: measured "
            f"{'/'.join(str(v) for v in picks['measured'].values())}, analytic "
            f"{'/'.join(str(v) for v in picks['analytic'].values())}")
        out.append(dict(mesh=name, shape=[GATE_N] * 3, **picks))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--meshes', default='2x2,1x4',
                    help='comma-separated RxC meshes, each over all the ranks')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--refresh', action='store_true',
                    help='merge new grid points into --out (replace same-key rows, keep '
                         'the rest) instead of overwriting it')
    ap.add_argument('--smoke', action='store_true',
                    help="the reference's CI subset: one group and size, c64 and the fp16 "
                         'wire, all_to_all and one pod tree; no gate')
    ap.add_argument('--out', default=os.path.join('results', 'bench_torch_redistribute.json'))
    args = ap.parse_args(argv)
    U.need_device(args.device)
    meshes = [(m, tuple(int(v) for v in m.split('x'))) for m in args.meshes.split(',')]
    world = meshes[0][1][0] * meshes[0][1][1]
    if any(r * c != world for _, (r, c) in meshes):
        raise SystemExit(f"--meshes {args.meshes}: every mesh spans the same ranks")
    if world > 1:
        U.init_world(args.device, world, f'--meshes {args.meshes}')
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    gate_elems = GATE_N ** 3 // world
    sizes = [(32, 64)] if args.smoke else SIZES + (CARD_SIZES if args.device == 'cuda' else [])
    if not args.smoke and gate_elems not in {m * r for m, r in sizes}:
        sizes = sizes + [(GATE_N, gate_elems // GATE_N)]
    say(f"# torch_bench_redistribute: one ownership swap per strategy on {args.meshes} "
        f"({U.card(args.device)})")
    say("name,us_per_call,derived")
    rows = []
    for name, (r, c) in meshes:
        rows += sweep(make_fft_mesh(r, c, device=args.device), name, args, sizes, lead)
    backend = args.device
    card = U.card(args.device)
    for row in rows:
        row.update(card=card, backend=backend)
    picks = selector(rows, meshes, say)
    if lead:
        U.write_rows(args.out, 'redistribute', args.device, rows, _row_key, args.refresh,
                     backend=backend, selector=picks)
    if not args.smoke:
        fp16_gate(rows, gate_elems, say)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
