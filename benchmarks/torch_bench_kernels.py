"""The kernel tier: local pencil methods on each tier beside the cost
model, the per-backend model rows, and the fused superstep against the
unfused one.

Port of ``benchmarks/bench_kernels.py``. Three row sections:

* ``local``: the median us of ``repro_torch.fft.methods.apply(re, im,
  method=, kernel=tier)`` on the reference's grid (method, pencils b,
  length n) on ``--device``, beside ``wse_model.pencil_cycles_backend``.
  The ``'pallas'`` tier runs the CUDA kernels, so on ``--device cpu`` it
  is skipped with a line (it raises there by design: no interpret mode).
  On the card the grid adds the kernel table's shape, 262,144 pencils of
  512, with ``torch.fft.fft``'s time on the same pencils as ``derived``
  (``library_us``).
* ``model``: deterministic cycle predictions for every
  ``wse_model.BACKEND_COMPUTE`` backend (its ``backend`` key names the
  modelled one) x tier at n = 4096; ``us`` is null by design.
* ``superstep``: the distributed Stockham plan's fused supersteps
  against ``make_fft(plan._pplan, fused=False)``, per tier. Counted on
  the fake 4 x 4 at 32^3 (``torch_bench_util.counted``, ``meta``
  tensors): ``hlo_ops`` holds the operations the call dispatches
  (``launch.hlostats``; views included), the port's counterpart of the
  reference's HLO instruction count, beside ``hbm_bytes_proxy`` and the
  kernel launches. Timed on a 1 x 1 mesh of ``--device`` at
  ``--gate-n`` (32 on the CPU, 512 on the card): the forward (``us``)
  and the inverse on the forward's output (``us_inverse``), medians, CUDA
  events; on the card outside ``--smoke`` also each direction's device
  time by kernel under ``torch.profiler`` (``profile``), which shows
  what the fused superstep changes.

Full mode asserts the reference's gate unchanged: on the kernel tier
the fused superstep beats the unfused one on the count or on the time.
On ``--device cpu`` the kernel tier is not timed, so there the count
alone decides. ``--smoke`` is the reference's subset (one local
configuration, the superstep on the kernel tier at 16^3) plus the model
rows, and asserts nothing; on ``--device cuda`` it skips the count
(the CPU's smoke test holds it), so its superstep rows carry times alone.

Prints the CSV rows (``name,us_per_call,derived``) and writes ``--out``
(default ``results/bench_torch_kernels.json``); ``--refresh`` merges
rows by (section, backend, mesh, method, kernel, fused, n, b).

    python3 benchmarks/torch_bench_kernels.py [--smoke] [--refresh] [--device cuda|cpu]
        [--gate-n 512]

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_util as U  # noqa: E402

from repro_torch import fft  # noqa: E402
from repro_torch.core import wse_model as wm  # noqa: E402
from repro_torch.fft import methods  # noqa: E402
from repro_torch.fft import pencil as fpencil  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402
from torch_mesh_overlap import profile  # noqa: E402

TIERS = ('reference', 'pallas')
#: local grid: (method, batch, n) — b*n is the per-PE working set
LOCAL = [('stockham', 64, 1024), ('stockham', 256, 256),
         ('four_step', 64, 1024), ('block', 64, 1024)]
#: the kernel table's shape (PERF.md), on the card only
CARD_LOCAL = [('stockham', 262144, 512), ('four_step', 262144, 512),
              ('block', 262144, 512)]
#: deterministic model rows: every costed backend at the paper's n
MODEL_N = 4096
#: the transform the superstep is counted at, on the fake 4 x 4
COUNT_N = 32


def planes(shape, device, seed):
    """Planar fp32 operands: numpy from ``seed`` (the reference's) up to
    a million elements, the device's generator beyond."""
    size = int(np.prod(shape))
    if size <= 1 << 20:
        rng = np.random.default_rng(seed)
        return tuple(torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                     device=device) for _ in range(2))
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device) for _ in range(2))


def bench_local(method, b, n, tier, device):
    re, im = planes((b, n), device, 1)
    us = U.time_us(lambda: methods.apply(re, im, method=method, kernel=tier), device)
    return us, re, im


def count_rows(n: int, tiers) -> dict:
    """Each tier's fused and unfused forward counted on the fake 4 x 4."""
    mesh = U.count_mesh()
    out = {}
    for tier in tiers:
        p = fft.plan((n,) * 3, mesh, method='stockham', kernel=tier, donate=False)
        shape = (1,) + tuple(p.local_shape(p.in_layout))
        re = torch.empty(shape, device='meta')
        im = torch.empty(shape, device='meta')
        for fused in (True, False):
            fn = fpencil.make_fft(p._pplan, fused=fused)[0]
            out[f'{tier}/{fused}'] = U.count_call(lambda: fn(re, im))
    return out


def time_superstep(tier, n, device, traced: bool) -> dict:
    """Per ``fused``: the forward's and the inverse's median us on a
    1 x 1 mesh, the inverse fed the forward's output as it comes (its
    strides too); with ``traced`` each direction's device time by kernel
    (``torch_mesh_overlap.profile``)."""
    p = fft.plan((n,) * 3, make_fft_mesh(1, 1, device=device), method='stockham',
                 kernel=tier, donate=False)
    shape = (1,) + tuple(p.local_shape(p.in_layout))
    re = planes(shape, device, 2)[0]
    im = torch.zeros_like(re)
    out = {}
    for fused in (True, False):
        fwd = fpencil.make_fft(p._pplan, fused=fused)[0]
        inv = fpencil.make_fft(p._pplan, fused=fused, inverse=True)[0]
        y = fwd(re, im)
        out[fused] = r = dict(us=U.time_us(lambda: fwd(re, im), device),
                              us_inverse=U.time_us(lambda: inv(*y), device))
        if traced:
            r['profile'] = {'forward': profile(lambda: fwd(re, im)),
                            'inverse': profile(lambda: inv(*y))}
        del y
    return out


def _row_key(r):
    return (r.get('section'), r.get('backend'), r.get('mesh'),
            r.get('method'), r.get('kernel'), r.get('fused'),
            r.get('n'), r.get('b'))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--refresh', action='store_true',
                    help='merge new grid points into --out (replace same-key rows, keep '
                         'the rest) instead of overwriting it')
    ap.add_argument('--smoke', action='store_true',
                    help='CI subset: one local config per tier, the model rows and one tiny '
                         'fused A/B on the kernel tier; no gate')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--gate-n', type=int, default=None,
                    help='the timed superstep\'s transform (default 512 on the card, 32 '
                         'on the CPU; 16 with --smoke)')
    ap.add_argument('--out', default=os.path.join('results', 'bench_torch_kernels.json'))
    ap.add_argument('--count', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sup_tiers = ('pallas',) if args.smoke else TIERS
    if args.count:
        with open(args.count, 'w') as fh:
            json.dump(count_rows(COUNT_N, sup_tiers), fh)
        return
    U.need_device(args.device)
    dev = args.device
    gate_n = 16 if args.smoke else (args.gate_n or (512 if dev == 'cuda' else 32))
    local = [('stockham', 16, 128)] if args.smoke else (
        LOCAL + (CARD_LOCAL if dev == 'cuda' else []))
    card = U.card(dev)
    counted = not (args.smoke and dev == 'cuda')
    counts = U.counted(os.path.abspath(__file__), ['--smoke'] if args.smoke else []) \
        if counted else {}
    print(f"# torch_bench_kernels: kernel tier + fused superstep A/B ({card})")
    print("name,us_per_call,derived")
    results = []

    # ---- local pencil methods per tier (this device) ----
    for method, b, n in local:
        for tier in TIERS:
            if tier == 'pallas' and dev == 'cpu':
                print(f"# kernels/local/{dev}/{method}/{tier}/n{n}b{b}: skipped, the CUDA "
                      "kernels do not run on the CPU")
                continue
            us, re, im = bench_local(method, b, n, tier, dev)
            model = wm.pencil_cycles_backend(n, 'fp32', method, backend=dev, kernel=tier)
            row = dict(section='local', backend=dev, method=method, kernel=tier, n=n, b=b,
                       us=us, model_cycles=model, card=card)
            derived = f"model_cycles={model:.0f}"
            if b * n > 1 << 20:
                x = torch.complex(re, im)
                row['library_us'] = U.time_us(lambda: torch.fft.fft(x), dev)
                derived += f" library_us={row['library_us']:.3f}"
                del x
            del re, im
            U.emit(f"kernels/local/{dev}/{method}/{tier}/n{n}b{b}", us, derived)
            results.append(row)

    # ---- deterministic per-backend model rows ----
    for backend in sorted(wm.BACKEND_COMPUTE):
        for tier in TIERS:
            model = wm.pencil_cycles_backend(MODEL_N, 'fp32', 'stockham', backend=backend,
                                             kernel=tier)
            results.append(dict(section='model', backend=backend, method='stockham',
                                kernel=tier, n=MODEL_N, us=None, model_cycles=model,
                                card=card))

    # ---- fused vs unfused distributed superstep A/B ----
    ab = {}
    for tier in sup_tiers:
        timed = tier != 'pallas' or dev == 'cuda'
        if not timed:
            print(f"# kernels/superstep/1x1/{tier}/n{gate_n}: counted only, the CUDA "
                  "kernels do not run on the CPU")
        us = time_superstep(tier, gate_n, dev, traced=dev == 'cuda' and not args.smoke) \
            if timed else {True: {'us': None}, False: {'us': None}}
        for fused in (True, False):
            c = counts.get(f'{tier}/{fused}')
            r = dict(section='superstep', backend=dev, mesh='1x1', method='stockham',
                     kernel=tier, fused=fused, n=gate_n, **us[fused], card=card)
            if c is not None:
                r.update(counted_mesh='4x4', counted_n=COUNT_N, hlo_ops=c['ops'],
                         launches=c['launches'], kernels=c['kernels'],
                         hbm_bytes_proxy=c['hbm_bytes_proxy'])
            results.append(r)
            if tier == 'pallas':
                ab[fused] = r
            derived = '' if r['us'] is None else f"us_inverse={r['us_inverse']:.3f}"
            if c is not None:
                derived += (f" hlo_ops={r['hlo_ops']} launches={r['launches']} "
                            f"hbm_mb={r['hbm_bytes_proxy'] / 1e6:.2f} (counted at "
                            f"{COUNT_N}^3 on 4x4)")
            U.emit(f"kernels/superstep/1x1/{tier}/{'fused' if fused else 'unfused'}"
                   f"/n{gate_n}", float('nan') if r['us'] is None else r['us'],
                   derived.strip())

    U.write_rows(args.out, 'kernels', dev, results, _row_key, args.refresh)
    if not args.smoke:
        ops_win = ab[True]['hlo_ops'] < ab[False]['hlo_ops']
        us_win = ab[True]['us'] is not None and ab[True]['us'] < ab[False]['us']
        print(f"# fused vs unfused (pallas): dispatched ops {ab[True]['hlo_ops']} vs "
              f"{ab[False]['hlo_ops']} at {COUNT_N}^3 on 4x4"
              f"{' (win)' if ops_win else ''}, us {ab[True]['us']} vs "
              f"{ab[False]['us']} at {gate_n}^3 on 1x1{' (win)' if us_win else ''}")
        assert ops_win or us_win, (
            f"fused superstep beat unfused on NEITHER dispatched op count "
            f"({ab[True]['hlo_ops']} vs {ab[False]['hlo_ops']}) nor wall us "
            f"({ab[True]['us']} vs {ab[False]['us']}) on the pallas tier")


if __name__ == '__main__':
    main()
