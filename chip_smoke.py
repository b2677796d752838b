"""Drive the PyTorch/CUDA port on one GPU and check every kernel on its path.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one line and raising on any failure:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
   then the kernels are built from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel), each kernel's registers and spills printed
   (a spill in a tensor-core or radix-8 kernel fails the run), each
   radix-8 kernel with its block at the main path's shapes (pencils,
   threads, shared bytes, which the library must agree with);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (512^3 as 262,144 pencils of 512; ``fft_matmul`` and
   ``fft_block`` also at the real path's 262,144 half pencils of 256),
   plus ragged batches of every length 2..4096, the fused kernel with
   a random twiddle, and both tensor-core kernels on planes one float
   past a 16-byte boundary; with its median time, the plain version's,
   one PyTorch library call's (``torch.fft.fft``, a yardstick the port
   never calls) and its bound. ``fft_pencil`` and
   ``fft_twiddle_transpose`` also print the body their launches run
   (``variant``: 'radix8', the register-resident body, for
   2 <= n <= 4096), its block, and the radix-2 body's time on the same
   input (``radix2_ms``). ``fft_matmul`` and ``fft_block`` print theirs
   (``variant``: 'mma', the shared tensor-core four-step of
   ``csrc/four_step_mma.cuh``, for 64 <= n <= 1024, else 'fma'), its
   shared bytes and blocks an SM (``fft_matmul`` its registers too),
   and the CUDA-core body's time on the same input (``fma_ms``);
3. the main path with the default plan, ``plan((512,)*3, make_fft_mesh(1, 1))``
   (resolves to four_step / all_to_all): forward against ``torch.fft.fftn``,
   the round trip, and 3 ``fft_matmul`` launches per direction, all of
   them on the tensor-core body;
4. the same with ``method='stockham'``: 2 ``fft_twiddle_transpose`` and 1
   ``fft_pencil`` launches per direction, all of them on the radix-8 body;
5. the same with ``method='block'``: 3 ``fft_block`` launches per direction,
   all of them on the tensor-core body;
6. the real plan ``rplan((512,)*3, make_fft_mesh(1, 1))`` (resolves to
   four_step, spectrum (512, 512, 257)): forward against
   ``torch.fft.rfftn``, the round trip, 3 ``fft_matmul`` launches per
   direction; then the same with ``method='block'``, 3 ``fft_block``;
   every launch of both on the tensor-core body;
7. ``[cost]``, on the host: the cost model's report for the default plan
   of 512^3 on an abstract 512 x 512 mesh (the paper's configuration)
   and on a 2 x 2 one, and the selector's picks (strategy, overlap
   chunks, method) for 32^3 to 512^3 on 1 x 1, 2 x 2 and 1 x 4 meshes,
   complex and real, which must be the reference's; a plan whose pick
   the port cannot swap yet (ppermute, on 1 x 4) must raise;
8. the pipelined paths, 8 overlap chunks a (fft, swap) pair:
   ``overlap`` (``plan(..., overlap_chunks=8)``, four_step: 17
   ``fft_matmul`` launches per direction, 8 + 8 chunked and the last
   superstep), ``stockham_overlap`` (17 ``fft_pencil``, no
   ``fft_fused``: a chunked pair runs its fft unfused) and
   ``real_overlap`` (``rplan``: 10 ``fft_matmul``, the r2c and c2r
   pairs chunked by split-combine, the middle pair serial because its
   257-bin axis does not divide by 8). ``overlap`` and ``real_overlap``
   must give the forward of their unchunked plan bit for bit (the same
   kernel on the same pencils); ``stockham_overlap`` runs
   ``radix8_pencil_kernel`` where its unchunked plan runs
   ``radix8_fused_kernel`` and is held within 1e-6 of it;
9. a ``kernels`` JSON line, the card line and, last, the result line.

The five serial paths resolve through the cost-model selector, as a
user's default plan does, to one overlap chunk. Each path prints its
fwd+inv time, the library's (``fftn``+``ifftn`` or ``rfftn``+``irfftn``),
its peak memory above the operand and a ``[profile]`` line with device
time by kernel.

It imports neither jax nor the JAX package. Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "needs an NVIDIA GPU")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'src'))

import repro_torch.fft as fft  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build, fft_block, fft_fused, fft_matmul, fft_pencil  # noqa: E402
from repro_torch.comm import cost as costlib  # noqa: E402
from repro_torch.core.twiddle import four_step_factors  # noqa: E402
from repro_torch.launch.mesh import abstract_fft_mesh, make_fft_mesh  # noqa: E402

N = 512
SEED = 0

#: H100 SXM data-sheet peaks (dense, at the 700 W limit): HBM bytes/s and
#: fp32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

#: kernel vs plain version, max |kernel - plain| / max |plain|: both are
#: fp32 (eps 6e-8) through log2(n) = 9 butterfly stages or sums of at most
#: 32 terms per four-step factor, taken in different orders; the largest
#: elementwise gap over 2.7e8 outputs stays far below 1e-5 of the largest
#: magnitude
KERNEL_RTOL = 1e-5
#: main path vs torch.fft.fftn and round trip, relative L2: three fp32
#: pencil passes of the above error each, averaged over the array
PATH_RTOL = 1e-5
#: a chunked Stockham pair (radix8_pencil_kernel) against the serial one
#: (radix8_fused_kernel), max |a - b| / max |b|: one body, the same float
#: operations, so equal unless the compiler contracts them differently
STOCKHAM_OVERLAP_RTOL = 1e-6

#: the reference selector's picks, (strategy, overlap_chunks, method) for
#: (complex, real) plans, layout ('x', 'y', None), no measured table
PICKS = {(n, mesh): picks
         for n in (64, 128, 512)
         for mesh, picks in {
             (1, 1): (('all_to_all', 1, 'four_step'),
                      ('all_to_all', 1, 'auto' if n == 64 else 'four_step')),
             (2, 2): (('all_to_all', 8, 'four_step'),
                      ('all_to_all', 1, 'auto' if n == 64 else 'four_step')),
             (1, 4): (('ppermute', 8, 'four_step'),
                      ('ppermute', 1, 'auto' if n == 64 else 'four_step')),
         }.items()}
PICKS.update({(32, (1, 1)): (('all_to_all', 1, 'stockham'), ('all_to_all', 1, 'stockham')),
              (32, (2, 2)): (('all_to_all', 4, 'stockham'), ('all_to_all', 1, 'stockham'))})

KERNELS = {
    'fft_pencil': dict(source='src/repro_torch/csrc/fft_pencil.cu',
                       replaces='src/repro/kernels/fft_pencil.py:76'),
    'fft_twiddle_transpose': dict(source='src/repro_torch/csrc/fft_pencil.cu',
                                  replaces='src/repro/kernels/fft_fused.py:58'),
    'fft_matmul': dict(source='src/repro_torch/csrc/fft_matmul.cu',
                       replaces='src/repro/kernels/fft_matmul.py:71'),
    'fft_block': dict(source='src/repro_torch/csrc/fft_block.cu',
                      replaces='src/repro/kernels/fft_block.py:49'),
}
COUNTER = {'fft_pencil': 'fft_pencil', 'fft_twiddle_transpose': 'fft_fused',
           'fft_matmul': 'fft_matmul', 'fft_block': 'fft_block'}


#: the measured keys of each kernel's record in the ``kernels`` JSON line
JSON_KEYS = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` of one call's device time: CUDA events around
    each call, the calls queued back to back with one synchronize at the
    end, so the host's time to issue a call hides behind the device time
    of the one before (synchronizing after each call would count it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2]


def planar(shape, gen) -> tuple:
    return (torch.randn(shape, generator=gen, device='cuda'),
            torch.randn(shape, generator=gen, device='cuda'))


def max_err(got, want) -> tuple:
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, err / scale


def bound(n_elems: int, flops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate (each
    planar input read once, each output written once) and flops over
    the fp32 rate."""
    t_bytes = 16 * n_elems / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def fft_flops(n: int, pencils: int) -> float:
    """The operations a length-n FFT needs, 5 n log2 n a pencil, whatever
    form a kernel computes it in (the four-step's dense products do more)."""
    return 5.0 * n * math.log2(n) * pencils


def check(name, got, want, where) -> float:
    err, rel = max_err(got, want)
    if not rel <= KERNEL_RTOL:
        raise AssertionError(f"{name} {where}: max err {err:.3e} = {rel:.3e} of max|plain| "
                             f"> {KERNEL_RTOL}")
    return err


def phase_card() -> str:
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader', '-i', '0'],
        check=True, capture_output=True, text=True).stdout.strip()
    say('card', card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)))
    t0 = time.perf_counter()
    _build.build()
    for name in _build.SOURCES:
        for entry in ptxas_report(_build.build_log(name)):
            entry.update(radix8_shared(entry['kernel']))
            say('build', source=name, **entry)
            if ('_mma_kernel' in entry['kernel'] or 'radix8_' in entry['kernel']) and (
                    entry['spill_stores'] or entry['spill_loads']):
                raise AssertionError(f"{entry['kernel']} spills: {entry}")
    say('build', seconds=f"{time.perf_counter() - t0:.1f}")
    return card


def radix8_shared(kernel: str) -> dict:
    """A radix-8 kernel's block at the main path's shapes (262,144
    pencils; rows of 512 for the fused kernel), its shared memory being
    all dynamic: pencils, threads and shared bytes from the layout
    functions, which must give the bytes the library's
    ``radix8_smem_bytes`` gives."""
    m = re.fullmatch(r'radix8_(pencil|fused)_kernel<(\d+)>', kernel)
    if not m:
        return {}
    n, fused = 1 << int(m.group(2)), m.group(1) == 'fused'
    P, threads, smem = (fft_fused.tile_layout(n, N) if fused
                        else fft_pencil.radix8_layout(n, N * N))
    lib = fft_pencil._lib()
    if lib.radix8_smem_bytes(n, P, int(fused)) != smem:
        raise AssertionError(f"{kernel}: the layout's {smem} shared bytes differ from the "
                             f"library's {lib.radix8_smem_bytes(n, P, int(fused))}")
    return dict(pencils=P, threads=threads, smem_bytes=smem)


def kernel_name(sym: str) -> str:
    """A kernel's name from its mangled symbol, with integer template
    arguments: ``_ZN12_GLOBAL__N_116block_mma_kernelILi32ELi16EEEv...``
    is ``block_mma_kernel<32,16>``."""
    if not sym.startswith('_Z'):
        return sym
    i, name = 3 if sym.startswith('_ZN') else 2, sym
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        name, i = sym[j:j + int(sym[i:j])], j + int(sym[i:j])
    args = re.match(r'I((?:Li\d+E)+)E', sym[i:])
    if args:
        name += '<' + ','.join(re.findall(r'Li(\d+)E', args.group(1))) + '>'
    return name


def ptxas_report(log: str) -> list:
    """Registers and spill bytes of each kernel in ``nvcc -Xptxas -v``'s
    report, the kernel named by its identifier and template arguments."""
    out = []
    for ln in log.splitlines():
        if 'Compiling entry function' in ln:
            out.append(dict(kernel=kernel_name(ln.split("'")[1]), registers=None,
                            spill_stores=None, spill_loads=None))
        elif out and 'spill stores' in ln:
            st, ld = re.findall(r'(\d+) bytes spill (?:stores|loads)', ln)
            out[-1].update(spill_stores=int(st), spill_loads=int(ld))
        elif out and 'Used' in ln and 'registers' in ln:
            out[-1]['registers'] = int(re.search(r'Used (\d+) registers', ln).group(1))
    return out


def phase_kernels(gen) -> dict:
    """Each kernel against its plain version; returns name -> record."""
    rec = {}
    x = planar((N, N, N), gen)
    pencils = N * N
    xc = torch.complex(*x)

    # fft_pencil
    err = max(check('fft_pencil', fft_pencil.fft_pencil(*x, inverse=inv),
                    fft_pencil.fft_pencil_plain(*x, inverse=inv), f"{N}^3 inverse={inv}")
              for inv in (False, True))
    ms = time_ms(lambda: fft_pencil.fft_pencil(*x), 20)
    plain = time_ms(lambda: fft_pencil.fft_pencil_plain(*x), 5)
    lib = time_ms(lambda: torch.fft.fft(xc, dim=-1), 20)
    b, by = bound(x[0].numel(), fft_flops(N, pencils))
    y = tuple(torch.empty_like(p) for p in x)
    P, threads, smem = fft_pencil.radix8_layout(N, pencils)
    rec['fft_pencil'] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
        variant=fft_pencil.variant(N), pencils_per_block=P, threads=threads, smem_bytes=smem,
        radix2_ms=time_ms(lambda: fft_pencil._launch(*x, *y, N, False, _body='radix2'), 20))
    del y

    # fft_twiddle_transpose (the 3-D path has no twiddle; one checked too)
    err = max(check('fft_twiddle_transpose',
                    fft_fused.fft_twiddle_transpose(*x, inverse=inv),
                    fft_fused.fft_twiddle_transpose_plain(*x, inverse=inv),
                    f"{N}^3 inverse={inv}")
              for inv in (False, True))
    w = planar((N, N), gen)
    err = max(err, check('fft_twiddle_transpose',
                         fft_fused.fft_twiddle_transpose(*x, *w),
                         fft_fused.fft_twiddle_transpose_plain(*x, *w),
                         f"{N}^3 with twiddle"))
    ms = time_ms(lambda: fft_fused.fft_twiddle_transpose(*x), 20)
    plain = time_ms(lambda: fft_fused.fft_twiddle_transpose_plain(*x), 5)
    lib = time_ms(lambda: torch.fft.fft(xc, dim=-1).transpose(-1, -2).contiguous(), 20)
    b, by = bound(x[0].numel(), fft_flops(N, pencils))
    y = tuple(torch.empty_like(p) for p in x)
    P, threads, smem = fft_fused.tile_layout(N, N)
    rec['fft_twiddle_transpose'] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
        variant=fft_fused.variant(N), pencils_per_block=P, threads=threads, smem_bytes=smem,
        radix2_ms=time_ms(lambda: fft_fused._launch(*x, None, None, *y, False,
                                                    _body='radix2'), 20))
    del y

    del x, xc

    rec.update(kernels_four_step(gen, N))
    # the real path's r2c/c2r supersteps: 512 * 512 half pencils of 256
    for name, r in kernels_four_step(gen, N // 2).items():
        say('kernel', name=name, n=N // 2, pencils=N * N, tol=KERNEL_RTOL,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in r.items()})
    kernel_unaligned(gen)

    # ragged tiles and other lengths: every n the kernels take
    for n in (1 << k for k in range(1, 13)):
        y = planar((37, n), gen)
        z = planar((3, 29, n), gen)
        wz = planar((29, n), gen)
        yb = torch.stack(y)
        for inv in (False, True):
            check('fft_block', fft_block.fft_block(yb, inverse=inv),
                  fft_block.fft_block_plain(yb, inverse=inv), f"(2, 37, {n})")
            check('fft_pencil', fft_pencil.fft_pencil(*y, inverse=inv),
                  fft_pencil.fft_pencil_plain(*y, inverse=inv), f"(37, {n})")
            check('fft_matmul', fft_matmul.fft_matmul(*y, inverse=inv),
                  fft_matmul.fft_matmul_plain(*y, inverse=inv), f"(37, {n})")
            check('fft_twiddle_transpose',
                  fft_fused.fft_twiddle_transpose(*z, *wz, inverse=inv),
                  fft_fused.fft_twiddle_transpose_plain(*z, *wz, inverse=inv),
                  f"(3, 29, {n}) with twiddle")
    for name, r in rec.items():
        say('kernel', name=name, tol=KERNEL_RTOL,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in r.items()})
    return rec


def tensor_core_extras(module, x: tuple, n: int, pencils: int) -> dict:
    """What ``fft_matmul`` and ``fft_block`` print beside their times: the
    CUDA-core body's time on the same planes (``fma_ms``), a yardstick in
    the same run, the dense products' time at the fp32 CUDA-core peak
    (``dense_flop_ms``) and what the launch runs (``launch_info``: body,
    pencils a tile, shared bytes, blocks an SM; registers for fft_matmul)."""
    n1, n2 = four_step_factors(n)
    y = tuple(torch.empty_like(p) for p in x)
    return dict(fma_ms=time_ms(lambda: module._launch(*x, *y, n, False, _body='fma'), 20),
                dense_flop_ms=8.0 * n * (n1 + n2) * pencils / FP32_FLOP_PER_S * 1e3,
                **module.launch_info(n, pencils))


def kernels_four_step(gen, n: int) -> dict:
    """``fft_matmul`` (a planar pair: the default and real paths) and
    ``fft_block`` (stacked: the block paths) on 512 * 512 pencils of n,
    each against its plain version, forward and inverse; name -> its
    times, bound and tensor-core extras at that shape."""
    pencils = N * N
    x = planar((pencils, n), gen)
    xs = torch.stack(x)
    xc = torch.complex(*x)
    lib = time_ms(lambda: torch.fft.fft(xc, dim=-1), 20)
    b, by = bound(pencils * n, fft_flops(n, pencils))
    runs = (('fft_matmul', fft_matmul, lambda inv: fft_matmul.fft_matmul(*x, inverse=inv),
             lambda inv: fft_matmul.fft_matmul_plain(*x, inverse=inv)),
            ('fft_block', fft_block, lambda inv: fft_block.fft_block(xs, inverse=inv),
             lambda inv: fft_block.fft_block_plain(xs, inverse=inv)))
    rec = {}
    for name, module, run, plain in runs:
        err = max(check(name, run(inv), plain(inv), f"({pencils}, {n}) inverse={inv}")
                  for inv in (False, True))
        rec[name] = dict(max_abs_err=err, ms=time_ms(lambda: run(False), 20),
                         plain_ms=time_ms(lambda: plain(False), 5), library_ms=lib,
                         bound_ms=b, bound_by=by, **tensor_core_extras(module, x, n, pencils))
    return rec


def kernel_unaligned(gen) -> None:
    """Both tensor-core kernels at n = 512 on planes one float past a
    16-byte boundary: the body's tile loads take 4-byte copies (``vec``
    = 0), which no path's allocations reach."""
    n, batch = N, 37
    flat = planar((batch * n + 1,), gen)
    re_, im_ = (t[1:].view(batch, n) for t in flat)
    if not (re_.data_ptr() % 16 and im_.data_ptr() % 16):
        raise AssertionError("unaligned check: the planes are 16-byte aligned")
    xs = torch.stack([re_, im_])
    for inv in (False, True):
        err = check('fft_matmul', fft_matmul.fft_matmul(re_, im_, inverse=inv),
                    fft_matmul.fft_matmul_plain(re_, im_, inverse=inv),
                    f"({batch}, {n}) at an offset of one float, inverse={inv}")
        err = max(err, check('fft_block', fft_block.fft_block_planar(re_, im_, inverse=inv),
                             fft_block.fft_block_plain(xs, inverse=inv),
                             f"({batch}, {n}) at an offset of one float, inverse={inv}"))
    say('kernel', check='planes at an offset of one float', n=n, batch=batch,
        variant=fft_matmul.variant(n), max_abs_err=f"{err:.6g}", tol=KERNEL_RTOL)


def profile(fn) -> dict:
    """One call under ``torch.profiler``: device time per kernel, the
    device's busy time and its idle share of the call's wall time (the
    profiler's own overhead is in the wall time)."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + e.self_device_time_total
    busy_us = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=f"{wall_us / 1e3:.6g}", device_busy_ms=f"{busy_us / 1e3:.6g}",
                idle_share=f"{1 - busy_us / wall_us:.3f}",
                top=json.dumps([[k[:48], round(v / 1e3, 3)] for k, v in top]))


def phase_path(label: str, gen, expect_method: str, expect: dict, real: bool = False,
               chunks: int = 1, unchunked_rtol: float = 0.0, **plan_kw) -> dict:
    """One main path: plan, forward, inverse; returns the launch counts.
    A real path (``rplan``) takes a real operand and is held against
    ``torch.fft.rfftn``; a complex one against ``torch.fft.fftn``. A
    pipelined path (``chunks`` > 1) is also held against its unchunked
    plan's forward: bitwise, or within ``unchunked_rtol`` of its largest
    magnitude."""
    p = (fft.rplan if real else fft.plan)((N, N, N), make_fft_mesh(1, 1), **plan_kw)
    got = (p.method, p.comm, p.overlap_chunks, p.resolved_kernel)
    if got != (expect_method, 'all_to_all', chunks, 'pallas'):
        raise AssertionError(f"{label}: resolved to {got}")
    if real:
        if p.spectrum_shape != (N, N, N // 2 + 1):
            raise AssertionError(f"{label}: spectrum shape {p.spectrum_shape}")
        x = torch.randn((N, N, N), generator=gen, device='cuda')
    else:
        xr, xi = planar((N, N, N), gen)
        x = torch.complex(xr, xi)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    y = p.forward(x)
    fwd = kernels.launch_counts()
    x2 = p.inverse(y)
    torch.cuda.synchronize()
    total = kernels.launch_counts()
    on_mma = {'fft_block': fft_block.launches_mma, 'fft_matmul': fft_matmul.launches_mma}
    on_radix8 = {'fft_fused': fft_fused.launches_radix8,
                 'fft_pencil': fft_pencil.launches_radix8}
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    ref = torch.fft.rfftn(x) if real else torch.fft.fftn(x)
    if y.shape != ref.shape or y.dtype != torch.complex64:
        raise AssertionError(f"{label}: forward gave {y.dtype}{tuple(y.shape)}")
    fwd_err = float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref))
    del ref
    rt_err = float(torch.linalg.vector_norm(x2 - x) / torch.linalg.vector_norm(x))
    for k, per_dir in expect.items():
        if fwd[k] != per_dir or total[k] != 2 * per_dir:
            raise AssertionError(f"{label}: {k} launched {fwd[k]} forward / {total[k]} "
                                 f"in all, expected {per_dir} per direction")
    for k in total:
        if k not in expect and total[k]:
            raise AssertionError(f"{label}: unexpected {k} launches {total[k]}")
    for k, mma in on_mma.items():
        if mma != total[k]:
            raise AssertionError(f"{label}: {mma} of {total[k]} {k} launches on the "
                                 "tensor-core body")
    for k, r8 in on_radix8.items():
        if r8 != total[k]:
            raise AssertionError(f"{label}: {r8} of {total[k]} {k} launches on the "
                                 "radix-8 body")
    if not (fwd_err <= PATH_RTOL and rt_err <= PATH_RTOL):
        raise AssertionError(f"{label}: forward rel L2 {fwd_err:.3e}, round trip "
                             f"{rt_err:.3e}, limit {PATH_RTOL}")
    extra = {}
    if chunks > 1:
        y1 = p.with_options(overlap_chunks=1).forward(x)
        gap = float((y - y1).abs().max() / y1.abs().max())
        extra.update(vs_unchunked_bitwise=torch.equal(y, y1), vs_unchunked_rel=f"{gap:.3e}")
        if not (torch.equal(y, y1) if unchunked_rtol == 0.0 else gap <= unchunked_rtol):
            raise AssertionError(f"{label}: forward differs from the unchunked plan's by "
                                 f"{gap:.3e} of its largest magnitude, limit {unchunked_rtol}")
        del y1
    del y, x2
    ms = time_ms(lambda: p.inverse(p.forward(x)), 5)
    if real:
        lib = time_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(x), s=x.shape), 5)
        extra['spectrum'] = json.dumps(list(p.spectrum_shape))
    else:
        extra['planar_fwd_inv_ms'] = (
            f"{time_ms(lambda: p.inverse(p.forward((xr, xi))), 5):.6g}")
        lib = time_ms(lambda: torch.fft.ifftn(torch.fft.fftn(x)), 5)
    say('path', label=label, method=p.method, comm=p.comm, chunks=p.overlap_chunks,
        kernel=p.resolved_kernel,
        fwd_rel_l2=f"{fwd_err:.3e}", roundtrip_rel_l2=f"{rt_err:.3e}", tol=PATH_RTOL,
        launches=json.dumps(total), peak_gib_over_operand=f"{peak_gib:.4g}",
        launches_mma=json.dumps(on_mma), launches_radix8=json.dumps(on_radix8),
        fwd_inv_ms=f"{ms:.6g}",
        library_ms=f"{lib:.6g}", **extra)
    say('profile', label=label, **profile(lambda: p.inverse(p.forward(x))))
    return total


def phase_cost() -> None:
    """The cost model on the host: reports and the selector's picks."""
    t0 = time.perf_counter()
    for rows, cols in ((512, 512), (2, 2)):
        report = fft.plan((N, N, N), abstract_fft_mesh(rows, cols)).cost_report()
        for line in report.splitlines():
            print(f"[cost] {line}", flush=True)
    for (n, mesh), want in PICKS.items():
        am = abstract_fft_mesh(*mesh)
        for make, pick in zip((fft.plan, fft.rplan), want):
            real = make is fft.rplan
            sel = costlib.select((n,) * 3, ('x', 'y', None), am.shape, real=real,
                                 measured=None)
            if (sel.strategy, sel.overlap_chunks, sel.method) != pick:
                raise AssertionError(f"cost: {n}^3 on {mesh} real={real} picked "
                                     f"{sel.strategy}/{sel.overlap_chunks}/{sel.method}, "
                                     f"the reference picks {pick}")
            try:
                p = make((n,) * 3, am)
            except NotImplementedError:
                if pick[0] == 'all_to_all':
                    raise
                continue
            if (p.comm, p.overlap_chunks, p.method) != pick:
                raise AssertionError(f"cost: {n}^3 on {mesh} real={real} planned "
                                     f"{p.comm}/{p.overlap_chunks}/{p.method}, not {pick}")
    say('cost', picks=len(PICKS) * 2, ms=f"{(time.perf_counter() - t0) * 1e3:.3f}")


def main() -> None:
    card = phase_card()
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rec = phase_kernels(gen)
    phase_cost()
    # each path runs its own kernels and no other, so a kernel's count is
    # the one from the path that launched it
    paths = [
        phase_path('default', gen, 'four_step', {'fft_matmul': 3}),
        phase_path('stockham', gen, 'stockham', {'fft_fused': 2, 'fft_pencil': 1},
                   method='stockham'),
        phase_path('block', gen, 'block', {'fft_block': 3}, method='block'),
        phase_path('real', gen, 'four_step', {'fft_matmul': 3}, real=True),
        phase_path('real_block', gen, 'block', {'fft_block': 3}, real=True,
                   method='block'),
        # 8 chunks of each of two (fft, swap) pairs, then the last fft
        phase_path('overlap', gen, 'four_step', {'fft_matmul': 17}, chunks=8,
                   overlap_chunks=8),
        phase_path('stockham_overlap', gen, 'stockham', {'fft_pencil': 17}, chunks=8,
                   unchunked_rtol=STOCKHAM_OVERLAP_RTOL, method='stockham',
                   overlap_chunks=8),
        # r2c: 8 chunks; middle pair serial (257 bins); last fft; mirrored
        phase_path('real_overlap', gen, 'four_step', {'fft_matmul': 10}, real=True,
                   chunks=8, overlap_chunks=8),
    ]
    launches = {k: sum(t[k] for t in paths) for k in paths[0]}
    out = []
    for name, meta in KERNELS.items():
        n_launch = launches.get(COUNTER[name], 0)
        if n_launch == 0:
            raise AssertionError(f"{name} was not launched on the main path")
        out.append(dict(name=name, route='cuda', **meta, launches=n_launch,
                        **{k: rec[name][k] for k in JSON_KEYS}))
    print(json.dumps({'kernels': out}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}),
          flush=True)


if __name__ == '__main__':
    main()
