"""Time variants of the long body (pencils of 8192 to 65536) on one NVIDIA GPU.

Run from the root of a checkout, on the machine with the card:

    python3 benchmarks/torch_fft_long_variants.py

Each variant is ``src/repro_torch/csrc/fft_long.cu`` with exact text
edits (an edit that no longer matches fails the run), written with the
header it includes (``csrc/radix8.cuh``) to ``build/variants/long_<variant>/``
and built there with the port's own ``nvcc`` flags:

* ``committed``: the source as it is (column-major tiles, element
  (e, jl) at jl NA + (e ^ (jl & 31)), and loads straight to registers,
  but at 8192 a row-major tile, (e, jl) at e J + (jl ^ (e & 31)), and
  ``cp.async`` loads into it, every round's issued at the start; 512
  threads at NA = 128, 1024 at NA = 256);
* at 8192, the other three of {row-major, column-major} x {``cp.async``,
  register loads}: ``register_loads_8192``, ``column_major_cp_async_8192``
  and ``column_major_8192`` (the column-major tile and register loads
  that the other lengths run);
* ``cp_async``: ``cp.async`` loads at every length;
* ``row_major_tile``: the row-major tile at every length, so a warp's
  read of another block's tile (32 rows of one column) is 32 words 4 J
  bytes apart, not one run;
* ``small_blocks``: 64 KiB tiles everywhere: a cluster of 2 at 16384
  (two blocks an SM), 4 at 32768, 8 at 65536;
* ``threads_1024``: 1024 threads at 16384 (64 registers a thread, where
  512 may take 128);
* ``prefetch_next``: ``prefetch.global.L2`` of the columns of the pencil
  one SM's worth of clusters on (the next wave's) as the row phase
  starts;
* probes, their output wrong: ``rows_local`` (wrong where a pencil spans
  a cluster): the row phase reads its own tile in place of the others',
  so the time it saves is what distributed shared memory costs;
  ``no_column_fft`` and ``no_row_fft``: a phase without its sub-FFTs,
  their arithmetic and shared exchanges (the loads, the twiddle, the
  stores stay), so the time each saves is what that phase's passes cost.

For each it prints ``ptxas``'s registers and spill bytes of each
``long_kernel`` instance, then at each length (2^24 / n pencils) the
median of 20 launches of ``fft_long_launch`` (forward) by CUDA events,
queued back to back, the variants taken in turns (in order, then in
reverse), beside ``torch.fft.fft`` and a copy of the two planes
(``copy_``), which moves the bytes the kernel must and no more. Every
variant but the probe is checked against ``torch.fft.fft`` in float64 on
the first 64 pencils (relative L2). The card's name and power limit come
first. It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'src'))

from repro_torch.kernels import _build, _long  # noqa: E402

OUT = ROOT / 'build' / 'variants'
ELEMS = 1 << 24
LENGTHS = (8192, 16384, 32768, 65536)
CHECKED = 64
PROBES = ('rows_local', 'no_column_fft', 'no_row_fft')

#: the flags of ``Long<LOG2N>``: the tile's layout and the column loads
FLAGS = 'ROW_MAJOR = LOG2N == 13, ASYNC = LOG2N == 13;'
#: prefetch.global.L2 of a pencil's column loads
PREFETCH = """__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

"""
ROWS = '  // rows k1 = rank KA + ...: NB-point FFT over j, store X[k1 + NA k2]\n'
PREFETCH_NEXT = """  {  // the pencil a block of the next wave takes: one SM's worth of clusters on
    unsigned sms;
    asm("mov.u32 %0, %%nsmid;" : "=r"(sms));
    const long long pn = p + sms * S::MIN_BLOCKS / S::C;
    if (pn < gridDim.x / S::C) {
      const int grp = warp / TA, t = warp % TA;
      for (int round = 0; round < S::ROUNDS; ++round) {
        const int j = rank * J + (round * S::GA + grp) * kLanes + lane;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          prefetch_l2(xr + pn * N + (long long)(t + TA * q) * NB + j);
          prefetch_l2(xi + pn * N + (long long)(t + TA * q) * NB + j);
        }
      }
    }
  }
""" + ROWS

VARIANTS = {
    'committed': [],
    'register_loads_8192': [(FLAGS, 'ROW_MAJOR = LOG2N == 13, ASYNC = false;')],
    'column_major_cp_async_8192': [(FLAGS, 'ROW_MAJOR = false, ASYNC = LOG2N == 13;')],
    'column_major_8192': [(FLAGS, 'ROW_MAJOR = false, ASYNC = false;')],
    'cp_async': [(FLAGS, 'ROW_MAJOR = LOG2N == 13, ASYNC = true;')],
    'row_major_tile': [(FLAGS, 'ROW_MAJOR = true, ASYNC = LOG2N == 13;')],
    'small_blocks': [
        ('C = LOG2N <= 14 ? 1 : 1 << (LOG2N - 14);', 'C = LOG2N <= 13 ? 1 : 1 << (LOG2N - 13);'),
        ('MIN_BLOCKS = LOG2N == 13 ? 2 : 1;', 'MIN_BLOCKS = LOG2N <= 14 ? 2 : 1;'),
    ],
    'threads_1024': [
        ('THREADS = LOG2N <= 14 ? 512 : 1024;', 'THREADS = LOG2N == 13 ? 512 : 1024;'),
    ],
    'prefetch_next': [
        ('// Synchronise the `threads` threads', PREFETCH + '// Synchronise the `threads` threads'),
        (ROWS, PREFETCH_NEXT),
    ],
    'rows_local': [
        ('cluster.map_shared_rank(smem, (TB * q) / J)', 'smem'),
    ],
    'no_column_fft': [
        ('      sub_fft<S::LA, 0>(vr, vi, t, smem, TILE, at, 1 + grp, TA * 32, ar, ai, s);\n', ''),
    ],
    'no_row_fft': [
        ('        sub_fft<S::LB, 0>(vr, vi, t, smem, TILE, at, 1 + grp, TB * 32, br, bi, s);\n', ''),
        ('        sub_fft<S::LB, 0>(vr, vi, t, stage, kLanes * NB, at, 1 + grp, TB * 32, br, bi, s);\n',
         ''),
    ],
}


def build(name: str, edits) -> tuple:
    text = (_build.CSRC / 'fft_long.cu').read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: edit no longer matches the source: {old!r}")
        text = text.replace(old, new)
    out = OUT / f'long_{name}'
    out.mkdir(parents=True, exist_ok=True)
    (out / 'fft_long.cu').write_text(text)
    (out / 'radix8.cuh').write_text((_build.CSRC / 'radix8.cuh').read_text())
    lib = out / f'lib{name}.so'
    return subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, '-o', str(lib),
                             str(out / 'fft_long.cu')],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def ptxas(log: str) -> list:
    out = []
    for ln in log.splitlines():
        m = re.search(r'(long_kernel)ILi(\d+)ELi(\d+)EE', ln)
        if 'Compiling entry function' in ln:
            out.append([f'{m.group(1)}<{m.group(2)},{m.group(3)}>' if m else None])
        elif out and 'spill stores' in ln:
            out[-1].append(int(re.search(r'(\d+) bytes spill stores', ln).group(1)))
        elif out and 'Used' in ln:
            out[-1].append(int(re.search(r'Used (\d+) registers', ln).group(1)))
    return [{'kernel': k, 'spill_stores': s, 'registers': r} for k, s, r in out if k]


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` launches' device time, queued back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in events)[reps // 2]


def rel_l2(got, ref) -> float:
    g = torch.complex(got[0].double(), got[1].double())
    return float(torch.linalg.vector_norm(g - ref) / torch.linalg.vector_norm(ref))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader',
                          '-i', '0'], check=True, capture_output=True, text=True).stdout.strip())
    running = {name: build(name, edits) for name, edits in VARIANTS.items()}
    libs = {}
    for name, (proc, path) in running.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        print(json.dumps({'variant': name, 'ptxas': ptxas(log)}), flush=True)
        lib = libs[name] = ctypes.CDLL(str(path))
        _build.declare(lib, 'fft_long_launch', 10,
                       (ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float))
    gen = torch.Generator(device='cuda').manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for n in LENGTHS:
        batch = ELEMS // n
        x = tuple(torch.randn((batch, n), generator=gen, device='cuda') for _ in range(2))
        xc = torch.complex(*x)
        ref = torch.fft.fft(torch.complex(x[0][:CHECKED].double(), x[1][:CHECKED].double()))
        y = tuple(torch.empty_like(p) for p in x)
        tables = _long.tables(n, False, x[0].device)
        calls = {}
        for name, lib in libs.items():
            def run(lib=lib, name=name):
                err = lib.fft_long_launch(*(p.data_ptr() for p in x + y),
                                          *(a.data_ptr() for a in tables), batch, n, 1.0, 1.0,
                                          stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err} at n={n}")
            calls[name] = (run, y if name not in PROBES else None)
        calls['library'] = (lambda: torch.fft.fft(xc, dim=-1), None)
        calls['copy'] = (lambda: (y[0].copy_(x[0]), y[1].copy_(x[1])), None)
        for key in list(calls) + list(calls)[::-1]:
            fn, out = calls[key]
            r = rows.setdefault(key, {}).setdefault(n, {'ms': []})
            if out is not None and 'rel_l2' not in r:
                fn()
                torch.cuda.synchronize()
                r['rel_l2'] = rel_l2(tuple(g[:CHECKED] for g in out), ref)
            r['ms'].append(time_ms(fn))
        del x, xc, y, ref
    for key, r in rows.items():
        print(json.dumps({'call': key, 'lengths': {str(n): v for n, v in r.items()}}),
              flush=True)


if __name__ == '__main__':
    main()
