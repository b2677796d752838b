"""Time variants of the radix-8 Stockham body on one NVIDIA GPU.

Run from the root of a checkout, on the machine with the card:

    python3 benchmarks/torch_fft_pencil_variants.py

Each source variant is ``src/repro_torch/csrc/fft_pencil.cu`` with exact
text edits (an edit that no longer matches fails the run), written to
``build/variants/pencil_<variant>/`` and built there with the port's own
``nvcc`` flags:

* ``committed``: the source as it is;
* ``streaming``: the radix-8 kernels' global loads and stores of the
  data through ``__ldcs``/``__stcs`` (evict-first) in place of plain ones.

For each it prints ``ptxas``'s registers and spill bytes of each
``radix8_*_kernel`` instance, then at each length (262,144 pencils;
131,072 at n = 1024) the median of 20 launches by CUDA events, queued
back to back, the variants taken in turns (in order, then in reverse),
of ``fft_pencil``'s radix-8 body and of ``fft_twiddle_transpose``'s on
(512, b, n) rows, the latter once for each ``RUN`` (pencils a block, the
length of each run of the transposed store). Beside them, in the same
turns: both radix-2 bodies, ``torch.fft.fft`` (with a transposing copy
for the fused kernel) and a copy of the two planes (``copy_``), which
moves the same bytes as the pencil kernel and no more. Every variant's
output is checked against ``torch.fft.fft`` in float64 on the first
8,192 pencils (relative L2). The card's name and power limit come first.
It imports neither jax nor the JAX package.
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

from repro_torch.kernels import _build, fft_fused, fft_pencil  # noqa: E402

OUT = ROOT / 'build' / 'variants'
SHAPES = ((256, 262144), (512, 262144), (1024, 131072))
RUNS = (8, 16)
CHECKED = 8192

VARIANTS = {
    'committed': [],
    'streaming': [
        ('    vr[j] = live ? xr[base + L::T * j] : 0.f;\n'
         '    vi[j] = live ? xi[base + L::T * j] : 0.f;\n',
         '    vr[j] = live ? __ldcs(xr + base + L::T * j) : 0.f;\n'
         '    vi[j] = live ? __ldcs(xi + base + L::T * j) : 0.f;\n'),
        ('      yr[base + L::T * j] = vr[j] * scale;\n'
         '      yi[base + L::T * j] = vi[j] * scale;\n',
         '      __stcs(yr + base + L::T * j, vr[j] * scale);\n'
         '      __stcs(yi + base + L::T * j, vi[j] * scale);\n'),
        ('    vr[j] = live ? xr[in + T * j] : 0.f;\n'
         '    vi[j] = live ? xi[in + T * j] : 0.f;\n',
         '    vr[j] = live ? __ldcs(xr + in + T * j) : 0.f;\n'
         '    vi[j] = live ? __ldcs(xi + in + T * j) : 0.f;\n'),
        ('      yr[out + (long long)k * b + q] = sr[q * lds + k];\n'
         '      yi[out + (long long)k * b + q] = si[q * lds + k];\n',
         '      __stcs(yr + out + (long long)k * b + q, sr[q * lds + k]);\n'
         '      __stcs(yi + out + (long long)k * b + q, si[q * lds + k]);\n'),
    ],
}


def build(name: str, edits) -> tuple:
    text = (_build.CSRC / 'fft_pencil.cu').read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: edit no longer matches the source: {old!r}")
        text = text.replace(old, new)
    out = OUT / f'pencil_{name}'
    out.mkdir(parents=True, exist_ok=True)
    (out / 'fft_pencil.cu').write_text(text)
    lib = out / f'lib{name}.so'
    return subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, '-o', str(lib),
                             str(out / 'fft_pencil.cu')],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def ptxas(log: str) -> list:
    out = []
    for ln in log.splitlines():
        m = re.search(r'(radix8_\w+_kernel)ILi(\d+)EE', ln)
        if 'Compiling entry function' in ln:
            out.append([f'{m.group(1)}<{m.group(2)}>' if m else None])
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
        _build.declare(lib, 'fft_pencil_radix8_launch', 6,
                       (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                        ctypes.c_float))
        _build.declare(lib, 'fft_fused_radix8_launch', 8,
                       (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_float, ctypes.c_float))
    gen = torch.Generator(device='cuda').manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for n, batch in SHAPES:
        x = tuple(torch.randn((batch, n), generator=gen, device='cuda') for _ in range(2))
        xc = torch.complex(*x)
        ref = torch.fft.fft(torch.complex(x[0][:CHECKED].double(), x[1][:CHECKED].double()))
        y = tuple(torch.empty_like(p) for p in x)
        b = 512
        xt = tuple(p.view(-1, b, n) for p in x)
        yt = tuple(torch.empty((batch // b, n, b), device='cuda') for _ in range(2))
        tr, ti = fft_pencil.radix8_tables(n, False, x[0].device)
        calls = {}
        for name, lib in libs.items():
            def pencil(lib=lib, name=name):
                P = fft_pencil.radix8_layout(n, batch)[0]
                err = lib.fft_pencil_radix8_launch(
                    *(p.data_ptr() for p in x + y), tr.data_ptr(), ti.data_ptr(), batch, n,
                    P, 1.0, 1.0, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err} at n={n}")
            calls[f'pencil_{name}'] = (pencil, y)
            for run in RUNS:
                def fused(lib=lib, name=name, run=run):
                    P = min(run, fft_pencil.MAX_THREADS // fft_pencil.radix8_threads(n))
                    err = lib.fft_fused_radix8_launch(
                        xt[0].data_ptr(), xt[1].data_ptr(), None, None, yt[0].data_ptr(),
                        yt[1].data_ptr(), tr.data_ptr(), ti.data_ptr(), batch // b, b, 0, n,
                        P, 1.0, 1.0, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err} at n={n}")
                calls[f'fused_{name}_run{run}'] = (fused, yt)
        calls['pencil_radix2'] = (lambda: fft_pencil._launch(*x, *y, n, False, _body='radix2'),
                                  y)
        calls['fused_radix2'] = (
            lambda: fft_fused._launch(*xt, None, None, *yt, False, _body='radix2'), yt)
        calls['pencil_library'] = (lambda: torch.fft.fft(xc, dim=-1), None)
        calls['fused_library'] = (
            lambda: torch.fft.fft(xc.view(-1, b, n), dim=-1).transpose(-1, -2).contiguous(),
            None)
        calls['copy'] = (lambda: (y[0].copy_(x[0]), y[1].copy_(x[1])), None)
        for key in list(calls) + list(calls)[::-1]:
            fn, out = calls[key]
            r = rows.setdefault(key, {}).setdefault(n, {'ms': []})
            if out is not None and 'rel_l2' not in r:
                fn()
                torch.cuda.synchronize()
                got = out if out is y else tuple(
                    o.transpose(-1, -2).reshape(batch, n) for o in out)
                r['rel_l2'] = rel_l2(tuple(g[:CHECKED] for g in got), ref)
            r['ms'].append(time_ms(fn))
        del x, xc, y, xt, yt, ref
    for key, r in rows.items():
        print(json.dumps({'call': key, 'lengths': {str(n): v for n, v in r.items()}}),
              flush=True)


if __name__ == '__main__':
    main()
