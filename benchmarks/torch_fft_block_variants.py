"""Time variants of the tensor-core ``fft_block`` body on one NVIDIA GPU.

Run from the root of a checkout, on the machine with the card:

    python3 benchmarks/torch_fft_block_variants.py

Each variant is ``src/repro_torch/csrc/fft_block.cu`` and the header it
includes, ``csrc/four_step_mma.cuh`` (the tensor-core body, both its
splits, shared with ``fft_matmul``), with exact text edits: an edit applies to whichever of
the two files holds its text (today every edit lands in the header), and
an edit that matches neither fails the run. Each variant's two files are
written to ``build/variants/<variant>/``, the header beside the source
where its quoted include finds it, and built with the port's own
``nvcc`` flags there:

* ``committed``: the source as it is;
* ``chained``: every mma of a k-step accumulates straight into the
  running sum (no fresh accumulator per k-step), the plain 3xTF32 order;
* ``unrolled``: every k-loop unrolled in full at every length (the
  committed unrolling of each length is the fastest without spills);
* ``cvt_rna``: the data rounded to TF32 by ``cvt.rna.tf32.f32`` in place
  of the two integer operations that round the same way;
* ``no_products``: no mma (the accumulators stay 0): the tile loads, the
  twiddle epilogue and the output stores alone;
* ``no_memory``: no tile load and no output store (each guarded by
  ``scale == 0``, which never holds, so the compiler keeps the products):
  the products alone, on whatever shared memory holds.

For each it prints ``ptxas``'s registers and spill bytes of each
``block_mma_kernel`` and ``block_mma3_kernel`` instance, then at every
length the body takes (262,144 pencils up to n = 512, then 2^27 / n) the
median of 20 launches by CUDA
events, queued back to back, the variants taken in turns (in order, then
in reverse), and the relative L2 error of the first 8,192 pencils
against ``torch.fft.fft`` in float64 (meaningless for the last two). The
card's name and power limit come first.
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

from repro_torch.kernels import _build, fft_block  # noqa: E402

OUT = ROOT / 'build' / 'variants'
HEADER = 'four_step_mma.cuh'
SHAPES = ((64, 262144), (128, 262144), (256, 262144), (512, 262144), (1024, 131072),
          (2048, 65536), (4096, 32768))
CHECKED = 8192

VARIANTS = {
    'committed': [],
    'chained': [('  float d[4] = {0.f, 0.f, 0.f, 0.f};\n', '  float (&d)[4] = acc;\n'),
                ('#pragma unroll\n  for (int e = 0; e < 4; ++e) acc[e] += d[e];\n', '')],
    'unrolled': [(f'MmaShape<{a}, {b}, {u}, {v}>', f'MmaShape<{a}, {b}, 0, 0>')
                 for a, b, u, v in ((16, 8, 1, 1), (16, 16, 0, 1), (32, 16, 1, 1))]
                + [('Mma3Shape<16, 16, 16, 1, 1>', 'Mma3Shape<16, 16, 16, 0, 0>')],
    'cvt_rna': [('  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n',
                 '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                 '  return r;\n')],
    'no_products': [('add_3xtf32(acc[i][j], ab, as, bb[j], bs[j]);', '{}'),
                    ('add_3xtf32(acc[i][j], ab[i], as[i], bb, bs);', '{}')],
    'no_memory': [('load_tile<S>(', 'if (scale == 0.f) load_tile<S>('),
                  ('        y[0] = acc', '        if (scale == 0.f) y[0] = acc'),
                  ('        y[S::N1] = acc', '        if (scale == 0.f) y[S::N1] = acc'),
                  ('        y[S::N1 * S::N2] = acc',
                   '        if (scale == 0.f) y[S::N1 * S::N2] = acc')],
}


def build(name: str, edits) -> tuple:
    files = {f: (_build.CSRC / f).read_text() for f in ('fft_block.cu', HEADER)}
    for old, new in edits:
        hit = [f for f, text in files.items() if old in text]
        if not hit:
            raise SystemExit(f"{name}: edit no longer matches the source: {old!r}")
        for f in hit:
            files[f] = files[f].replace(old, new)
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (out / f).write_text(text)
    lib = out / f'lib{name}.so'
    return subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, '-o', str(lib),
                             str(out / 'fft_block.cu')],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def ptxas(log: str) -> list:
    out = []
    for ln in log.splitlines():
        m = re.search(r'block_mma3?_kernelI((?:Li\d+E)+)E', ln)
        if 'Compiling entry function' in ln:
            out.append(['<' + ','.join(re.findall(r'Li(\d+)E', m.group(1))) + '>' if m else None])
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
        libs[name] = ctypes.CDLL(str(path))
        _build.declare(libs[name], 'fft_block_mma_launch', 7,
                       (ctypes.c_longlong, ctypes.c_int, ctypes.c_float))
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = {name: {} for name in VARIANTS}
    for n, batch in SHAPES:
        x = torch.randn((2, batch, n), generator=gen, device='cuda')
        ref = torch.fft.fft(torch.complex(x[0, :CHECKED].double(), x[1, :CHECKED].double()))
        ref = torch.stack([ref.real, ref.imag])
        y = torch.empty_like(x)
        fa, fb, w = fft_block.mma_tables_for(n, False, x.device)
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            def call(lib=libs[name]):
                err = lib.fft_block_mma_launch(
                    x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(), y[1].data_ptr(),
                    fa.data_ptr(), fb.data_ptr(), w.data_ptr(), batch, n, 1.0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err} at n={n}")
            call()
            torch.cuda.synchronize()
            got = y[:, :CHECKED].double()
            rel_l2 = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
            r = rows[name].setdefault(n, {'ms': [], 'rel_l2': rel_l2})
            r['ms'].append(time_ms(call))
        del x, y, ref
    for name, r in rows.items():
        print(json.dumps({'variant': name, 'lengths': {str(n): v for n, v in r.items()}}),
              flush=True)


if __name__ == '__main__':
    main()
