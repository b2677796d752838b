"""The dry-run records as one table: the language-model cells of
``python -m repro_torch.launch.dryrun`` and the FFT cells of
``benchmarks/torch_roofline_fft.py``, side by side.

Port of ``benchmarks/roofline.py``. Reads every ``*.json`` under
``--dir`` (default ``results/dryrun_torch``), prints the table and writes
a CSV with the reference's columns (``COLS``) to ``--out`` (default
``results/roofline_torch_summary.csv``). The times are the records'
roofline terms from the H100 datasheet's constants, not measurements.
``note`` holds an FFT cell's method, or where the 'model' group does not
divide an LM cell's heads, rank 0's query heads and the most a rank has.

    python3 benchmarks/torch_roofline.py [--dir results/dryrun_torch] [--out CSV]

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

COLS = ('mesh', 'arch', 'shape', 'status', 'dominant', 'compute_ms',
        'memory_ms', 'collective_ms', 'bound_ms', 'model_tflops',
        'useful_flop_ratio', 'roofline_fraction', 'temp_GB', 'note')

DEFAULT_DIR = os.path.join('results', 'dryrun_torch')
DEFAULT_OUT = os.path.join('results', 'roofline_torch_summary.csv')


def _mesh(tag: str) -> str:
    """'pod_16x16' -> '16x16', 'multipod_2x16x16' -> '2x16x16'."""
    return tag.split('_', 1)[1] if '_' in tag else tag


def _note(r: dict) -> str:
    if r.get('kind') == 'fft':
        return r.get('method', '')
    heads = r.get('heads')
    if heads and heads['rank0']['q_heads'] != heads['most']['q_heads']:
        return f"q heads rank0 {heads['rank0']['q_heads']} most {heads['most']['q_heads']}"
    return r.get('method', '')


def rows(result_dir: str = DEFAULT_DIR) -> List[Dict]:
    out = []
    for fn in sorted(glob.glob(os.path.join(result_dir, '*.json'))):
        with open(fn) as fh:
            r = json.load(fh)
        row = dict.fromkeys(COLS, '')
        row.update(mesh=_mesh(r['mesh']), arch=r['arch'], shape=r['shape'], status=r['status'])
        if r['status'] == 'skipped':
            row['note'] = r['skip_reason']
        elif r['status'] == 'failed':
            row['note'] = r.get('error', '')[:80]
        else:
            ro = r['roofline']
            row.update(
                dominant=ro['dominant'].replace('_s', ''),
                compute_ms=f"{ro['compute_s'] * 1e3:.2f}",
                memory_ms=f"{ro['memory_s'] * 1e3:.2f}",
                collective_ms=f"{ro['collective_s'] * 1e3:.2f}",
                bound_ms=f"{ro['bound_s'] * 1e3:.2f}",
                model_tflops=f"{r['model_flops'] / 1e12:.1f}",
                useful_flop_ratio=f"{r.get('useful_flop_ratio', 0):.3f}",
                roofline_fraction=f"{r.get('roofline_fraction', 0):.4f}",
                temp_GB=f"{r['memory'].get('temp_size_in_bytes', 0) / 1e9:.2f}",
                note=_note(r))
        out.append(row)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--dir', default=DEFAULT_DIR)
    ap.add_argument('--out', default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    table = rows(args.dir)
    if not table:
        print(f'no dry-run records under {args.dir}: run python -m repro_torch.launch.dryrun '
              'and python3 benchmarks/torch_roofline_fft.py first')
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(','.join(COLS) + '\n')
        for row in table:
            f.write(','.join(str(row[c]).replace(',', ';') for c in COLS) + '\n')
    widths = {c: max(len(c), *(len(str(r[c])) for r in table)) for c in COLS}
    print('  '.join(c.ljust(widths[c]) for c in COLS))
    for row in table:
        print('  '.join(str(row[c]).ljust(widths[c]) for c in COLS))
    ok = [r for r in table if r['status'] == 'ok']
    print(f'\n{len(table)} cells: {len(ok)} ok, '
          f'{sum(r["status"] == "skipped" for r in table)} skipped, '
          f'{sum(r["status"] == "failed" for r in table)} failed -> {args.out}')


if __name__ == '__main__':
    main()
