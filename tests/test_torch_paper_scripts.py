"""The port's paper scripts (``benchmarks/torch_paper_*.py``) print,
line for line, what the reference's (``benchmarks/paper_*.py``) print:
the four analytic scripts whole, and ``torch_paper_fig3.py``'s part (a);
its part (b), the port's pencils timed, runs on the CPU at a batch of 4
and prints one line a method and length. Both run in this process, their
standard output captured."""
import importlib.util
import pathlib
import re
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ('table1', 'table2', 'fig4', 'fig567', 'fig3')


def _main(path: pathlib.Path, argv, capsys, monkeypatch) -> list:
    """The lines ``path``'s ``main()`` prints with ``argv``."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(sys, 'argv', [str(path)] + list(argv))
    spec = importlib.util.spec_from_file_location(f'_paper_{path.stem}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def _part_a(lines):
    return lines[:next(i for i, ln in enumerate(lines) if ln.startswith('# paper_fig3b'))]


@pytest.mark.parametrize("name", SCRIPTS)
def test_paper_script_matches_reference(name, capsys, monkeypatch):
    argv = ['--device', 'cpu', '--batch', '4'] if name == 'fig3' else []
    port = _main(ROOT / 'benchmarks' / f'torch_paper_{name}.py', argv, capsys, monkeypatch)
    monkeypatch.setattr(sys, 'argv', ['x'])
    ref = _main(ROOT / 'benchmarks' / f'paper_{name}.py', [], capsys, monkeypatch)
    if name != 'fig3':
        assert port == ref
        return
    assert _part_a(port) == _part_a(ref) and len(_part_a(port)) == 13
    timed = port[len(_part_a(port)) + 1:]
    assert port[len(_part_a(port))].startswith("# paper_fig3b: the port's pencils on the host")
    assert [ln.split(',')[0] for ln in timed] == [
        f'fig3/pencil_{m}_n{n}' for n in (256, 1024, 4096) for m in ('stockham', 'four_step')]
    for ln in timed:
        assert re.fullmatch(r'fig3/pencil_\w+_n\d+,[\d.]+,gflops=[\d.]+', ln), ln


def test_headline_lines():
    """The lines ``chip_smoke.py``'s ``[paper]`` phase requires are there."""
    import subprocess
    out = subprocess.run([sys.executable, str(ROOT / 'benchmarks' / 'torch_paper_table1.py')],
                         capture_output=True, text=True, check=True).stdout
    assert 'table1/512_fp32_us,959.260,paper=959us' in out
    assert 'derived=18.89 paper=18.9' in out and 'derived=32.70 paper=32.7' in out
