"""Static check: the port, its chip script and its scripts under
``benchmarks/`` (``torch_*.py``) import neither jax nor the JAX package
``repro`` (not even its numpy-only modules)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / 'src' / 'repro_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']
         + sorted((ROOT / 'benchmarks').glob('torch_*.py')))
BANNED = ('jax', 'jaxlib', 'repro')


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, 'attr', None)
              in ('import_module', '__import__') and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path) if m.split('.')[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_sees_the_port():
    assert len(FILES) > 15
    assert 'torch' in set(m.split('.')[0] for m in _imported(ROOT / 'chip_smoke.py'))
