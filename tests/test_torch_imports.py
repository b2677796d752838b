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


def test_the_check_sees_the_serving_engine():
    serve = {p.name for p in FILES if p.parent.name == 'serve'
             and p.parent.parent.name == 'repro_torch'}
    assert serve == {'__init__.py', 'engine.py', 'faults.py', 'fft_engine.py',
                     'plan_cache.py', 'policy.py', 'protocol.py', 'service.py'}


def test_the_check_sees_the_service_launcher():
    launch = {p.name for p in FILES if p.parent.name == 'launch'
              and p.parent.parent.name == 'repro_torch'}
    assert {'fft_service.py', 'mesh.py', 'serve.py'} <= launch


def test_the_check_sees_the_language_models():
    """The LM server's modules: configs, models, the engine, the
    launcher and the parameter converter."""
    port = ROOT / 'src' / 'repro_torch'
    rel = {str(p.relative_to(port)) for p in FILES if port in p.parents}
    assert {'configs/__init__.py', 'configs/base.py', 'configs/internlm2_1_8b.py',
            'configs/mamba2_1_3b.py', 'models/__init__.py', 'models/layers.py',
            'models/attention.py', 'models/ssd.py', 'models/griffin.py', 'models/model.py',
            'serve/engine.py',
            'launch/serve.py', 'weights.py'} <= rel
    assert len([p for p in rel if p.startswith('configs/')]) == 12


def test_importing_the_serving_engine_loads_no_jax():
    """At run time too: a fresh interpreter that imports
    ``repro_torch.serve`` (and so the whole port under it: the engines,
    the protocol, the policy and the service), both launchers, the
    configs, the models and the parameter converter has no jax and no
    ``repro`` module loaded."""
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, 'src'); import repro_torch.serve, "
            "repro_torch.serve.protocol, repro_torch.serve.policy, repro_torch.serve.service, "
            "repro_torch.launch.fft_service, repro_torch.fft, repro_torch.launch.serve, "
            "repro_torch.configs, repro_torch.models.model, repro_torch.weights; "
            "bad = sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_check_sees_the_trainer():
    """The training path's modules: the optimizer, schedule and step, the
    data pipeline, checkpoints, the driver, the launcher and the
    examples' port."""
    port = ROOT / 'src' / 'repro_torch'
    rel = {str(p.relative_to(port)) for p in FILES if port in p.parents}
    assert {'train/__init__.py', 'train/optim.py', 'train/schedule.py', 'train/trainstep.py',
            'data/__init__.py', 'data/pipeline.py', 'checkpoint/__init__.py',
            'checkpoint/ckpt.py', 'runtime/__init__.py', 'runtime/driver.py',
            'launch/train.py', 'models/ssd.py'} <= rel
    for name in ('torch_train_lm.py', 'torch_fftconv_lm.py', 'torch_serve_batched.py'):
        bad = [m for m in _imported(ROOT / 'examples' / name) if m.split('.')[0] in BANNED]
        assert not bad, f"examples/{name} imports {bad}"


def test_the_check_sees_the_sharded_server():
    """The comm surface, the sharding rules and the sharded server's
    modules are under the check, and importing them in a fresh
    interpreter loads no jax and no ``repro`` module."""
    import subprocess
    import sys
    port = ROOT / 'src' / 'repro_torch'
    rel = {str(p.relative_to(port)) for p in FILES if port in p.parents}
    assert {'comm/__init__.py', 'comm/strategies.py', 'parallel/__init__.py',
            'parallel/sharding.py', 'serve/engine.py', 'models/moe.py', 'weights.py'} <= rel
    code = ("import sys; sys.path.insert(0, 'src'); import repro_torch.comm, "
            "repro_torch.parallel, repro_torch.serve.engine, repro_torch.weights, "
            "repro_torch.models.moe, repro_torch.configs; "
            "bad = sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_check_sees_mesh_serving():
    """Serving on a mesh: the engine, the service and its launcher, the
    example that serves a mesh, and the worker the four-card benchmark
    runs."""
    port = ROOT / 'src' / 'repro_torch'
    rel = {str(p.relative_to(port)) for p in FILES if port in p.parents}
    assert {'serve/fft_engine.py', 'serve/service.py', 'launch/fft_service.py',
            'launch/mesh.py'} <= rel
    for path in (ROOT / 'examples' / 'torch_serve_fft.py',
                 ROOT / 'tests' / '_torch_serve_mesh_worker.py'):
        bad = [m for m in _imported(path) if m.split('.')[0] in BANNED]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
