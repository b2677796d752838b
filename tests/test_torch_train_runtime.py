"""The port's checkpoints, training driver and launcher against the
reference's (``repro.checkpoint``, ``repro.runtime``,
``repro.launch.train``) on the CPU.

* Checkpoints cross both ways bit for bit: the port writes and the
  reference's ``restore_checkpoint`` reads, and the reverse, for a tree
  of fp32, bf16 and int32 leaves (the train state's kinds), with the
  same manifest and files.
* ``AsyncCheckpointer.save`` snapshots before it returns: an in-place
  update after it does not reach the files.
* The straggler monitor as the reference's test drives it, and the
  restart test bitwise (``atol=rtol=0``, as
  ``tests/test_train_integration.py``): 20 steps with a failure at 13
  end on an uninterrupted run's parameters.
* The launcher as a subprocess with ``--device cpu`` (exit 0,
  ``restarts=1``, its final checkpoint equal to an uninterrupted run's),
  and ``--device cuda`` raises without a card.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RC
from repro.runtime import StragglerMonitor as RefStragglerMonitor
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import SyntheticLM, shard_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.runtime import FailureInjector, StragglerMonitor, TrainDriver
from repro_torch.train.optim import adamw_init
from repro_torch.train.trainstep import make_train_step
from repro_torch.weights import params_from_reference, params_to_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Smoke-size steps are launch-bound; two threads a test worker keep
    the parallel suite from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state():
    rng = np.random.default_rng(0)
    return {'opt': {'step': np.int32(7),
                    'm': {'w': rng.standard_normal((3, 5)).astype(np.float32)}},
            'params': {'b16': rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
                       'w': rng.standard_normal((2, 3, 4)).astype(np.float32)}}


def _equal_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def test_the_reference_restores_the_ports_checkpoint(tmp_path):
    host = _state()
    tree = params_from_reference(host, device='cpu')
    assert tree['params']['b16'].dtype == torch.bfloat16
    final = save_checkpoint(str(tmp_path), 12, tree)
    assert os.path.basename(final) == 'step_00000012'
    assert RC.latest_step(str(tmp_path)) == latest_step(str(tmp_path)) == 12
    like = jax.tree.map(jnp.asarray, host)
    back = RC.restore_checkpoint(str(tmp_path), 12, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        _equal_bits(a, b)
    meta = json.load(open(os.path.join(final, 'manifest.json')))
    assert [m['dtype'] for m in meta['leaves']] == ['float32', 'int32', 'bfloat16', 'float32']


def test_the_port_restores_the_references_checkpoint(tmp_path):
    host = _state()
    RC.save_checkpoint(str(tmp_path / 'ref'), 3, jax.tree.map(jnp.asarray, host))
    like = params_from_reference(host, device='cpu')
    back = restore_checkpoint(str(tmp_path / 'ref'), 3, tree_map(torch.zeros_like, like))
    for a, b in zip(tree_leaves(params_to_reference(back)), jax.tree.leaves(host)):
        _equal_bits(a, b)
    # the same files and manifest leaves either way
    save_checkpoint(str(tmp_path / 'port'), 3, like)
    ref_dir, port_dir = tmp_path / 'ref' / 'step_00000003', tmp_path / 'port' / 'step_00000003'
    for i in range(4):
        assert (ref_dir / f'flat_{i}.npy').read_bytes() == (port_dir / f'flat_{i}.npy').read_bytes()
    rm, pm = (json.load(open(d / 'manifest.json')) for d in (ref_dir, port_dir))
    assert rm['leaves'] == pm['leaves'] and rm['num_leaves'] == pm['num_leaves']
    with pytest.raises(ValueError, match='leaves'):
        restore_checkpoint(str(tmp_path / 'ref'), 3, {'w': torch.zeros(1)})


def test_async_save_snapshots_before_it_returns(tmp_path):
    tree = {'w': torch.arange(6, dtype=torch.float32), 'n': torch.zeros((), dtype=torch.int32)}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(5, tree)
    tree['w'].add_(100.0)                     # the next step, in place
    tree['n'] += 1
    ck.close()
    back = restore_checkpoint(str(tmp_path), 5, tree)
    assert torch.equal(back['w'], torch.arange(6, dtype=torch.float32))
    assert int(back['n']) == 0
    assert back['w'].data_ptr() != tree['w'].data_ptr()


def test_straggler_monitor_trips():
    for cls in (StragglerMonitor, RefStragglerMonitor):
        mon = cls(alpha=0.5, trip_factor=2.0, warmup=2)
        trips = []
        mon.on_trip = lambda s, dt, e: trips.append(s)
        for s, dt in enumerate([0.1, 0.1, 0.1, 0.1, 0.5, 0.1]):
            mon.observe(s, dt)
        assert trips == [4]
        assert mon.trips == 1
        assert mon.ewma < 0.15               # not poisoned by the straggler step


def _run(ckpt_dir, fail_at, async_ckpt):
    cfg = smoke_config(get_config('internlm2-1.8b'))
    mesh = make_host_mesh(1, 1, device='cpu')
    step = make_train_step(cfg, mesh, peak_lr=3e-3, warmup_steps=5, total_steps=60,
                           param_dtype=torch.float32)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    opt = adamw_init(params)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=4)
    driver = TrainDriver(step, ckpt_dir, ckpt_every=5, async_ckpt=async_ckpt,
                         injector=FailureInjector([fail_at] if fail_at else []))
    params, opt, end = driver.run(params, opt, lambda i: shard_batch(data.batch_at(i), mesh),
                                  steps=20)
    assert end == 20
    return params, opt, driver


@pytest.mark.parametrize('async_ckpt', [False, True], ids=['sync', 'async'])
def test_restart_reproduces_uninterrupted_run(tmp_path, async_ckpt):
    """Train 20 steps with a failure at step 13; the restarted run ends
    with exactly the parameters and optimizer state of an uninterrupted
    run (deterministic data + deterministic optimizer)."""
    p_ref, o_ref, d_ref = _run(str(tmp_path / 'ref'), None, async_ckpt)
    p_ft, o_ft, d_ft = _run(str(tmp_path / 'ft'), 13, async_ckpt)
    assert d_ref.restarts == 0 and d_ft.restarts == 1
    assert [h['step'] for h in d_ft.history] == list(range(13)) + list(range(10, 20))
    for a, b in zip(tree_leaves({'p': p_ref, 'o': o_ref}), tree_leaves({'p': p_ft, 'o': o_ft})):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0, rtol=0)
    assert latest_step(str(tmp_path / 'ft')) == 20


def _launch(*args, env_extra=None):
    # one thread a subprocess: at smoke size the step is launch-bound, and
    # the test workers share the host's cores
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'), OMP_NUM_THREADS='1')
    env.update(env_extra or {})
    return subprocess.run([sys.executable, '-m', 'repro_torch.launch.train', *args],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_launcher_restarts_on_cpu_and_ends_on_the_uninterrupted_state(tmp_path):
    common = ['--arch', 'mamba2-1.3b', '--device', 'cpu', '--steps', '20', '--ckpt-every', '5']
    ft = _launch(*common, '--fail-at', '13', '--ckpt-dir', str(tmp_path / 'ft'))
    assert ft.returncode == 0, ft.stderr[-2000:]
    last = ft.stdout.strip().splitlines()[-1]
    assert last.startswith('[train] arch=mamba2-1.3b steps=20 loss first=')
    assert 'restarts=1 ' in last and '[driver] resumed from step 10' in ft.stdout
    ref = _launch(*common, '--ckpt-dir', str(tmp_path / 'ref'))
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert 'restarts=0 ' in ref.stdout.strip().splitlines()[-1]
    a, b = (tmp_path / d / 'step_00000020' for d in ('ft', 'ref'))
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) > 1
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_launcher_refuses_cuda_without_a_card_and_a_multi_rank_mesh(tmp_path):
    run = _launch('--arch', 'internlm2-1.8b', '--steps', '1',
                  '--ckpt-dir', str(tmp_path), env_extra={'CUDA_VISIBLE_DEVICES': ''})
    assert run.returncode != 0 and 'no CUDA device' in run.stderr
    # a mesh of several ranks runs under torch.distributed.run, which the
    # launcher names outside it (tests/test_torch_train_sharded_meshes.py
    # runs it there)
    run = _launch('--arch', 'internlm2-1.8b', '--device', 'cpu', '--mesh', '2x1',
                  '--steps', '1', '--ckpt-dir', str(tmp_path))
    assert run.returncode != 0 and 'torch.distributed.run' in run.stderr


@pytest.mark.parametrize('arch', ['hubert-xlarge', 'qwen2-vl-2b', 'recurrentgemma-9b',
                                  'dbrx-132b', 'deepseek-v2-236b'])
def test_launcher_trains_the_embeds_and_recurrent_configs(tmp_path, arch):
    """hubert-xlarge and qwen2-vl-2b train from embeds-mode batches (and
    M-RoPE positions), recurrentgemma-9b through the RG-LRU and local
    attention, dbrx-132b and deepseek-v2-236b through the MoE feed-forward
    (the router's aux loss in the loss) and MLA, as the reference's
    launcher trains them; the last checkpoint holds the final step."""
    run = _launch('--arch', arch, '--device', 'cpu', '--steps', '3', '--ckpt-every', '3',
                  '--seq', '24', '--batch', '2', '--ckpt-dir', str(tmp_path))
    assert run.returncode == 0, run.stderr[-2000:]
    last = run.stdout.strip().splitlines()[-1]
    assert last.startswith(f'[train] arch={arch} steps=3 loss first=')
    assert 'restarts=0 ' in last and os.path.isdir(tmp_path / 'step_00000003')
