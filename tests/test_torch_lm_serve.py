"""The port's language-model server (``repro_torch.serve.ServeEngine``,
``repro_torch.launch.serve``) against the reference's engine.

The oracle is ``repro.serve.ServeEngine`` on an Auto-axes 1 x 1 mesh
(``jax.sharding.Mesh``; the reference's own launcher builds an
Explicit-axes mesh with ``jax.make_mesh`` and fails there). The same
parameters (the port's, carried across by ``repro_torch.weights``) and
the same numpy prompts go through both: the generated tokens are equal,
and the logits of prefill and of each decode step, teacher-forced on
the reference's tokens, agree within max abs 1e-5 and relative L2 1e-5.
recurrentgemma-9b's prompt (24) is longer than its smoke window (16),
so prefill folds the ring and decode writes across it; qwen2-vl-2b's
prompt is embeddings with three distinct position streams (a 4 x 4
patch grid, then text), its decode text; dbrx-132b and deepseek-v2-236b
serve through the MoE feed-forward at its published capacity factor
(both engines drop the same pairs) and deepseek-v2-236b through MLA's
compressed cache.
The launcher runs on the CPU as a user runs it; a mesh of more than one
rank, and ``cuda`` without a card, raise.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.models import model as RM
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import tree_map
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import require_one_rank
from repro_torch.weights import params_to_reference

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_lm_model import mrope_positions  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH_IDS = ['internlm2-1.8b', 'mamba2-1.3b', 'recurrentgemma-9b', 'qwen2-vl-2b',
            'dbrx-132b', 'deepseek-v2-236b']
B, STEPS = 2, 6
#: prompt lengths: recurrentgemma-9b's past its smoke window of 16;
#: qwen2-vl-2b's a 4 x 4 patch grid and 4 text positions
PROMPTS = {'recurrentgemma-9b': 24, 'qwen2-vl-2b': 20}
ATOL, REL = 1e-5, 1e-5


def _close(got, want):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    rl2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= ATOL and rl2 <= REL, f'max abs {err:.3e}, rel L2 {rl2:.3e}'


@pytest.fixture(scope='module', params=ARCH_IDS)
def served(request):
    """(cfg, rcfg, params, rparams, prompts, port tokens, reference tokens)."""
    arch = request.param
    cfg, rcfg = smoke_config(get_config(arch)), ref_smoke(ref_config(arch))
    params = M.init_params(torch.Generator().manual_seed(5), cfg, torch.float32)
    rparams = tree_map(jnp.asarray, params_to_reference(params))
    prompt = PROMPTS.get(arch, 12)
    rng = np.random.default_rng(6)
    if cfg.input_mode == 'embeds':
        prompts = {'embeds': rng.standard_normal((B, prompt, cfg.d_model)).astype(np.float32),
                   'positions': mrope_positions(B, prompt, 4)}
    else:
        prompts = {'tokens': rng.integers(0, cfg.vocab_size, (B, prompt)).astype(np.int32)}
    with ServeEngine(cfg, make_host_mesh(1, 1, device='cpu'), params, batch=B,
                     prompt_len=prompt, max_len=prompt + STEPS) as eng:
        toks = eng.generate({k: torch.as_tensor(v) for k, v in prompts.items()}, STEPS)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('data', 'model'))
    with mesh:
        ref = RefServeEngine(rcfg, mesh, rparams, batch=B, prompt_len=prompt,
                             max_len=prompt + STEPS, param_dtype=jnp.float32)
        rtoks = np.array(ref.generate({k: jnp.asarray(v) for k, v in prompts.items()}, STEPS))
    return cfg, rcfg, params, rparams, prompts, toks, rtoks


def test_generated_tokens_equal_the_reference_engines(served):
    *_, toks, rtoks = served
    assert toks.dtype == torch.int32 and toks.shape == (B, STEPS)
    np.testing.assert_array_equal(toks.numpy(), rtoks)


def test_teacher_forced_logits_match_the_reference(served):
    cfg, rcfg, params, rparams, prompts, _, rtoks = served
    prompt = PROMPTS.get(cfg.name, 12)
    cap = prompt + STEPS
    with ServeEngine(cfg, make_host_mesh(1, 1, device='cpu'), params, batch=B,
                     prompt_len=prompt, max_len=cap) as eng:
        logits, caches = eng.prefill({k: torch.as_tensor(v) for k, v in prompts.items()})
        rlogits, rcaches = RM.prefill(rparams, rcfg,
                                      {k: jnp.asarray(v) for k, v in prompts.items()},
                                      cache_cap=cap)
        _close(logits, rlogits)
        for t in range(STEPS - 1):
            tok = rtoks[:, t:t + 1]
            logits, caches = eng.decode(caches, torch.as_tensor(tok), prompt + t)
            rlogits, rcaches = RM.decode_step(rparams, rcfg, rcaches, jnp.asarray(tok),
                                              jnp.int32(prompt + t))
            _close(logits, rlogits)


def test_engine_validates_its_inputs():
    cfg = smoke_config(get_config('internlm2-1.8b'))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    mesh = make_host_mesh(1, 1, device='cpu')
    eng = ServeEngine(cfg, mesh, params, batch=2, prompt_len=4, max_len=6)
    with pytest.raises(ValueError, match='over max_len'):
        eng.generate({'tokens': torch.zeros((2, 4), dtype=torch.int32)}, 4)
    with pytest.raises(ValueError, match='engine serves'):
        eng.generate({'tokens': torch.zeros((2, 5), dtype=torch.int32)}, 2)
    assert eng.generate({'tokens': torch.zeros((2, 4), dtype=torch.int32)}, 3).shape == (2, 3)
    with pytest.raises(ValueError, match='max_len'):
        ServeEngine(cfg, mesh, params, batch=2, prompt_len=4, max_len=3)
    meta = tree_map(lambda t: t.to('meta'), params)
    with pytest.raises(ValueError, match='parameters on'):
        ServeEngine(cfg, mesh, meta, batch=2, prompt_len=4, max_len=6)
    # an embeds-mode config takes embeddings (B, S, d_model) and M-RoPE
    # positions (3, B, S)
    cfg = smoke_config(get_config('qwen2-vl-2b'))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    eng = ServeEngine(cfg, mesh, params, batch=2, prompt_len=4, max_len=6)
    emb = torch.zeros((2, 4, cfg.d_model))
    with pytest.raises(ValueError, match="takes 'embeds'"):
        eng.generate({'tokens': torch.zeros((2, 4), dtype=torch.int32)}, 2)
    with pytest.raises(ValueError, match='embeds of shape'):
        eng.generate({'embeds': emb[:, :3]}, 2)
    with pytest.raises(ValueError, match='positions of shape'):
        eng.generate({'embeds': emb, 'positions': torch.zeros((2, 4), dtype=torch.int32)}, 2)
    assert eng.generate({'embeds': emb}, 3).shape == (2, 3)


@pytest.mark.parametrize('shape', [{'data': 2, 'model': 2}, {'data': 1, 'model': 4},
                                   {'data': 2, 'model': 1}])
def test_a_mesh_of_several_ranks_raises(shape):
    with pytest.raises(ValueError, match='item 11g'):
        require_one_rank(shape)

    class Mesh4:
        device = torch.device('cpu')

    Mesh4.shape = shape
    cfg = smoke_config(get_config('internlm2-1.8b'))
    with pytest.raises(ValueError, match='1x1 mesh only'):
        ServeEngine(cfg, Mesh4(), {}, batch=1, prompt_len=1, max_len=2)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a card is present: cuda is the default and runs')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_host_mesh(1, 1)


def _launch(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))
    return subprocess.run([sys.executable, '-m', 'repro_torch.launch.serve', *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize('arch', ARCH_IDS)
def test_launcher_on_the_cpu(arch):
    proc = _launch('--arch', arch, '--device', 'cpu', '--batch', '2', '--prompt-len', '8',
                   '--gen', '4')
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith(f'[serve] arch={arch} batch=2 gen=4 tokens in ')
    assert lines[0].endswith(' tok/s)')
    assert lines[1].startswith('[serve] first row: [') and len(json.loads(lines[1][19:])) == 4


def test_launcher_refuses_what_it_cannot_serve():
    proc = _launch('--arch', 'internlm2-1.8b', '--device', 'cpu', '--mesh', '2x2')
    assert proc.returncode != 0 and 'item 11g' in proc.stderr
    proc = _launch('--arch', 'dbrx-132b', '--device', 'cpu')      # ported (11d)
    assert proc.returncode == 0 and proc.stdout.startswith('[serve] arch=dbrx-132b ')
    proc = _launch('--arch', 'hubert-xlarge', '--device', 'cpu')
    assert proc.returncode != 0 and 'encoder-only' in proc.stderr
    if not torch.cuda.is_available():
        proc = _launch('--arch', 'internlm2-1.8b')
        assert proc.returncode != 0 and 'no CUDA device' in proc.stderr


@pytest.mark.parametrize('arch', ['recurrentgemma-9b', 'qwen2-vl-2b', 'mamba2-1.3b',
                                  'granite-3-8b'])
def test_serve_batched_example_on_the_cpu(arch):
    """``examples/torch_serve_batched.py`` on the CPU: the ring cache
    (a 24-token prompt over a window of 16), the embeds input, the SSM
    state and the dense cache; it checks its tokens against the full
    forward and prints its OK line. An encoder-only config is refused."""
    script = os.path.join(ROOT, 'examples', 'torch_serve_batched.py')
    proc = subprocess.run([sys.executable, script, '--device', 'cpu', '--arch', arch],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f'[serve_batched] {arch} on cpu: 4 prompts x 12 tokens' in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == 'torch_serve_batched OK'
    if arch == 'granite-3-8b':
        proc = subprocess.run([sys.executable, script, '--device', 'cpu', '--arch',
                               'hubert-xlarge'], cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0 and 'encoder-only' in proc.stderr
