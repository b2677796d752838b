"""The port's sharded LM server on 4 gloo ranks against the JAX
package's sharded engine, at smoke size in fp32.

``_torch_lm_multirank_worker.py --suite lm`` serves each of
internlm2-1.8b, qwen1.5-32b (qkv bias), dbrx-132b (expert parallel),
deepseek-v2-236b (MLA, expert parallel, a shared expert),
recurrentgemma-9b (the ring cache, MQA gathered at use), mamba2-1.3b
(the SSD gathered at use) and qwen2-vl-2b (embeds, M-RoPE) with
``ServeEngine`` on ('data', 'model') meshes of 2 x 2 and 1 x 4, the
parameters drawn whole and cut by ``weights.shard_params``. The
reference is ``repro.serve.ServeEngine`` on the same meshes
(``_torch_lm_jax_reference.py lm``, four fake devices, Auto axes).

* prefill's and each decode step's logits, teacher-forced on the
  reference's tokens, within relative L2 1e-5 of the reference's; the
  generated tokens equal the reference's up to the first step whose
  top-2 margin is at most 1e-3;
* the same logits within relative L2 1e-5 of the one-rank port's. The
  expert-parallel dispatch takes its capacity from a rank's tokens, so
  its drops differ from the one-rank path's by construction: an MoE
  config is held against the one-rank port at a capacity factor at
  which no pair drops (``NO_DROP_CF``), and against the reference at its
  published one;
* ``make_prefill_step(sp=True)`` (Ulysses attention) within relative L2
  1e-5 of the non-SP prefill;
* ``ulysses_attention`` (GQA, and the gathered MQA fallback) and
  ``moe_ep_explicit`` against the reference's, ``overlap_chunks`` 1 and
  2, max gap over the largest magnitude <= 1e-5;
* ``gather_tree`` of ``shard_tree`` gives the whole tree back; each
  rank's caches have the shapes of its ``init_cache`` blocks;
* three smoke configs whose query heads the 'model' group does not
  divide (``W.UNEVEN``, each on its own mesh), held as above.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import ServeEngine

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import _torch_lm_multirank_worker as W  # noqa: E402

MESHES = ('2x2', '1x4')
REL, MARGIN, OPS_TOL = 1e-5, 1e-3, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _run(*args):
    subprocess.run([sys.executable, *args], check=True, timeout=600)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    """(reference results, the worker's results by mesh)."""
    tmp = tmp_path_factory.mktemp('lm_sharded')
    ref = tmp / 'reference.npz'
    _run(os.path.join(HERE, '_torch_lm_jax_reference.py'), str(ref), 'lm')
    out = {}
    for mesh in MESHES:
        path = tmp / f'{mesh}.npz'
        _run(os.path.join(HERE, '_torch_lm_multirank_worker.py'), str(path), str(_free_port()),
             '--mesh', mesh, '--suite', 'lm', '--ref', str(ref))
        out[mesh] = dict(np.load(path))
    return dict(np.load(ref)), out


@pytest.fixture(scope='module')
def ops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('lm_ops')
    ref = tmp / 'reference.npz'
    _run(os.path.join(HERE, '_torch_lm_jax_reference.py'), str(ref), 'ops')
    out = {}
    for mesh in MESHES:
        path = tmp / f'{mesh}.npz'
        _run(os.path.join(HERE, '_torch_lm_multirank_worker.py'), str(path), str(_free_port()),
             '--mesh', mesh, '--suite', 'ops')
        out[mesh] = dict(np.load(path))
    return dict(np.load(ref)), out


@pytest.fixture(scope='module')
def one_rank(results):
    """The one-rank port's logits, teacher-forced on each mesh's
    reference tokens (an MoE config at ``NO_DROP_CF``)."""
    ref, _ = results
    out = {}
    mesh = make_host_mesh(1, 1, device='cpu')
    for arch in W.LM_ARCHS + tuple(W.UNEVEN):
        cfg = W.lm_config(arch, W.NO_DROP_CF if W.lm_config(arch).moe else None)
        params = W.lm_params(cfg)
        prompts = {k: torch.as_tensor(v) for k, v in W.lm_prompts(cfg).items()}
        S = W.PROMPTS.get(cfg.name, W.PROMPT)
        for m in MESHES:
            if arch not in W.lm_archs(m):
                continue
            with ServeEngine(cfg, mesh, params, batch=W.LM_BATCH, prompt_len=S,
                             max_len=S + W.LM_STEPS) as eng:
                out[m, arch] = W._teacher_forced(eng, prompts,
                                                 torch.as_tensor(ref[f'{m}/{arch}/tokens']))
    return out


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('arch', W.LM_ARCHS)
def test_logits_match_the_reference_engine(results, mesh, arch):
    ref, got = results
    assert _rel(got[mesh][f'{arch}/logits'], ref[f'{mesh}/{arch}/logits']) <= REL


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('arch', W.LM_ARCHS)
def test_generated_tokens_match_the_reference_engine(results, mesh, arch):
    """``generate`` returns the whole (B, steps) on every rank, equal to
    the reference's tokens up to the first step whose top-2 margin is at
    most ``MARGIN`` (after it, both continue from a near tie)."""
    ref, got = results
    toks, want = got[mesh][f'{arch}/tokens'], ref[f'{mesh}/{arch}/tokens']
    assert toks.shape == (W.LM_BATCH, W.LM_STEPS) and toks.dtype == np.int32
    top2 = np.sort(ref[f'{mesh}/{arch}/logits'], axis=-1)[..., -2:]
    wide = np.cumprod(top2[..., 1] - top2[..., 0] > MARGIN, axis=1).astype(bool)
    assert wide.any()
    np.testing.assert_array_equal(toks[wide], want[wide])


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('arch', W.LM_ARCHS)
def test_logits_match_the_one_rank_port(results, one_rank, mesh, arch):
    _, got = results
    key = f'{arch}/logits_cf8' if W.lm_config(arch).moe else f'{arch}/logits'
    assert _rel(got[mesh][key], one_rank[mesh, arch].numpy()) <= REL


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('arch', W.SP_ARCHS)
def test_sequence_parallel_prefill(results, mesh, arch):
    """``make_prefill_step(sp=True)``: Ulysses attention on each rank's
    sequence block (recurrentgemma-9b's one kv head takes the gathered
    fallback, its window the ring cache), the same logits."""
    _, got = results
    assert _rel(got[mesh][f'{arch}/sp_logits'], got[mesh][f'{arch}/logits'][:, 0]) <= REL


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('case', [c[0] for c in W.ULYSSES_CASES] + [c[0] for c in W.MOE_CASES])
def test_ulysses_and_expert_parallel_match_the_reference(ops, mesh, case):
    ref, got = ops
    want, mine = ref[f'{mesh}/{case}'], got[mesh][case]
    assert mine.shape == want.shape
    assert np.abs(mine - want).max() / np.abs(want).max() <= OPS_TOL


@pytest.mark.parametrize('mesh', MESHES)
@pytest.mark.parametrize('arch', W.LM_ARCHS)
def test_prefill_caches_are_laid_out_as_cache_axes(results, mesh, arch):
    """Each rank's caches from prefill have the shapes of its blocks of
    ``init_cache`` under ``cache_axes`` (the heads layout)."""
    _, got = results
    assert bool(got[mesh][f'{arch}/cache_layout'])


@pytest.mark.parametrize('arch', list(W.UNEVEN))
def test_uneven_heads_serve_as_the_reference_engine(results, one_rank, arch):
    """A config whose query heads the 'model' group does not divide
    (``W.UNEVEN``: 6 MHA heads with qkv bias and 6 GQA heads over 2 kv
    heads on 1 x 4; 5 MQA heads with embeds and M-RoPE on 2 x 2), each
    rank its ``head_range``: the logits within ``REL`` of the reference's
    engine and of the one-rank port, the tokens as
    ``test_generated_tokens_match_the_reference_engine`` holds them, and
    each rank's caches its ``init_cache`` blocks (its own kv heads)."""
    ref, got = results
    mesh = W.UNEVEN[arch][3]
    logits, want = got[mesh][f'{arch}/logits'], ref[f'{mesh}/{arch}/logits']
    assert _rel(logits, want) <= REL
    assert _rel(logits, one_rank[mesh, arch].numpy()) <= REL
    top2 = np.sort(want, axis=-1)[..., -2:]
    wide = np.cumprod(top2[..., 1] - top2[..., 0] > MARGIN, axis=1).astype(bool)
    assert wide.any()
    np.testing.assert_array_equal(got[mesh][f'{arch}/tokens'][wide],
                                  ref[f'{mesh}/{arch}/tokens'][wide])
    assert bool(got[mesh][f'{arch}/cache_layout'])


@pytest.mark.parametrize('mesh', MESHES)
def test_gather_tree_round_trip(results, mesh):
    _, got = results
    assert bool(got[mesh]['gather_tree_roundtrip'])
