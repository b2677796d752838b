"""Three steps of the port's ``make_train_step`` against the reference's
(``repro.train.trainstep.make_train_step``) on the CPU, with
``microbatches`` 1 and 2.

internlm2-1.8b, mamba2-1.3b, recurrentgemma-9b (RG-LRU + local
attention), qwen2-vl-2b (embeds, M-RoPE with three distinct position
streams, untied head) and hubert-xlarge (embeds, encoder-only,
LayerNorm) at smoke size run the reference's step,
jitted on an Auto-axes 1 x 1 ``jax.sharding.Mesh`` (its Explicit-axes
``jax.make_mesh`` fails in ``with_sharding_constraint`` on jax 0.9). The
FFT-conv LM's reference mesh path cannot run on jax 0.9 (``plan_op``
reaches ``jax.core.trace_state_clean``), so its reference is the
composition of the step: ``jax.value_and_grad(loss_fn)`` with
``mesh=None`` per microbatch, the fp32 mean of the gradients,
``warmup_cosine`` and ``adamw_update``; the port runs on a CPU 1 x 1
mesh, through its ``plan_op`` plans and ``_FFTConv``.

Both sides start from the same parameters and optimizer state (carried
across with ``weights``) and the same ``SyntheticLM`` batches.
Tolerances (fp32): each step's loss, ce and grad norm within relative
1e-5 (measured at most 6e-6). After the first step the moments, linear
in the gradients, within relative L2 1e-5 a leaf (measured at most
2.4e-6). After three steps every parameter, master and moment leaf
within relative L2 5e-4 (measured at most 1.9e-4, mamba2's moments):
the first AdamW step moves each weight by about lr * sign(g), so a
weight whose gradient is near 0 takes fp32 noise into a step of lr,
and the later gradients see those weights; mamba2's SSD sums its
decays as segment sums where the reference differences cumulative sums.

One leaf is held apart after three steps: qwen2-vl-2b's key bias
(``attn/wk/b`` and its master and moments), at relative L2 1e-2
(measured at most 4.0e-3). Softmax does not change when a key-
independent term is added to a query's scores, so the key bias has a
gradient only through RoPE's rotation of it; at ``rope_theta`` 1e6 the
slowest frequencies turn by about 1e-5 rad over 32 positions, and
those elements' gradients (1e-9 to 1e-8) are sums that cancel to
within fp32 noise of zero and of AdamW's eps. The bias starts at 0, so
the leaf is only its three steps, each element a different fraction of
lr. At step 0 its moments are held at 1e-5 with the rest.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, smoke_config as ref_smoke
from repro.data import SyntheticLM
from repro.models import model as RM
from repro.train import optim as RO
from repro.train.schedule import warmup_cosine as ref_warmup_cosine
from repro.train.trainstep import make_train_step as ref_make_train_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import shard_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train.optim import adamw_init
from repro_torch.launch.mesh import require_one_rank
from repro_torch.train.trainstep import make_train_step
from repro_torch.weights import opt_to_reference, params_to_reference

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_lm_model import mrope_positions  # noqa: E402

REL = 1e-5
REL_AFTER_THREE = 5e-4
#: the key bias after three steps (the docstring's one leaf held apart)
KEY_BIAS_REL_AFTER_THREE = 1e-2
STEP_KW = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Smoke-size steps are launch-bound; two threads a test worker keep
    the parallel suite from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _configs(case):
    arch = 'mamba2-1.3b' if case == 'fftconv' else case
    cfg, rcfg = smoke_config(get_config(arch)), ref_smoke(ref_config(arch))
    if case == 'fftconv':
        cfg = dataclasses.replace(cfg, block_pattern=('fftconv',))
        rcfg = dataclasses.replace(rcfg, block_pattern=('fftconv',))
    return cfg, rcfg


def _ref_composed_step(rcfg, microbatches):
    """The reference's step, composed from its parts (mesh=None)."""
    vg = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(p, rcfg, b), has_aux=True))

    def step(params, opt, batch):
        mbs = [{k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])[i]
                for k, v in batch.items()} for i in range(microbatches)]
        acc, ls, lls = None, [], []
        for mb in mbs:
            (l, m), g = vg(params, mb)
            g = jax.tree.map(lambda x: x.astype(jnp.float32) / microbatches, g)
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
            ls.append(l)
            lls.append(m['loss'])
        lr = ref_warmup_cosine(opt['step'], **STEP_KW)
        params, opt, gn = RO.adamw_update(acc, opt, lr=lr, param_dtype=jnp.float32)
        return params, opt, {'loss': jnp.stack(ls).mean(), 'ce': jnp.stack(lls).mean(),
                             'grad_norm': gn, 'lr': lr}
    return step


def _data(cfg):
    """``SyntheticLM`` batches in the config's input mode; qwen2-vl-2b's
    positions replaced by distinct streams (a 4 x 4 patch grid, then
    text), which the data's equal streams would not test."""
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=3, input_mode=cfg.input_mode,
                       d_model=cfg.d_model, mrope=cfg.pos_kind == 'mrope')

    def batch_at(i):
        b = data.batch_at(i)
        if 'positions' in b:
            b['positions'] = mrope_positions(4, 32, 4)
        return b
    return batch_at


@pytest.mark.parametrize('microbatches', [1, 2])
@pytest.mark.parametrize('case', ['internlm2-1.8b', 'mamba2-1.3b', 'fftconv',
                                  'recurrentgemma-9b', 'qwen2-vl-2b', 'hubert-xlarge'])
def test_three_steps_match_reference(case, microbatches):
    cfg, rcfg = _configs(case)
    mesh = make_host_mesh(1, 1, device='cpu')
    step = make_train_step(cfg, mesh, microbatches=microbatches, param_dtype=torch.float32,
                           **STEP_KW)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    opt = adamw_init(params)
    rparams = tree_map(jnp.asarray, params_to_reference(params))
    ropt = RO.adamw_init(rparams)
    if case == 'fftconv':
        rstep = _ref_composed_step(rcfg, microbatches)
    else:
        rmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('data', 'model'))
        rstep = jax.jit(ref_make_train_step(rcfg, rmesh, microbatches=microbatches,
                                            param_dtype=jnp.float32, **STEP_KW))
    batch_at = _data(cfg)
    for i in range(3):
        batch = batch_at(i)
        params, opt, m = step(params, opt, shard_batch(batch, mesh))
        rparams, ropt, rm = rstep(rparams, ropt, {k: jnp.asarray(v) for k, v in batch.items()})
        assert m['lr'] == float(rm['lr'])
        for k in ('loss', 'ce', 'grad_norm'):
            assert abs(float(m[k]) - float(rm[k])) <= REL * abs(float(rm[k])), (i, k)
        if i == 0:
            for k in ('m', 'v'):
                for a, b in zip(tree_leaves(opt[k]), jax.tree.leaves(ropt[k])):
                    assert _rel(a.numpy(), b) <= REL, (k, a.shape, _rel(a.numpy(), b))
    assert int(opt['step']) == int(ropt['step']) == 3
    got = {'params': params_to_reference(params), 'opt': opt_to_reference(opt)}
    want = jax.tree.map(np.asarray, {'params': rparams, 'opt': ropt})
    for a, (path, b) in zip(jax.tree.leaves(got), jax.tree_util.tree_flatten_with_path(want)[0]):
        keys = [getattr(k, 'key', '') for k in path]
        tol = KEY_BIAS_REL_AFTER_THREE if keys[-2:] == ['wk', 'b'] else REL_AFTER_THREE
        assert _rel(a, b) <= tol, (keys, _rel(a, b))


def test_positions_split_on_their_batch_axis():
    from repro_torch.train.trainstep import split_microbatches
    batch = {'tokens': torch.arange(12).reshape(4, 3),
             'positions': torch.arange(36).reshape(3, 4, 3), 'flag': torch.tensor(1)}
    mbs = split_microbatches(batch, 2)
    assert torch.equal(mbs[1]['tokens'], batch['tokens'][2:])
    assert torch.equal(mbs[1]['positions'], batch['positions'][:, 2:])
    assert all(torch.equal(mb['flag'], batch['flag']) for mb in mbs)


def test_a_multi_rank_mesh_raises_naming_11g():
    class Mesh:
        shape = {'data': 2, 'model': 1}
    cfg, _ = _configs('internlm2-1.8b')
    with pytest.raises(ValueError, match='11g'):
        make_train_step(cfg, Mesh())
    with pytest.raises(ValueError, match='11g'):
        require_one_rank({'data': 1, 'model': 4})
    require_one_rank({'data': 1, 'model': 1})


def test_param_dtype_must_be_the_parameters_dtype():
    """The step keeps the parameters' tensors: asked for another dtype
    than theirs it raises (the reference would cast to it)."""
    cfg, _ = _configs('internlm2-1.8b')
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    step = make_train_step(cfg, param_dtype=torch.bfloat16)
    batch = shard_batch(SyntheticLM(cfg.vocab_size, 8, 2).batch_at(0), torch.device('cpu'))
    with pytest.raises(ValueError, match='param_dtype'):
        step(params, adamw_init(params), batch)


@pytest.mark.parametrize('case', ['internlm2-1.8b', 'mamba2-1.3b'])
def test_bf16_parameters_train_as_the_reference(case):
    """``param_dtype=bfloat16``: bf16 parameters, products and gradients,
    an fp32 master and moments, as the reference's step on the same
    bf16 parameters. Three steps; each step's loss within 1e-3 relative
    (measured at most 2.4e-4) and grad norm within 2e-2 (measured at
    most 9e-3: the two packages round bf16 products in another order);
    the parameters stay bf16 and equal their master rounded to bf16."""
    cfg, rcfg = _configs(case)
    step = make_train_step(cfg, param_dtype=torch.bfloat16, **STEP_KW)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32))
    opt = adamw_init(params)
    rparams = tree_map(jnp.asarray, params_to_reference(params))
    ropt = RO.adamw_init(rparams)
    rmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('data', 'model'))
    rstep = jax.jit(ref_make_train_step(rcfg, rmesh, param_dtype=jnp.bfloat16, **STEP_KW))
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=3)
    for i in range(3):
        batch = data.batch_at(i)
        params, opt, m = step(params, opt, shard_batch(batch, torch.device('cpu')))
        rparams, ropt, rm = rstep(rparams, ropt, {k: jnp.asarray(v) for k, v in batch.items()})
        assert abs(float(m['loss']) - float(rm['loss'])) <= 1e-3 * float(rm['loss'])
        assert abs(float(m['grad_norm']) - float(rm['grad_norm'])) <= 2e-2 * float(rm['grad_norm'])
    for p, master in zip(tree_leaves(params), tree_leaves(opt['master'])):
        assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert torch.equal(p, master.to(torch.bfloat16))
