"""The port's sharded trainer on 4 gloo ranks against the JAX package's
``jit_train_step``, at smoke size in fp32: FSDP over 'data', tensor and
expert parallel over 'model'.

``_torch_lm_multirank_worker.py --suite train --group a`` trains each
case of ``TRAIN_CASES['a']`` on a ('data', 'model') mesh of 2 x 2:
internlm2-1.8b, qwen1.5-32b (qkv bias), dbrx-132b (expert parallel, the
experts' d_model blocks gathered at use, ``fsdp_axes``),
deepseek-v2-236b (MLA, a shared expert), internlm2-1.8b with ``sp=True``
(Ulysses attention) and hubert-xlarge (embeds, encoder-only, LayerNorm).
Each runs ``jit_train_step`` for two steps of two microbatches from the
parameters drawn whole (seed ``PARAM_SEED``) and cut by
``weights.shard_params`` under the train rules, with remat on (each
period's FSDP gathers recomputed in the backward); each step's batch
comes from ``make_batch`` with a seed and each rank reads its block of
each microbatch (``shard_batch``). The reference is the reference's
``jit_train_step`` on the same Auto-axes meshes
(``_torch_lm_jax_reference.py train a``, four fake devices), run once
for the file beside the worker.

* each step's loss, ce, aux and grad norm within relative 1e-5 (measured
  at most 1.8e-7);
* after each step the gathered parameters, master, m and v, each tree as
  one vector, within relative L2 1e-5 (measured at most 1.6e-6), and m
  and v leaf by leaf within 1e-5 (measured at most 2.1e-6): the moments are
  linear in the gradients, so a collective with the wrong backward on
  any leaf shows there. The parameters are not held leaf by leaf:
  qwen1.5-32b's key bias starts at 0 and its gradient is fp32 noise (a
  key-independent term does not change a softmax; its RoPE rotation is
  all that reaches it), so the leaf is AdamW's first steps on noise,
  1.0e-3 apart after two steps here. The
  learning rate peaks at 1e-4: at 1e-3 the first step's sign-like moves
  of near-zero-gradient weights carry fp32 noise into the second step's
  gradients, and recurrentgemma-9b's second-step v reached 1.1e-5 in
  the one-rank port against the reference as in the sharded one
  (``test_torch_train_sharded_meshes.py``);
* the sharded checkpoint of internlm2-1.8b's state after the steps,
  saved on 2 x 2 (a file a distinct block), restored whole on one rank,
  onto 1 x 4 and 4 x 1 (reshard on load), and a one-rank checkpoint of
  the same state onto 2 x 2: every gathered tree bitwise the saved one;
* ``comm.reduce_scatter`` against the group's sum sliced, and the
  backward of ``all_gather`` (used apart: a reduce-scatter; used alike:
  this rank's slice) and of ``comm.enter`` (the group's sum) against what
  one rank computes from every rank's seeded operands, over 'data',
  'model' and both, in fp64 (at most 1e-12 apart);
* ``weights.draw_params`` gives the same whole tree on 2 x 2, 1 x 4 and
  4 x 1 under the train and the serve rules as on one rank, bitwise.
"""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import _torch_lm_multirank_worker as W  # noqa: E402

GROUP = 'a'
REL = 1e-5
COLLECTIVE_TOL = 1e-12
CASES = [c[0] for c in W.TRAIN_CASES[GROUP]]
COLLECTIVES = [f'{op}/{axis}' for axis in ('data', 'model', 'data+model')
               for op in ('reduce_scatter', 'gather_apart', 'gather_alike', 'enter')]


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    return W.run_train_group(tmp_path_factory.mktemp('train_sharded'), GROUP)


@pytest.mark.parametrize('case', CASES)
def test_metrics_match_the_reference(results, case):
    ref, got = results
    gaps = W.train_gaps(got, ref, case)
    bad = {k: v for k, v in gaps.items() if k.split('/')[-1] in W.TRAIN_METRICS and v > REL}
    assert not bad, bad


@pytest.mark.parametrize('case', CASES)
def test_parameters_and_optimizer_state_match_the_reference(results, case):
    ref, got = results
    gaps = W.train_gaps(got, ref, case)
    held = {k: v for k, v in gaps.items() if k.split('/', 1)[1] in W.TRAIN_TREES
            or (k.endswith('/leaf') and ('/opt/m/' in k or '/opt/v/' in k))}
    assert len(held) == W.TRAIN_STEPS * (len(W.TRAIN_TREES) + 2)
    bad = {k: v for k, v in held.items() if v > REL}
    assert not bad, bad


@pytest.mark.parametrize('check', ['latest', 'restore_1x1', 'restore_1x4', 'restore_4x1',
                                   'reshard_one_rank'])
def test_sharded_checkpoint_restores_on_other_meshes(results, check):
    _, got = results
    assert bool(got[f'ckpt/{check}'])
    # one file a distinct block, and the manifest
    assert int(got['ckpt/files']) > 1


@pytest.mark.parametrize('check', COLLECTIVES)
def test_collectives_and_their_backward(results, check):
    _, got = results
    assert float(got[check]) <= COLLECTIVE_TOL


@pytest.mark.parametrize('arch', W.DRAW_ARCHS)
def test_draw_params_is_the_same_tree_on_every_mesh(results, arch):
    _, got = results
    keys = [k for k in got if k.startswith(f'draw/{arch}/')]
    assert len(keys) == 6 and all(bool(got[k]) for k in keys)
