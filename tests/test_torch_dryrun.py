"""The port's dry run (``repro_torch.launch.dryrun``): rank 0's step of a
production cell at full width and depth on ``meta`` tensors under a
``fake`` process group, counted.

* ``model_flops`` equals the reference's formula (6ND train, 2ND
  prefill, 2NB decode) with ``repro.models.model.active_param_count``
  for every arch and shape. ``repro.launch.dryrun`` itself is not
  imported: its import sets ``XLA_FLAGS`` to 512 devices for every later
  JAX test in this worker;
* a rank's parameter bytes (serve and train rules) and AdamW state
  bytes equal those the reference's ``spec_for`` gives on an object with
  the production mesh's ``.shape`` (its ``make_rules`` reads nothing
  else), for every arch on 16 x 16 and 2 x 16 x 16;
* ``roofline_terms`` on hand-computed statistics;
* one subprocess runs ``dryrun.run_cell`` on one cell of each family at
  full width on 16 x 16 (internlm2-1.8b decode_32k, mamba2-1.3b
  long_500k, recurrentgemma-9b prefill_32k, dbrx-132b train_4k,
  deepseek-v2-236b decode_32k, hubert-xlarge train_4k) and on one cell
  on 2 x 16 x 16: each is ``ok`` with its record's bytes as above and
  internlm2-1.8b decode_32k's collectives are the hand count from the
  port's sharding rules; qwen1.5-32b decode_32k (40 heads over 16) fits
  on its rank with the most heads, whose cache holds 3/40 of the whole;
  the command line writes the reference's ``skipped`` records.
"""
import json
import math
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES
from repro.configs import skip_reason as ref_skip_reason
from repro.models import model as RM
from repro.parallel import sharding as RS
from repro.train import optim as RO
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, '..', 'src')

MESHES = {False: {'data': 16, 'model': 16}, True: {'pod': 2, 'data': 16, 'model': 16}}

#: one cell of each family on 16 x 16, and one on 2 x 16 x 16
CELLS = [('internlm2-1.8b', 'decode_32k', False), ('mamba2-1.3b', 'long_500k', False),
         ('recurrentgemma-9b', 'prefill_32k', False), ('dbrx-132b', 'train_4k', False),
         ('deepseek-v2-236b', 'decode_32k', False), ('hubert-xlarge', 'train_4k', False),
         ('internlm2-1.8b', 'decode_32k', True), ('qwen1.5-32b', 'decode_32k', False)]


class _MeshShape:
    """What the reference's ``make_rules`` reads of a mesh: its ``.shape``."""

    def __init__(self, shape):
        self.shape = shape


def _ref_rank_bytes(tree, axes, rules, shape):
    leaves = jax.tree.leaves(tree)
    ax = jax.tree.leaves(axes, is_leaf=lambda a: isinstance(a, tuple))
    assert len(leaves) == len(ax)
    total = 0
    for leaf, a in zip(leaves, ax):
        spec = RS.spec_for(rules, leaf.shape, a)
        cut = [math.prod(shape[m] for m in ((s,) if isinstance(s, str) else s or ()))
               for s in tuple(spec) + (None,) * (len(leaf.shape) - len(spec))]
        total += math.prod(d // c for d, c in zip(leaf.shape, cut)) * leaf.dtype.itemsize
    return total


def _ref_bytes(arch, multi_pod, mode):
    """(params, opt) bytes of one rank under the reference's rules."""
    cfg = REF_ARCHS[arch]
    shape = MESHES[multi_pod]
    rules = RS.make_rules(_MeshShape(shape), mode=mode)
    p_abs, p_axes = RM.abstract_params(cfg), RM.param_axes(cfg)
    params = _ref_rank_bytes(p_abs, p_axes, rules, shape)
    opt = _ref_rank_bytes(RO.abstract_opt(p_abs), RO.opt_axes(p_axes), rules, shape)
    return params, opt


@pytest.mark.parametrize('arch', list(ARCHS))
def test_model_flops_match_the_reference_formula(arch):
    n = RM.active_param_count(REF_ARCHS[arch])
    for name, shape in SHAPES.items():
        ref = REF_SHAPES[name]
        want = {'train': 6.0 * n * ref.global_batch * ref.seq_len,
                'prefill': 2.0 * n * ref.global_batch * ref.seq_len,
                'decode': 2.0 * n * ref.global_batch}[ref.kind]
        assert dryrun.model_flops(get_config(arch), shape) == want, name


@pytest.mark.parametrize('multi_pod', [False, True], ids=['16x16', '2x16x16'])
@pytest.mark.parametrize('arch', list(ARCHS))
def test_rank_bytes_match_the_reference_specs(arch, multi_pod):
    """The dry run's blocks (``dryrun.rank_blocks``) under the port's
    rules on the production shape, against the reference's."""
    mesh = _MeshShape(MESHES[multi_pod])
    for mode in ('serve', 'train'):
        params, opt = (dryrun._nbytes(t) for t in dryrun.rank_blocks(get_config(arch), mesh,
                                                                       mode))
        ref_params, ref_opt = _ref_bytes(arch, multi_pod, mode)
        assert params == ref_params, mode
        assert opt == ref_opt, mode


def test_roofline_terms_on_hand_stats():
    stats = {'dot_flops_by_dtype': {'bfloat16': 989e12 * 0.5, 'float32': 67e12 * 0.25},
             'hbm_bytes_proxy': 3.35e12 * 0.5,
             'collective_wire_by_link': {'all-reduce': {'infiniband': 50e9 * 0.125},
                                         'all-gather': {'nvlink': 450e9 * 1.0,
                                                        'infiniband': 50e9 * 0.5}}}
    r = dryrun.roofline_terms(stats)
    assert r['compute_s'] == pytest.approx(0.75)
    assert r['memory_s'] == pytest.approx(0.5)
    assert r['collective_s_by_kind'] == pytest.approx({'all-reduce': 0.125, 'all-gather': 1.5})
    assert r['collective_s'] == pytest.approx(1.625)
    assert r['dominant'] == 'collective_s' and r['bound_s'] == pytest.approx(1.625)
    assert r['fraction_of_bound']['compute_s'] == pytest.approx(0.75 / 1.625)
    assert r['mem_bytes_est'] == stats['hbm_bytes_proxy']
    assert dryrun.link_of(range(8, 16)) == 'nvlink'
    assert dryrun.link_of(range(0, 16)) == dryrun.link_of((0, 16)) == 'infiniband'


RUN_CELLS = r'''
import sys
from repro_torch.launch import dryrun
dryrun.init_fake_world(512)
for arch, shape, multi in CELLS:
    dryrun.run_cell(arch, shape, multi, out_dir=sys.argv[1])
'''


@pytest.fixture(scope='module')
def records(tmp_path_factory):
    """The cells' records, the two train cells in a second process beside
    the others (each holds its own fake group; about 20 s each)."""
    out = tmp_path_factory.mktemp('dryrun')
    env = dict(os.environ, PYTHONPATH=SRC)
    groups = ([c for c in CELLS if SHAPES[c[1]].kind == 'train'],
              [c for c in CELLS if SHAPES[c[1]].kind != 'train'])
    procs = [subprocess.Popen([sys.executable, '-c', f'CELLS = {g!r}\n' + RUN_CELLS, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for g in groups]
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log
    recs = {}
    for arch, shape, multi in CELLS:
        tag = 'multipod_2x16x16' if multi else 'pod_16x16'
        with open(out / f'{tag}__{arch}__{shape}.json') as fh:
            recs[arch, shape, multi] = json.load(fh)
    return recs


@pytest.mark.parametrize('cell', CELLS, ids=['{}-{}-{}'.format(a, s, 'multi' if m else 'single')
                                             for a, s, m in CELLS])
def test_cell_runs_at_full_width(records, cell):
    arch, shape, multi = cell
    rec = records[cell]
    reason = ref_skip_reason(REF_ARCHS[arch], REF_SHAPES[shape])
    if reason:
        assert rec['status'] == 'skipped' and rec['skip_reason'] == reason
        return
    assert rec['status'] == 'ok', rec.get('error')
    assert rec['n_chips'] == (512 if multi else 256)
    assert rec['hlo']['num_partitions'] == rec['n_chips']
    kind = SHAPES[shape].kind
    assert rec['microbatches'] == (4 if kind == 'train' else 1)
    ref_params, ref_opt = _ref_bytes(arch, multi, 'train' if kind == 'train' else 'serve')
    mem = rec['memory']
    assert mem['by_role']['params'] == ref_params
    if kind == 'train':
        assert mem['by_role']['opt'] == ref_opt
    assert mem['argument_size_in_bytes'] == sum(mem['by_role'].values())
    assert mem['by_role']['batch'] == mem['batch_block_bytes']
    assert mem['batch_block_bytes'] <= mem['batch_whole_bytes']
    assert mem['fits_80gib'] == (mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']
                                 <= 80 * 2 ** 30)
    assert rec['model_flops'] == dryrun.model_flops(get_config(arch), SHAPES[shape])
    roof = rec['roofline']
    assert roof['bound_s'] == max(roof['compute_s'], roof['memory_s'], roof['collective_s']) > 0
    assert rec['hlo']['dot_flops'] > 0 and rec['hlo']['collective_bytes_total'] > 0


def test_internlm2_decode_collectives_are_the_hand_count(records):
    """Decode on 16 x 16 under the serve rules, a layer: the attention
    output's and the MLP's row-parallel sums (two all-reduces); the 8 kv
    heads do not divide 'model', so ``wk`` and ``wv`` are gathered at use
    (two all-gathers). Once: the vocab-parallel embedding's sum, and the
    logits gathered over 'model' (the vocabulary) and over 'data' (the
    batch)."""
    cfg = get_config('internlm2-1.8b')
    L, tp = cfg.num_layers, 16
    assert cfg.num_kv_heads % tp and cfg.vocab_size % tp == 0 and cfg.num_heads % tp == 0
    for multi in (False, True):
        counts = records['internlm2-1.8b', 'decode_32k', multi]['hlo']['collective_counts']
        assert counts == {'all-reduce': 2 * L + 1, 'all-gather': 2 * L + 2}, multi


def test_uneven_heads_cell_holds_its_own_kv_heads(records):
    """qwen1.5-32b decode_32k on 16 x 16: 40 heads over 16 'model' ranks,
    2 or 3 a rank (``attention.head_range``). The cell is ``ok`` and fits
    80 GiB on rank 0 and on the rank with the most heads, whose step is
    counted too, and each rank's cache is its heads' share of the whole:
    3/40 on the largest, 2/40 on rank 0."""
    rec = records['qwen1.5-32b', 'decode_32k', False]
    assert rec['status'] == 'ok', rec.get('error')
    cfg, shape = get_config('qwen1.5-32b'), SHAPES['decode_32k']
    heads = rec['heads']
    assert heads['rank0'] == {'model_index': 0, 'q_heads': 2, 'kv_heads': 2}
    most = heads['most']
    assert (most['model_index'], most['q_heads'], most['kv_heads']) == (1, 3, 3)
    itemsize = torch.empty((), dtype=cfg.cache_dtype).element_size()
    whole = (cfg.num_layers * 2 * (shape.global_batch // 16) * shape.seq_len * cfg.num_kv_heads
             * cfg.head_dim * itemsize)              # a data row's cache, every head
    assert most['memory']['by_role']['caches'] * cfg.num_heads == whole * 3
    assert rec['memory']['by_role']['caches'] * cfg.num_heads == whole * 2
    assert most['memory']['fits_80gib'] and rec['memory']['fits_80gib_rank0']
    assert rec['memory']['fits_80gib']
    assert most['memory']['by_role']['params'] == rec['memory']['by_role']['params']


def test_command_line_writes_skipped_records(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, '-m', 'repro_torch.launch.dryrun', '--arch',
                        'hubert-xlarge,codeqwen1.5-7b', '--shape', 'decode_32k,long_500k',
                        '--mesh', 'both', '--out', str(tmp_path)], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 8
    for name in names:
        with open(tmp_path / name) as fh:
            rec = json.load(fh)
        reason = ref_skip_reason(REF_ARCHS[rec['arch']], REF_SHAPES[rec['shape']])
        if reason:
            assert rec['status'] == 'skipped' and rec['skip_reason'] == reason
        else:
            assert rec['status'] == 'ok'
        assert name == f"{rec['mesh']}__{rec['arch']}__{rec['shape']}.json"
