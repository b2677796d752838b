"""The JAX package's results for the port's comm surface and sharded LM
server (``tests/_torch_lm_multirank_worker.py``), on four fake host
devices with Auto axes (``jax.sharding.Mesh``, never ``jax.make_mesh``).

Run in a subprocess, so the test process keeps one device:

    python tests/_torch_lm_jax_reference.py OUT.npz comm|lm|ops|train [GROUP]

* ``comm``: ``repro.comm.swap_axes``, ``apply_swap``, ``redistribute``
  and ``pod_fold`` under ``shard_map`` for every registered strategy on
  the worker's cases, and ``group_index`` / ``group_size`` of each axis,
  on ('x', 'y') meshes of 2 x 2 and 1 x 4.
* ``lm``: ``repro.serve.ServeEngine`` on ('data', 'model') meshes of 2 x 2
  and 1 x 4 for each of the worker's configs (the port's parameters,
  carried across by ``repro_torch.weights``): the greedy tokens and the
  logits of prefill and each decode step.
* ``ops``: ``ulysses_attention`` and ``moe_ep_explicit`` on the same
  meshes.
* ``train``: ``repro.train.trainstep.jit_train_step`` on each case of
  the worker's ``TRAIN_CASES[GROUP]`` (its mesh of 2 x 2, 1 x 4 or
  4 x 1, the port's whole parameters carried across, the worker's
  batches): each step's loss, ce, aux and grad norm, and the parameters
  and optimizer state after it. The FFT-conv LM's mesh path cannot run
  on jax 0.9 (ROADMAP queue 3): the worker holds it against the
  one-rank port instead.

Each result is written under ``<mesh>/<case>``.
"""
import os
import sys

os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, '..', 'src'))
sys.path.insert(0, HERE)

from repro import comm  # noqa: E402
from repro.configs import get_config as ref_config, smoke_config as ref_smoke  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro.serve import ServeEngine  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.weights import params_to_reference  # noqa: E402
import _torch_lm_multirank_worker as W  # noqa: E402

MESHES = {'2x2': (2, 2), '1x4': (1, 4)}
TRAIN_MESHES = {'2x2': (2, 2), '1x4': (1, 4), '4x1': (4, 1)}


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:4]).reshape(shape), names)


def _run(fn, mesh, in_spec, out_spec, x):
    return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=(in_spec,),
                                        out_specs=out_spec))(x))


def comm_results():
    out = {}
    x = jnp.asarray(W.comm_operand())
    for name, shape in MESHES.items():
        mesh = _mesh(shape, ('x', 'y'))
        for st in comm.names():
            for case, lay, ax, mem in W.SWAP_CASES:
                def fn(t, ax=ax, lay=lay, mem=mem, st=st):
                    return comm.swap_axes(t, ax, shard_pos=lay.index(ax), mem_pos=mem,
                                          strategy=st)
                out[f'{name}/{st}/{case}'] = _run(fn, mesh, P(*lay),
                                                  P(*W.out_layout(lay, ax, mem)), x)
            for case, src, dst in W.REDIST_CASES:
                def fn(t, src=src, dst=dst, st=st):
                    return comm.redistribute(t, src, dst, strategy=st)
                out[f'{name}/{st}/{case}'] = _run(fn, mesh, P(*src), P(*dst), x)
        for case, lay, ax, pos in W.FOLD_CASES:
            def fn(t, ax=ax, pos=pos):
                return comm.pod_fold(t, ax, pos)
            out[f'{name}/{case}'] = _run(fn, mesh, P(*lay), P(*W.fold_layout(lay, ax)), x)
        for ax in W.GROUP_AXES:
            key = ax if isinstance(ax, str) else '+'.join(ax)
            ids = jnp.zeros((4,), jnp.int32)

            def index(t, ax=ax):
                return t + comm.group_index(ax)
            out[f'{name}/group_index/{key}'] = _run(index, mesh, P(('x', 'y')),
                                                    P(('x', 'y')), ids)

            def size(t, ax=ax):
                return t + comm.group_size(ax)
            out[f'{name}/group_size/{key}'] = _run(size, mesh, P(('x', 'y')),
                                                   P(('x', 'y')), ids)[0]
    return out


def lm_results():
    out = {}
    for arch in W.LM_ARCHS:
        cfg, rcfg = W.lm_config(arch), ref_smoke(ref_config(arch))
        rparams = tree_map(jnp.asarray, params_to_reference(W.lm_params(cfg)))
        prompts = {k: jnp.asarray(v) for k, v in W.lm_prompts(cfg).items()}
        S = W.PROMPTS.get(arch, W.PROMPT)
        for name, shape in MESHES.items():
            mesh = _mesh(shape, ('data', 'model'))
            with mesh:
                eng = ServeEngine(rcfg, mesh, rparams, batch=W.LM_BATCH, prompt_len=S,
                                  max_len=S + W.LM_STEPS, param_dtype=jnp.float32)
                logits, caches = eng.prefill(rparams, prompts)
                steps, toks = [np.asarray(logits[:, -1])], []
                for t in range(W.LM_STEPS):
                    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
                    toks.append(np.asarray(tok))
                    if t == W.LM_STEPS - 1:
                        break
                    logits, caches = eng.decode(rparams, caches, tok, jnp.int32(S + t))
                    steps.append(np.asarray(logits[:, -1]))
            out[f'{name}/{arch}/tokens'] = np.concatenate(toks, axis=1)
            out[f'{name}/{arch}/logits'] = np.stack(steps, axis=1)
    return out


def ops_results():
    out = {}
    for name, shape in MESHES.items():
        mesh = _mesh(shape, ('data', 'model'))
        for case, B, S, H, KH, D, chunks in W.ULYSSES_CASES:
            q, k, v = (jnp.asarray(a) for a in W.ulysses_operands(B, S, H, KH, D))
            o = jax.jit(lambda q, k, v, chunks=chunks: RA.ulysses_attention(
                q, k, v, mesh, batch_spec=P('data'), causal=True, chunk=W.ULYSSES_CHUNK,
                overlap_chunks=chunks))(q, k, v)
            out[f'{name}/{case}'] = np.asarray(o)
        for case, arch, chunks in W.MOE_CASES:
            cfg, p, x = W.moe_operands(arch)
            rcfg = ref_smoke(ref_config(arch))
            rp = tree_map(jnp.asarray, params_to_reference(p))
            y, _ = jax.jit(lambda p, x, chunks=chunks: RMoE.moe_ep_explicit(
                p, rcfg, x, mesh, batch_spec=P('data'), overlap_chunks=chunks))(rp,
                                                                             jnp.asarray(x))
            out[f'{name}/{case}'] = np.asarray(y)
    return out


def train_results(group: str):
    import dataclasses
    from repro.configs import input_specs as ref_input_specs
    from repro.configs.base import ShapeSpec as RefShapeSpec
    from repro.train import optim as RO
    from repro.train.trainstep import jit_train_step as ref_jit_train_step
    out = {}
    B, S = W.TRAIN_SHAPE
    for name, arch, mesh_name, sp in W.TRAIN_CASES[group]:
        if arch == 'fftconv':
            continue
        cfg = W.train_config(arch)
        rcfg = dataclasses.replace(ref_smoke(ref_config(arch)), remat=True)
        mesh = _mesh(TRAIN_MESHES[mesh_name], ('data', 'model'))
        sds, axes = ref_input_specs(rcfg, RefShapeSpec('train', 'train', S, B), jnp.float32)
        with mesh:
            step, aux = ref_jit_train_step(rcfg, mesh, sds, axes, param_dtype=jnp.float32,
                                           microbatches=W.TRAIN_MICRO, sp=sp, **W.TRAIN_KW)
            params = jax.device_put(tree_map(jnp.asarray, params_to_reference(W.lm_params(cfg))),
                                    aux['p_sh'])
            opt = jax.device_put(RO.adamw_init(params), aux['o_sh'])
            for k, batch in enumerate(W.train_batches(cfg)):
                b = jax.device_put({n: jnp.asarray(v) for n, v in batch.items()}, aux['b_sh'])
                params, opt, m = step(params, opt, b)
                for key in ('loss', 'ce', 'aux', 'grad_norm'):
                    out[f'{name}/step{k}/{key}'] = np.float64(m[key])
                out.update(W.flat_tree(jax.tree.map(np.asarray, params),
                                       f'{name}/step{k}/params'))
                out.update(W.flat_tree(jax.tree.map(np.asarray, opt), f'{name}/step{k}/opt'))
    return out


if __name__ == '__main__':
    suite = sys.argv[2]
    if suite == 'train':
        np.savez(sys.argv[1], **train_results(sys.argv[3]))
    else:
        np.savez(sys.argv[1], **{'comm': comm_results, 'lm': lm_results,
                                 'ops': ops_results}[suite]())
