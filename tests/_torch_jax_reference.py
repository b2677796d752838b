"""The JAX package's results for the port's mesh cases of ``pod`` and
``op`` (``tests/_torch_multirank_worker.py``), on four fake host devices.

Run in a subprocess, so the test process keeps one device:

    python tests/_torch_jax_reference.py OUT.npz

For each case of ``POD_CASES`` it runs ``repro.fft.plan(...,
batch_spec='pod')`` on a ('pod', 'x', 'y') mesh of 2 x 1 x 2, and for
each case of ``OP_CASES`` the reference's executors under ``jax.jit``
(``pencil.make_fused_op`` on 2 x 2, ``large1d.make_fourstep_op`` on
1 x 4; the reference's ``plan_op(...).apply`` does not run on the
installed jax), on the worker's global operands, with Auto axes
(``jax.sharding.Mesh``). It writes each case's global result under the
case's name.
"""
import os
import sys

os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, '..', 'src'))
sys.path.insert(0, HERE)

import repro.fft as fft  # noqa: E402
from repro.core.plan import PencilPlan  # noqa: E402
from repro.fft import large1d, pencil  # noqa: E402
from _torch_multirank_worker import BATCH, OP_CASES, POD_BATCH, POD_CASES, operands  # noqa: E402


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:4]).reshape(shape), names)


def pod_results():
    mesh = _mesh((2, 1, 2), ('pod', 'x', 'y'))
    out = {}
    for name, shape, kw in POD_CASES:
        kw = dict(kw)
        real = kw.pop('real', False)
        x = operands(shape, real, POD_BATCH, 3)
        p = fft.plan(shape, mesh, batch_spec='pod', comm='all_to_all', kernel='reference',
                     real=real, donate=False, **kw)
        out[name] = np.asarray(p.forward(jnp.asarray(x)))
    return out


def op_results():
    out = {}
    for mesh_name, cases in OP_CASES.items():
        rows, cols = (int(v) for v in mesh_name.split('x'))
        mesh = _mesh((rows, cols), ('x', 'y'))
        for name, shape, kw in cases:
            real = kw['real']
            x, k = operands(shape, real, BATCH, 5), operands(shape, real, 0, 6)
            common = dict(method=kw['method'], kernel='reference', comm='all_to_all')
            if len(shape) == 1:
                n1 = n2 = int(np.sqrt(shape[0]))
                fn = large1d.make_fourstep_op(n1, n2, mesh, ('x', 'y'), fft.spectral_mul,
                                              real=real, batch_ndims=(1, 0), **common)
                x, k = x.reshape(BATCH, n1, n2), k.reshape(n1, n2)
            else:
                plan = PencilPlan(shape=shape, mesh=mesh, layout=('x', 'y', None),
                                  real=real, **common)
                fn, _, _ = pencil.make_fused_op(plan, fft.spectral_mul, batch_ndims=(1, 0))
            args = (x, k) if real else (x.real, x.imag, k.real, k.imag)
            y = jax.jit(fn)(*(jnp.asarray(a) for a in args))
            y = np.asarray(y) if real else np.asarray(y[0]) + 1j * np.asarray(y[1])
            out[name] = y.reshape((BATCH,) + tuple(shape))
    return out


if __name__ == '__main__':
    np.savez(sys.argv[1], **pod_results(), **op_results())
