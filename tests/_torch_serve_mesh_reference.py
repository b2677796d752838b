"""The JAX package's results for the requests that
``tests/_torch_serve_mesh_worker.py`` serves, on four fake host devices.

Run in a subprocess, so the test process keeps one device:

    python tests/_torch_serve_mesh_reference.py OUT.npz

Each request of the worker's stream (``stream_requests``) and of its
tenants' streams (``tenant_stream``) goes through ``repro.fft.plan`` /
``rplan`` on a 2 x 2 ('x', 'y') ``jax.sharding.Mesh`` with Auto axes
(``jax.make_mesh`` breaks ``rplan`` on the installed jax), a planar
request as its complex value; the operator requests through the
reference's fused executor (``pencil.make_fused_op`` under ``jax.jit``;
``plan_op(...).apply`` does not run on the installed jax). It writes
each global result under the worker's key.
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
from repro.fft import pencil  # noqa: E402
from _torch_serve_mesh_worker import (  # noqa: E402
    KINDS, OP_SHAPE, TENANTS, op_factor, stream_requests, tenant_stream)


def results():
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ('x', 'y'))
    plans = {}

    def plan(shape, real):
        key = (shape, real)
        if key not in plans:
            plans[key] = (fft.rplan(shape, mesh) if real
                          else fft.plan(shape, mesh, donate=False))
        return plans[key]

    def call(kind, shape, x):
        direction, real, _, _ = KINDS[kind]
        if isinstance(x, tuple):
            x = (x[0] + 1j * x[1]).astype(np.complex64)
        p = plan(shape, real)
        fn = p.forward if direction == 'fwd' else p.inverse
        return np.asarray(fn(jnp.asarray(x)))

    out = {}
    stream = stream_requests()
    ops = [i for i, (kind, _, _) in enumerate(stream) if kind == 'op']
    for i, (kind, shape, x) in enumerate(stream):
        if kind != 'op':
            out[f'stream_{i}'] = call(kind, shape, x)
    op_plan = PencilPlan(shape=OP_SHAPE, mesh=mesh, layout=('x', 'y', None), real=True,
                         method='stockham', kernel='reference', comm='all_to_all')
    fn, _, _ = pencil.make_fused_op(op_plan, fft.spectral_mul, batch_ndims=(1, 0))
    ys = np.asarray(jax.jit(fn)(jnp.asarray(np.stack([stream[i][2] for i in ops])),
                                jnp.asarray(op_factor())))
    out.update({f'stream_{i}': y for i, y in zip(ops, ys)})
    for name, seed in TENANTS:
        for i, (kind, shape, x) in enumerate(tenant_stream(seed)):
            out[f'service_{name}_{i}'] = call(kind, shape, x)
    return out


if __name__ == '__main__':
    np.savez(sys.argv[1], **results())
