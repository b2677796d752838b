"""Gradients through the port's plans, against ``jax.grad`` of the JAX
package.

The reference's plain tier differentiates: ``lax.all_to_all`` and
``lax.ppermute`` transpose, so the adjoint of a swap is the reverse swap.
The port's swaps hand their results to autograd through
``strategies._Swapped``, whose backward runs the same strategy with
``shard_pos`` and ``mem_pos`` exchanged, under the same wire format.

* On a gloo 2 x 2 mesh (``_torch_multirank_worker.py --suite grad``):
  the gradient of ``sum(c * |plan.forward(x)|^2)`` (16^3 complex,
  four_step, batch 2) and of ``sum(c * plan_op(...).apply(x, k)^2)``
  (16^3 real, one runtime factor) for ``comm`` in all_to_all, ppermute
  and hierarchical, with ``overlap_chunks=2`` and with an fp16 wire,
  held against ``jax.grad`` of the reference's plan and fused-operator
  executor (``kernel='reference'``) on one device with Auto axes, on the
  same numpy operands. The gradient of a global loss does not depend on
  the mesh. Tolerance, relative L2 over all ranks: 1e-5 for the native
  wire (fp32 products in another order; measured 2e-7 and 2e-6), 1e-2
  for fp16 (an 11-bit significand, one cast a swap in the forward and in
  the backward, as the reference's cast transposes to a cast; measured
  3e-5 and 3e-4).
* On one CPU rank: the reference's own check
  (``tests/test_spectral_op.py:352``): the gradient of a loss through a
  rank-1 ``plan_op`` with respect to its factor is finite and non-zero;
  a swap adds no autograd node unless its operand requires grad. (On
  the mesh, a real rank-1 plan's spectrum gather refuses gradients.)
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import repro_torch.fft as fft  # noqa: E402
from repro_torch.comm import strategies  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402
from _torch_multirank_worker import GRAD_CASES, GRAD_SHAPE, grad_operands  # noqa: E402

#: relative L2 of the gradient against jax.grad of the reference
GRAD_RTOL = {'native': 1e-5, 'fp16': 1e-2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _reference(path) -> None:
    """``jax.grad`` of the reference's plan and fused-operator executor on
    one device (Auto axes), on the worker's operands, by wire format."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.fft as rfft
    from repro.core.plan import PencilPlan
    from repro.fft import pencil as rpencil

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('x', 'y'))
    x, xr, k, c, cr = grad_operands()
    out = {}
    for wire in GRAD_RTOL:
        p = rfft.plan(GRAD_SHAPE, mesh, comm='all_to_all', method='four_step',
                      kernel='reference', wire_dtype=wire, donate=False)

        def loss(re, im, p=p):
            yr, yi = p.forward((re, im))
            return jnp.sum(c * (yr ** 2 + yi ** 2))
        gr, gi = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x.real),
                                                         jnp.asarray(x.imag))
        out[f'grad_plan_{wire}'] = np.asarray(gr) + 1j * np.asarray(gi)
        plan = PencilPlan(shape=GRAD_SHAPE, mesh=mesh, layout=('x', 'y', None), real=True,
                          method='four_step', kernel='reference', comm='all_to_all',
                          wire_dtype=wire)
        fn, _, _ = rpencil.make_fused_op(plan, rfft.spectral_mul, batch_ndims=(1, 0))
        g = jax.jit(jax.grad(lambda a, fn=fn: jnp.sum(cr * fn(a, jnp.asarray(k)) ** 2)))(
            jnp.asarray(xr))
        out[f'grad_op_{wire}'] = np.asarray(g)
    np.savez(path, **out)


@pytest.fixture(scope='module')
def grads(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('grad')
    ref = tmp / 'reference.npz'
    _reference(ref)
    out = tmp / 'grad.json'
    subprocess.run([sys.executable, os.path.join(HERE, '_torch_multirank_worker.py'),
                    str(out), str(_free_port()), '--suite', 'grad', '--ref', str(ref)],
                   check=True, timeout=300)
    import json
    with open(out) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name, kw", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
@pytest.mark.parametrize("what", ['l2_plan', 'l2_op'])
def test_gradient_matches_reference_on_2x2(grads, name, kw, what):
    r = grads[name]
    assert r['shape_ok']
    comm, chunks = kw['comm'], kw.get('overlap_chunks', 1)
    assert r['resolved'] == [comm, chunks, 'four_step', comm, chunks]
    assert r[what] <= GRAD_RTOL[kw.get('wire_dtype', 'native')]


def test_fp16_wire_gradient_differs_from_native(grads):
    """The fp16 wire's cotangents cross the wire in 16 bits: its gradient
    is not the native one's."""
    assert grads['grad_fp16']['l2_plan'] > GRAD_RTOL['native']


def test_rank1_real_gather_refuses_gradients(grads):
    """The real rank-1 plan's spectrum gather no longer refuses gradients:
    its backward hands each rank its own rows of the cotangent, so the
    gradient of a loss of the whole spectrum equals the one-rank plan's."""
    r = grads['grad_gather']
    assert not r['refused'] and r['shape_ok']
    assert r['l2_gather'] <= GRAD_RTOL['native']


# ---------------------------------------------------------------------------
# One CPU rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def mesh():
    return make_fft_mesh(1, 1, device='cpu')


@pytest.mark.parametrize("shape", [(4096,), (16, 32)])
def test_plan_op_factor_gradient_flows(mesh, shape):
    """The reference's check of the fftconv mixer (``tests/
    test_spectral_op.py:352``) on the port's ``plan_op``: the gradient
    of a loss through the operator with respect to its runtime factor
    is finite and non-zero."""
    rng = np.random.default_rng(3)
    op = fft.plan_op(shape, mesh, op=fft.spectral_mul, real=True, n_spectra=1)
    x = torch.as_tensor(rng.standard_normal((2,) + shape).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
    g, = torch.autograd.grad((op.apply(x, k) ** 2).sum(), k)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


@pytest.mark.parametrize("wire", ['native', 'fp16'])
def test_swap_adds_a_node_only_for_grad(mesh, wire):
    """Without an operand that requires grad the swap returns its result
    as it is; with one, the result carries the swap's backward, which on
    one rank is the identity (under the wire's casts)."""
    a2a = strategies.get('all_to_all')
    x = torch.randn(4, 8)
    y = strategies.swap_start_wire(a2a, x, mesh, 'x', shard_pos=0, mem_pos=1,
                                   wire_dtype=wire).wait()
    assert y.grad_fn is None
    xg = x.clone().requires_grad_()
    yg = strategies.swap_start_wire(a2a, xg, mesh, 'x', shard_pos=0, mem_pos=1,
                                    wire_dtype=wire).wait()
    assert type(yg.grad_fn).__name__ == '_SwappedBackward'
    assert torch.equal(yg.detach(), y)
    with torch.no_grad():
        assert strategies.swap_start_wire(a2a, xg, mesh, 'x', shard_pos=0, mem_pos=1,
                                          wire_dtype=wire).wait().grad_fn is None
    g, = torch.autograd.grad((yg * x).sum(), xg)
    want = x if wire == 'native' else x.to(torch.float16).float()
    assert torch.equal(g, want)


def test_plan_gradient_on_one_rank_matches_parseval(mesh):
    """sum |fftn(x)|^2 = N sum |x|^2, so its gradient is 2 N x, through
    the serial and the chunked schedule alike."""
    x = torch.randn((2,) + GRAD_SHAPE, dtype=torch.complex64).requires_grad_()
    n = float(np.prod(GRAD_SHAPE))
    for chunks in (1, 2):
        p = fft.plan(GRAD_SHAPE, mesh, comm='all_to_all', overlap_chunks=chunks)
        g, = torch.autograd.grad((p.forward(x).abs() ** 2).sum(), x)
        want = 2 * n * x.detach()
        rel = float(torch.linalg.vector_norm(g - want) / torch.linalg.vector_norm(want))
        assert rel <= 1e-5
