"""Plans whose pencils are longer than 4096, through the facade, against
the JAX plan: ``repro_torch.fft.plan`` at (8192, 16) and (16, 65536)
under 'auto', 'stockham' and 'block', forward and inverse, against
``repro.fft.plan`` on a one-device ``jax.sharding.Mesh`` (Auto axes, as
``tests/_torch_jax_reference.py`` builds its meshes) and ``np.fft.fftn``
in float64. On the CPU both run their plain tiers; on the card these
lengths run the long body of all four kernels
(``tests/test_torch_long_pencils.py``, ``chip_smoke.py``'s ``[long]``).

Tolerance: relative L2 <= 1e-6 (both fp32, two pencil passes, summed in
other orders; the same limit as ``tests/test_torch_large1d.py``). The
reference's 'block' plan at (16, 65536) folds the twiddle into a (2,
256, 256, 2, 256) constant, about ten seconds a direction on the CPU.

Inputs come from a numpy seed.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fft as jfft
import repro_torch.fft as tfft
from repro_torch.launch.mesh import make_fft_mesh

RTOL = 1e-6
RNG = np.random.default_rng(35)
CASES = list(itertools.product(((8192, 16), (16, 65536)), ('auto', 'stockham', 'block')))


@pytest.fixture(scope='module')
def meshes():
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('x', 'y'))
    return jmesh, make_fft_mesh(1, 1, device='cpu')


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("shape, method", CASES,
                         ids=[f"{s[0]}x{s[1]}-{m}" for s, m in CASES])
def test_plan_matches_reference(meshes, shape, method):
    jmesh, tmesh = meshes
    x = (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(np.complex64)
    jp = jfft.plan(shape, jmesh, method=method, donate=False)
    tp = tfft.plan(shape, tmesh, method=method)
    assert tp.method == jp.method
    jy = np.array(jp.forward(jnp.asarray(x)))
    ty = tp.forward(torch.from_numpy(x)).numpy()
    assert _rel(ty, jy) <= RTOL
    assert _rel(ty, np.fft.fftn(x.astype(np.complex128))) <= RTOL
    jx = np.asarray(jp.inverse(jnp.asarray(jy)))
    tx = tp.inverse(torch.from_numpy(jy)).numpy()
    assert _rel(tx, jx) <= RTOL
    assert _rel(tx, np.fft.ifftn(jy.astype(np.complex128))) <= RTOL
