"""Port parity for the kernel modules, and the wrappers' contract.

On the CPU each wrapper runs its plain PyTorch version; that version is
held against the JAX Pallas kernel it replaces, run in interpret mode,
on the same numpy inputs, with a ragged batch (not a multiple of the
Pallas block). The CUDA kernels themselves are compared with their plain
versions on the card by ``chip_smoke.py`` and by ``test_torch_cuda.py``,
which skips without a card.

Tolerance: max |port - ref| <= 2e-6 * max |ref|. Both sides are fp32; the
Pallas kernels read the Stockham master table at a stride and sum the
four-step products in another order than the port's plain versions
(observed gap <= 3.3e-7 for n <= 1024).
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_fused as jkf
from repro.kernels import fft_matmul as jkm
from repro.kernels import fft_pencil as jkp
from repro_torch import kernels
from repro_torch.fft import api, methods
from repro_torch.kernels import _build
from repro_torch.kernels import fft_block as tkb
from repro_torch.kernels import fft_fused as tkf
from repro_torch.kernels import fft_matmul as tkm
from repro_torch.kernels import fft_pencil as tkp
from repro_torch.launch.mesh import make_fft_mesh

RTOL = 2e-6
RNG = np.random.default_rng(5)


def _planar(shape):
    return (RNG.standard_normal(shape).astype(np.float32),
            RNG.standard_normal(shape).astype(np.float32))


def _rel(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert all(g.shape == w.shape for g, w in zip(got, want))
    return (max(np.abs(g - w).max() for g, w in zip(got, want))
            / max(np.abs(w).max() for w in want))


def _t(x):
    return [torch.from_numpy(a) for a in x]


def _j(x):
    return [jnp.asarray(a) for a in x]


@pytest.mark.parametrize("n, b", [(2, 17), (16, 1), (64, 17), (512, 1), (512, 17)])
def test_fft_pencil_vs_pallas(n, b):
    x = _planar((b, n))
    for inverse in (False, True):
        assert _rel(tkp.fft_pencil(*_t(x), inverse=inverse),
                    jkp.fft_pencil(*_j(x), inverse=inverse, interpret=True)) <= RTOL


@pytest.mark.parametrize("n, b", [(4, 17), (64, 1), (64, 17), (512, 17)])
def test_fft_matmul_vs_pallas(n, b):
    x = _planar((b, n))
    for inverse in (False, True):
        assert _rel(tkm.fft_matmul(*_t(x), inverse=inverse),
                    jkm.fft_matmul(*_j(x), inverse=inverse, interpret=True)) <= RTOL


@pytest.mark.parametrize("twiddle", [False, True])
@pytest.mark.parametrize("shape", [(11, 64), (2, 3, 17, 32)])
def test_fft_twiddle_transpose_vs_pallas(shape, twiddle):
    """Ragged batch (11 and 17 are not multiples of the Pallas block of
    8), leading dims, and a twiddle broadcast from (b, n)."""
    x = _planar(shape)
    w = _planar(shape[-2:]) if twiddle else (None, None)
    tw_ = [None if a is None else torch.from_numpy(a) for a in w]
    jw = [None if a is None else jnp.asarray(a) for a in w]
    for inverse in (False, True):
        got = tkf.fft_twiddle_transpose(*_t(x), *tw_, inverse=inverse)
        assert got[0].shape == shape[:-2] + (shape[-1], shape[-2])
        assert all(g.is_contiguous() for g in got)
        want = jkf.fft_twiddle_transpose(*_j(x), *jw, inverse=inverse,
                                         interpret=True)
        assert _rel(got, want) <= RTOL


def test_cpu_calls_build_and_count_nothing():
    """On the CPU the wrappers run their plain versions: no library is
    built or loaded and no launch is counted."""
    kernels.reset_launch_counts()
    x = _t(_planar((3, 4, 16)))
    tkp.fft_pencil(*x)
    tkm.fft_matmul(*x)
    tkf.fft_twiddle_transpose(*x)
    tkb.fft_block(torch.stack(x))
    tkb.fft_block_planar(*x)
    assert kernels.launch_counts() == {'fft_pencil': 0, 'fft_fused': 0, 'fft_matmul': 0,
                                       'fft_block': 0}
    assert _build._LIBS == {}


def test_kernel_modules_import_without_nvcc():
    """Importing the port (kernels included) runs no compiler: a fresh
    interpreter with no nvcc on PATH and a CUDA_HOME that does not exist
    imports every module and runs a CPU plan."""
    code = (
        "import torch, repro_torch.fft as fft\n"
        "from repro_torch.kernels import fft_pencil, fft_fused, fft_matmul, fft_block, _build\n"
        "from repro_torch.launch.mesh import make_fft_mesh\n"
        "p = fft.plan((8, 8, 8), make_fft_mesh(1, 1, device='cpu'))\n"
        "p.forward(torch.zeros(8, 8, 8, dtype=torch.complex64))\n"
        "assert _build._LIBS == {}\n")
    env = {'PATH': '/nonexistent', 'CUDA_HOME': '/nonexistent',
           'PYTHONPATH': 'src'}
    subprocess.run([sys.executable, '-c', code], check=True, env=env,
                   cwd=str(_build.CSRC.parents[2]), timeout=120)


@pytest.mark.parametrize("fn", [tkp.fft_pencil, tkm.fft_matmul, tkf.fft_twiddle_transpose,
                                tkb.fft_block_planar])
def test_wrapper_rejects_what_the_kernel_does_not_take(fn):
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        fn(x.double(), x.double())
    with pytest.raises(ValueError):
        fn(x.t(), x.t())                        # not contiguous
    with pytest.raises(ValueError):
        fn(torch.zeros(4, 6), torch.zeros(4, 6))  # not a power of two
    with pytest.raises(ValueError):
        fn(x, torch.zeros(4, 16))               # planes differ


def test_pallas_tier_raises_on_cpu():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="pallas"):
        methods.apply(x, x, kernel='pallas')
    with pytest.raises(ValueError, match="pallas"):
        methods.apply_fused(x, x, kernel='pallas', method='stockham')
    p = api.plan((8, 8, 8), make_fft_mesh(1, 1, device='cpu'), kernel='pallas')
    with pytest.raises(ValueError, match="pallas"):
        p.forward(torch.zeros(8, 8, 8, dtype=torch.complex64))
    # a method with no kernel runs its plain version under every tier
    methods.apply(torch.zeros(2, 6), torch.zeros(2, 6), kernel='pallas', method='direct')


def test_kernel_tier_resolution():
    st = methods.get('stockham')
    assert methods.resolve_kernel('auto', st, 'cpu') == 'reference'
    assert methods.resolve_kernel('auto', st, 'cuda') == 'pallas'
    assert methods.resolve_kernel('pallas', st, 'cuda') == 'pallas'
    assert methods.resolve_kernel('reference', st, 'cuda') == 'reference'
    assert methods.resolve_kernel('auto', methods.get('direct'), 'cuda') == 'reference'
    with pytest.raises(ValueError):
        methods.resolve_kernel('triton', st, 'cuda')
