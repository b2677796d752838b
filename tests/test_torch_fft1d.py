"""Port parity: the plain PyTorch pencils against ``repro.core.fft1d``.

The same numpy inputs (from a seed) go through the JAX function and its
port on the CPU, for pow2 n in 2..1024 with leading batch dims, forward
and inverse.

Tolerances:
* Stockham against the reference run op by op: bitwise. The port runs
  the reference's float ops in the same order on the same fp32 tables,
  and neither side contracts them into FMAs. Op by op costs JAX one
  compile per op and shape (3.4 s at n = 128), so this runs at n in
  NS_BITWISE; the other lengths compare with the reference under
  ``jax.jit``, where XLA contracts products into FMAs, at RTOL.
* four-step (reference under ``jax.jit``) and direct DFT:
  max |port - ref| <= 2e-6 * max |ref|. Both sum fp32 products of <= 32
  terms per factor (n terms for direct), in a different order (einsum
  vs matmul); the observed gap is <= 3.3e-7.

Most of this file's time is XLA compiling the reference once per n and
direction (about 0.5 s for a jitted Stockham of 1024).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fft1d as jf
from repro_torch.core import fft1d as tf

RTOL = 2e-6
NS = [1 << k for k in range(1, 11)]
NS_BITWISE = (2, 16)
RNG = np.random.default_rng(11)


def _planar(shape):
    return (RNG.standard_normal(shape).astype(np.float32),
            RNG.standard_normal(shape).astype(np.float32))


def _rel(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    return (max(np.abs(g - w).max() for g, w in zip(got, want))
            / max(np.abs(w).max() for w in want))


def _both(x):
    return [torch.from_numpy(a) for a in x], [jnp.asarray(a) for a in x]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", NS)
def test_stockham(n, inverse):
    t, j = _both(_planar((3, 2, n)))
    got = tf.fft_stockham(*t, inverse=inverse)
    if n in NS_BITWISE:
        want = jf.fft_stockham(*j, inverse=inverse)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        want = jax.jit(functools.partial(jf.fft_stockham, inverse=inverse))(*j)
        assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", NS)
def test_four_step(n, inverse):
    t, j = _both(_planar((3, 2, n)))
    want = jax.jit(functools.partial(jf.fft_four_step, inverse=inverse))(*j)
    assert _rel(tf.fft_four_step(*t, inverse=inverse), want) <= RTOL


@pytest.mark.parametrize("n", [4, 12, 64])
def test_direct(n):
    t, j = _both(_planar((5, n)))
    for inverse in (False, True):
        assert _rel(tf.dft_direct(*t, inverse=inverse),
                    jf.dft_direct(*j, inverse=inverse)) <= RTOL


@pytest.mark.parametrize("n", [12, 64])
def test_direct_is_batch_invariant(n):
    """A pencil's bits do not depend on the pencils batched with it: the
    whole batch (three blocks of ``DIRECT_ROWS``, the last one padded)
    against slices that start and end inside blocks, and against a
    chunk taken along a leading axis."""
    rows = 2 * tf.DIRECT_ROWS + 37
    t = tuple(torch.from_numpy(a) for a in _planar((rows, n)))
    for inverse in (False, True):
        whole = tf.dft_direct(*t, inverse=inverse)
        for a, b in ((0, 1), (100, 5000), (tf.DIRECT_ROWS - 1, tf.DIRECT_ROWS + 1),
                     (rows - 40, rows)):
            part = tf.dft_direct(t[0][a:b], t[1][a:b], inverse=inverse)
            assert all(torch.equal(p, w[a:b]) for p, w in zip(part, whole)), (a, b)
        cube = tuple(x[:rows - 37].reshape(8, -1, n) for x in t)
        part = tf.dft_direct(cube[0][:, 3:5], cube[1][:, 3:5], inverse=inverse)
        ref = tuple(w[:rows - 37].reshape(8, -1, n)[:, 3:5] for w in whole)
        assert all(torch.equal(p, w) for p, w in zip(part, ref))


@pytest.mark.parametrize("fn", ['stockham', 'four_step'])
@pytest.mark.parametrize("twiddle", [False, True])
def test_twiddle_transpose(fn, twiddle):
    n, b = 64, 6
    t, j = _both(_planar((2, b, n)))
    w = _planar((b, n)) if twiddle else (None, None)
    tw_ = [None if a is None else torch.from_numpy(a) for a in w]
    jw = [None if a is None else jnp.asarray(a) for a in w]
    for inverse in (False, True):
        got = tf.fft_twiddle_transpose(*t, *tw_, inverse=inverse,
                                       fft_fn=getattr(tf, f'fft_{fn}'))
        want = jax.jit(functools.partial(
            jf.fft_twiddle_transpose, inverse=inverse,
            fft_fn=getattr(jf, f'fft_{fn}')))(*j, *jw)
        assert got[0].shape == (2, n, b)
        assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("n", [16, 256])
def test_against_numpy_and_roundtrip(n):
    """Independent oracle: np.fft.fft, and the exact 1/n inverse."""
    x = _planar((4, n))
    want = np.fft.fft(x[0] + 1j * x[1])
    t = [torch.from_numpy(a) for a in x]
    for fn in (tf.fft_stockham, tf.fft_four_step):
        yr, yi = fn(*t)
        got = yr.numpy() + 1j * yi.numpy()
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max() * np.log2(n)
        br, bi = fn(yr, yi, inverse=True)
        np.testing.assert_allclose(br.numpy(), x[0], atol=1e-5)
        np.testing.assert_allclose(bi.numpy(), x[1], atol=1e-5)
