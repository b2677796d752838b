"""The radix-8 Stockham body of ``fft_pencil`` and ``fft_twiddle_transpose``,
on the CPU.

``radix8_pencil_kernel`` and ``radix8_fused_kernel``
(``src/repro_torch/csrc/fft_pencil.cu``) run only on the card. These
tests hold what they are given and what they compute:

* the body is chosen by the pencil length alone, for n = 2..4096;
* the pass plan: radix-8 passes, the first pass 2 or 4 where log2 n is
  not a multiple of 3;
* the per-pass twiddle table equals numpy's roots of unity rounded to
  fp32, entry by entry;
* the layout functions, for every n and b in {1, 3, 29, 37, 512}: at
  most 1024 threads and 232,448 shared bytes a block, P a power of two,
  and the fused kernel's transposed runs at least 8 floats whenever
  b >= 8 and n <= 1024 (at n = 2048 and 4096 eight pencils would need
  8 * n/8 > 1024 threads; there the runs are 1024 / (n/8) floats);
* every exchange and the fused kernel's staging are free of shared-memory
  bank conflicts at the main path's layouts;
* the torch emulation of the kernels (``tests/_torch_stockham_emulation.py``)
  on a ragged batch of 37 pencils and on (3, 29, n) rows, with and
  without a twiddle, forward and inverse, for every n = 2..4096, is
  within ``RTOL`` = 2e-6 x max|ref| (the tolerance of
  ``tests/test_torch_kernels.py``) of the plain versions and of the JAX
  package's Pallas kernels in interpret mode: both sides fp32, the
  butterflies summed in another order.

Inputs come from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_fused as jkf
from repro.kernels import fft_pencil as jkp
from repro_torch.kernels import fft_fused as tkf
from repro_torch.kernels import fft_pencil as tkp

from _torch_stockham_emulation import emulate_fused, emulate_pencil, swizzle

RTOL = 2e-6
LENGTHS = [1 << k for k in range(1, 13)]
BATCHES = [1, 3, 29, 37, 512]
SMEM_MAX = 232448
RNG = np.random.default_rng(16)


def _planar(shape):
    return [RNG.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _rel(got, want):
    return (max(float(np.abs(np.asarray(g) - np.asarray(w)).max()) for g, w in zip(got, want))
            / max(float(np.abs(np.asarray(w)).max()) for w in want))


@pytest.mark.parametrize("n", [1] + LENGTHS + [8192])
def test_variant_is_radix8_from_2_to_4096(n):
    """Above 4096 the long body runs (``tests/test_torch_long_pencils.py``);
    the radix-2 body only n = 1."""
    want = 'radix8' if 2 <= n <= 4096 else 'long' if n > 4096 else 'radix2'
    assert tkp.variant(n) == tkf.variant(n) == want


@pytest.mark.parametrize("n", LENGTHS)
def test_pass_plan(n):
    radices = tkp.radix8_passes(n)
    assert int(np.prod(radices)) == n
    assert len(radices) == -(-tkp.tw.log2i(n) // 3)
    assert all(r == 8 for r in radices[1:]) and radices[0] in (2, 4, 8)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_tables_are_numpy_roots_in_fp32(n, inverse):
    """Entry (Ns - 1) + (m - 1) Ns + k holds w_{Ns r}^{k m} of the
    direction's sign, numpy's float64 root rounded to fp32."""
    tr, ti = tkp.radix8_tables_np(n, inverse)
    assert tr.dtype == ti.dtype == np.float32 and tr.shape == (max(n - 1, 1),)
    sign = 1.0 if inverse else -1.0
    ns = 1
    for r in tkp.radix8_passes(n):
        k = np.arange(ns)
        for m in range(1, r):
            want = np.exp(sign * 2j * np.pi * ((k * m) % (ns * r)) / (ns * r))
            idx = ns - 1 + (m - 1) * ns + k
            np.testing.assert_array_equal(tr[idx], want.real.astype(np.float32))
            np.testing.assert_array_equal(ti[idx], want.imag.astype(np.float32))
        ns *= r


@pytest.mark.parametrize("n", LENGTHS)
def test_layouts_fit_a_block(n):
    T = tkp.radix8_threads(n)
    for b in BATCHES:
        for fused, (P, threads, smem) in ((False, tkp.radix8_layout(n, b)),
                                          (True, tkf.tile_layout(n, b))):
            assert P & (P - 1) == 0 and threads == P * T <= 1024
            assert smem == tkp.radix8_smem_bytes(n, P, fused) <= SMEM_MAX
            assert P < 2 * b                       # no more pencils than the batch needs
        P = tkf.tile_layout(n, b)[0]
        run = min(P, b)
        assert run >= min(8, b, 1024 // T)
        if n <= 1024 and b >= 8:
            assert run >= 8                        # whole 32-byte sectors


def _degree(addrs):
    """Shared-memory wavefronts one warp's access takes: the most distinct
    addresses that fall in one bank."""
    banks = {}
    for a in addrs:
        banks.setdefault(a % 32, set()).add(a)
    return max(len(v) for v in banks.values())


@pytest.mark.parametrize("n", [n for n in LENGTHS if n >= 16])
def test_exchanges_and_staging_are_free_of_bank_conflicts(n):
    """Every warp of a block, at the main path's layouts (262,144 pencils;
    rows of 512), writes and reads each exchange and the fused kernel's
    staging rows in one wavefront."""
    R0, T = min(8, n), tkp.radix8_threads(n)
    ld = n + (T if T < 32 else 0)
    P = tkp.radix8_layout(n, 262144)[0]
    warps = [range(w, w + 32) for w in range(0, P * T, 32)]
    radices = tkp.radix8_passes(n)
    ns = 1
    for r in radices[:-1]:
        G = R0 // r
        for g in range(G):
            for q in range(r):
                for warp in warps:
                    addrs = []
                    for tid in warp:
                        tp = tid % T + T * g
                        i = (tp // ns) * ns * r + tp % ns + q * ns
                        addrs.append(tid // T * ld + int(swizzle(np.int64(i), ns, r)))
                    assert _degree(addrs) == 1, ('write', n, ns, g, q)
        for j in range(R0):
            for warp in warps:
                addrs = [tid // T * ld + int(swizzle(np.int64(tid % T + T * j), ns, r))
                         for tid in warp]
                assert _degree(addrs) == 1, ('read', n, ns, j)
        ns *= r
    P = tkf.tile_layout(n, 512)[0]
    if n >= 256 and P * T >= 32:
        lds = n + 32 // P
        for j in range(R0):
            for w in range(0, P * T, 32):
                assert _degree([tid // T * lds + tid % T + T * j
                                for tid in range(w, w + 32)]) == 1
        for w in range(0, P * n, 32):
            assert _degree([(i % P) * lds + i // P for i in range(w, w + 32)]) == 1


@pytest.mark.parametrize("n", LENGTHS)
def test_pencil_emulation_matches_plain_and_pallas(n):
    x = _planar((37, n))
    xt = [torch.from_numpy(a) for a in x]
    for inverse in (False, True):
        got = emulate_pencil(*xt, inverse=inverse)
        assert all(torch.isfinite(g).all() for g in got)
        assert _rel(got, tkp.fft_pencil_plain(*xt, inverse=inverse)) <= RTOL
        want = jkp.fft_pencil(*(jnp.asarray(a) for a in x), inverse=inverse, interpret=True)
        assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("twiddle", [False, True, 'shared'])
@pytest.mark.parametrize("n", LENGTHS)
def test_fused_emulation_matches_plain_and_pallas(n, twiddle):
    """Rows (3, 29, n): the last tile of each slice is ragged. The
    twiddle is one a slice (3, 29, n), or one (29, n) plane that the 3
    slices share, as rank 1's is, which the wrapper passes in place at
    a slice stride of 0."""
    x = _planar((3, 29, n))
    w = {False: [None, None], True: _planar((3, 29, n)), 'shared': _planar((29, n))}[twiddle]
    xt = [torch.from_numpy(a) for a in x]
    wt = [None if a is None else torch.from_numpy(a) for a in w]
    if twiddle:
        assert tkf._twiddle_planes(xt[0], *wt)[2] == (0 if twiddle == 'shared' else 29 * n)
    for inverse in (False, True):
        got = emulate_fused(*xt, *wt, inverse=inverse)
        assert got[0].shape == (3, n, 29)
        assert all(torch.isfinite(g).all() for g in got)
        assert _rel(got, tkf.fft_twiddle_transpose_plain(*xt, *wt, inverse=inverse)) <= RTOL
        want = jkf.fft_twiddle_transpose(
            *(jnp.asarray(a) for a in x), *(None if a is None else jnp.asarray(a) for a in w),
            inverse=inverse, interpret=True)
        assert _rel(got, want) <= RTOL
