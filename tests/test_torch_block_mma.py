"""The arithmetic of the tensor-core ``fft_block`` body, on the CPU.

``block_mma_kernel`` (``src/repro_torch/csrc/fft_block.cu``, the body of
``csrc/four_step_mma.cuh``) runs only on the card. These tests hold what it computes, from the tables it is given:

* the host's 3xTF32 split of F1b and the block F2
  (``core/fft1d.py:block_mma_tables``): TF32 values, round to nearest
  with ties away from zero as ``cvt.rna`` rounds, big + small equal to
  the fp32 table within one TF32 ulp of small;
* the twiddle applied between the two products followed by the block F2
  is the TPU kernel's G (within 1e-6: fp32 tables, float64 sums);
* the fragment order the kernel reads (``kernels/fft_block.py:frag_a``,
  ``frag_b``, ``mma_rows``) unpacks, by the m16n8k8 lane mapping, to
  the matrices;
* a torch emulation of the kernel's four-step
  (``tests/_torch_mma_emulation.py``: rna by bit operations,
  three passes small*big, big*small, big*big, fp32 sums, ragged tiles
  zero-filled) is within 1e-5 * max|plain| of ``fft_block_plain`` and of
  the JAX package's Pallas ``fft_block`` in interpret mode (the tolerance
  ``chip_smoke.py`` holds the kernel to: fp32 sums of at most 64 terms in
  another order; the observed gap is below 5e-7), and one pass is not;
* with the tensor cores' addition modelled (sums rounded toward zero),
  a fresh accumulator per k-step keeps fp32's accuracy where chaining
  every k-step into one accumulator does not;
* at n = 2048 and 4096, the three-factor body (``block_mma3_kernel``,
  16 x 16 x n3): its 16-point and n3-point tables are, bit for bit,
  ``block_mma_tables(16, n3)``'s and its twiddles ``core/twiddle.py``'s;
  its emulation on a batch of 5 (one pencil a tile), forward and
  inverse, is within
  1e-5 * max|plain| of ``fft_block_plain`` and of the Pallas
  ``fft_block`` in interpret mode, and one pass is not.

Inputs come from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_block as jkb
from repro_torch import kernels
from repro_torch.core import fft1d as tf
from repro_torch.core import twiddle as ttw
from repro_torch.kernels import fft_block as tkb

from _torch_mma_emulation import emulate as _emulate, rna as _rna

KERNEL_RTOL = 1e-5
MMA_NS = [64, 128, 256, 512, 1024]
MMA3_NS = [2048, 4096]
RNG = np.random.default_rng(14)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# (a) the host split
# ---------------------------------------------------------------------------

def test_tf32_rna_rounds_to_nearest_ties_away():
    """Against an independent rounding: |x| to a multiple of 2^(e - 10),
    e = floor(log2 |x|), half away from zero; ties included."""
    x = np.concatenate([RNG.standard_normal(4096) * 10.0 ** RNG.integers(-6, 6, 4096),
                        [1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -12]]
                       ).astype(np.float32)
    q = 2.0 ** (np.floor(np.log2(np.abs(x.astype(np.float64)))) - 10)
    want = (np.sign(x) * np.floor(np.abs(x) / q + 0.5) * q).astype(np.float32)
    assert np.array_equal(tf.tf32_rna(x), want)
    assert np.array_equal(_rna(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [64, 256, 512, 1024])
def test_host_split_is_exact(n, inverse):
    n1, n2 = ttw.four_step_factors(n)
    f1b, f2b, w = tf.block_mma_tables(n1, n2, inverse, torch.device('cpu'))
    ref_f1b, ref_f2b, ref_w = tf._block_mma_np(n1, n2, inverse)
    assert np.array_equal(w.numpy(), ref_w.astype(np.float32))
    for pair, ref in ((f1b, ref_f1b), (f2b, ref_f2b)):
        assert pair.shape == (2,) + ref.shape
        big, small = pair.numpy().astype(np.float32)
        for part in (big, small):
            assert not (part.view(np.uint32) & 0x1FFF).any()      # TF32 values
        table = ref.astype(np.float32)
        assert np.array_equal(big, tf.tf32_rna(table))
        err = np.abs(big.astype(np.float64) + small - table)
        nz = small != 0
        ulp = 2.0 ** (np.floor(np.log2(np.abs(small[nz].astype(np.float64)))) - 10)
        assert (err[nz] <= ulp).all() and (err[~nz] == 0).all()


# ---------------------------------------------------------------------------
# (b) twiddle, then the block F2, is G
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", MMA_NS)
def test_twiddle_then_block_f2_is_g(n, inverse):
    """G[e, m, j, d', l] = sum_d Wb[j, l][d', d] F2b[(d, l), (e, m)], with
    Wb = [[wr, wi], [-wi, wr]] the real form of c = b W."""
    n1, n2 = ttw.four_step_factors(n)
    _, f2b, w = tf.block_mma_tables(n1, n2, inverse, torch.device('cpu'))
    f2 = (f2b[0].double() + f2b[1].double()).numpy().reshape(2, n2, 2, n2)  # d, l, e, m
    wr, wi = w.double().numpy()
    wb = np.stack([np.stack([wr, wi]), np.stack([-wi, wr])])            # d', d, j, l
    g = np.einsum('pdjl,dlem->emjpl', wb, f2)
    _, ref_g = tf._block_consts_np(n1, n2, inverse)
    assert np.abs(g - ref_g).max() <= 1e-6


# ---------------------------------------------------------------------------
# The fragment order the kernel reads
# ---------------------------------------------------------------------------

def test_fragment_order_unpacks_by_the_lane_mapping():
    """frag_a/frag_b against the m16n8k8 mapping written out lane by lane:
    A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0
    (k = t, n = g), b1 (k = t + 4, n = g); lane = 4 g + t."""
    a = torch.from_numpy(RNG.standard_normal((32, 24)).astype(np.float32))
    b = torch.from_numpy(RNG.standard_normal((16, 24)).astype(np.float32))
    fa, fb = tkb.frag_a(a).reshape(2, 3, 32, 4), tkb.frag_b(b).reshape(2, 3, 32, 2)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for mi in range(2):
            for s in range(3):
                r, k = 16 * mi + g, 8 * s + t
                assert fa[mi, s, lane].tolist() == [a[r, k], a[r + 8, k], a[r, k + 4],
                                                    a[r + 8, k + 4]]
        for s in range(2):
            for nj in range(3):
                assert fb[s, nj, lane].tolist() == [b[8 * s + t, 8 * nj + g],
                                                    b[8 * s + t + 4, 8 * nj + g]]


@pytest.mark.parametrize("n1", [8, 16, 32])
def test_mma_rows_pair_real_and_imaginary_parts(n1):
    """Rows g and g + 8 of every 16-row m-tile of the reordered F1b are
    (c = 0, j1) and (c = 1, j1), j1 = 8 mi + g: one thread holds both."""
    rows = tkb.mma_rows(n1).reshape(-1, 16)
    for mi, tile in enumerate(rows.tolist()):
        for g in range(8):
            assert (tile[g], tile[g + 8]) == (8 * mi + g, n1 + 8 * mi + g)


@pytest.mark.parametrize("n", [64, 512])
def test_mma_tables_are_the_split_tables_in_fragment_order(n):
    n1, n2 = ttw.four_step_factors(n)
    cpu = torch.device('cpu')
    fa, fb, w = tkb.mma_tables(n1, n2, True, cpu)
    f1b, f2b, w2 = tf.block_mma_tables(n1, n2, True, cpu)
    assert torch.equal(fa, tkb.frag_a(f1b[:, tkb.mma_rows(n1)]))
    assert torch.equal(fb, tkb.frag_b(f2b)) and torch.equal(w, w2)
    assert fa.shape == (2, 4 * n1 * n1) and fb.shape == (2, 4 * n2 * n2)


# ---------------------------------------------------------------------------
# (c), (d) the emulated kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", MMA_NS)
def test_three_passes_match_the_plain_version(n, inverse):
    x = torch.from_numpy(RNG.standard_normal((2, 37, n)).astype(np.float32))
    want = tkb.fft_block_plain(x, inverse=inverse).numpy()
    assert _rel(_emulate(x, inverse), want) <= KERNEL_RTOL


@pytest.mark.parametrize("n", MMA_NS)
def test_one_pass_is_not_enough(n):
    """One TF32 pass misses fp32's accuracy by far (about 3e-4 of the
    largest magnitude): why the kernel takes three."""
    x = torch.from_numpy(RNG.standard_normal((2, 37, n)).astype(np.float32))
    want = tkb.fft_block_plain(x).numpy()
    assert _rel(_emulate(x, False, passes=1), want) > KERNEL_RTOL


def test_a_fresh_accumulator_per_k_step_keeps_fp32_accuracy():
    """Under the tensor cores' truncating addition, chaining every k-step
    into one accumulator errs several times more than fp32 (relative L2
    against a float64 FFT); a fresh accumulator per k-step added in fp32,
    the kernel's way, stays within half again of the plain version."""
    x = RNG.standard_normal((2, 64, 512)).astype(np.float32)
    ref = np.fft.fft(x[0].astype(np.float64) + 1j * x[1])
    ref = np.stack([ref.real, ref.imag])

    def l2(y):
        return float(np.linalg.norm(np.asarray(y, np.float64) - ref) / np.linalg.norm(ref))

    xt = torch.from_numpy(x)
    plain = l2(tkb.fft_block_plain(xt))
    chained = l2(_emulate(xt, False, accumulate='chained'))
    fresh = l2(_emulate(xt, False, accumulate='fresh'))
    assert fresh <= 1.5 * plain and chained >= 3 * fresh


@pytest.mark.parametrize("n", [64, 256])
def test_three_passes_match_the_pallas_kernel(n):
    x = RNG.standard_normal((2, 37, n)).astype(np.float32)
    for inverse in (False, True):
        want = np.asarray(jkb.fft_block(jnp.asarray(x), inverse=inverse, interpret=True))
        assert _rel(_emulate(torch.from_numpy(x), inverse), want) <= KERNEL_RTOL


# ---------------------------------------------------------------------------
# The three-factor body, n = 2048 and 4096
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", MMA3_NS)
def test_three_factor_tables_are_block_mma_tables_and_twiddles(n, inverse):
    """The 16-point F1b (both left products), the n3-point block F and W2
    are ``block_mma_tables(16, n3)``'s objects; W1 and W2 are the fp32 of
    ``core/twiddle.py:four_step_twiddle_np`` of (16, 16 n3) and (16, n3)."""
    n3 = n // 256
    cpu = torch.device('cpu')
    f1b, f3b, w2, w1 = tf.block_mma3_tables(n3, inverse, cpu)
    assert all(a is b for a, b in zip((f1b, f3b, w2), tf.block_mma_tables(16, n3, inverse, cpu)))
    for got, (a, b) in ((w1, (16, 16 * n3)), (w2, (16, n3))):
        want = np.stack(ttw.four_step_twiddle_np(a, b, inverse=inverse)).astype(np.float32)
        assert np.array_equal(got.numpy(), want)
    assert (f1b.shape, f3b.shape) == ((2, 32, 32), (2, 2 * n3, 2 * n3))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", MMA3_NS)
def test_three_factor_body_matches_plain_and_pallas(n, inverse):
    """Batch 5, ragged for the Pallas block; the body's tile is one
    pencil."""
    x = RNG.standard_normal((2, 5, n)).astype(np.float32)
    got = _emulate(torch.from_numpy(x), inverse)
    assert _rel(got, tkb.fft_block_plain(torch.from_numpy(x), inverse=inverse)) <= KERNEL_RTOL
    want = np.asarray(jkb.fft_block(jnp.asarray(x), inverse=inverse, interpret=True))
    assert _rel(got, want) <= KERNEL_RTOL


@pytest.mark.parametrize("n", MMA3_NS)
def test_one_pass_is_not_enough_on_three_factors(n):
    x = torch.from_numpy(RNG.standard_normal((2, 5, n)).astype(np.float32))
    want = tkb.fft_block_plain(x).numpy()
    assert _rel(_emulate(x, False, passes=1), want) > KERNEL_RTOL


# ---------------------------------------------------------------------------
# The choice of body and its counter
# ---------------------------------------------------------------------------

def test_variant_is_chosen_by_length_alone():
    assert [tkb.variant(1 << k) for k in range(1, 14)] == (
        ['fma'] * 5 + ['mma'] * 7 + ['fma'])
    for n in range(6, 11):
        assert ttw.four_step_factors(1 << n)[1] >= 8    # the two-factor split's n2 >= 8
        assert tkb.mma_factors(1 << n) == ttw.four_step_factors(1 << n)
    assert [tkb.mma_factors(n) for n in MMA3_NS] == [(16, 16, 8), (16, 16, 16)]


def test_reset_clears_the_mma_counter():
    tkb.launches, tkb.launches_mma = 3, 2
    kernels.reset_launch_counts()
    assert (tkb.launches, tkb.launches_mma) == (0, 0)
