"""``fft_matmul`` on the tensor-core four-step body, on the CPU.

``matmul_mma_kernel`` (``src/repro_torch/csrc/fft_matmul.cu``) runs the
body of ``csrc/four_step_mma.cuh`` that ``fft_block`` runs too, and only
on the card. These tests hold what it is given and what it computes:

* it is chosen by the pencil length alone, for the same lengths as
  ``fft_block``'s tensor-core body (64 <= n <= 4096);
* the TPU ``fft_matmul``'s constants (F1, F2 and W of
  ``repro.core.twiddle``, in fp32 as the Pallas kernel holds them)
  arranged as real block matrices are, bit for bit, the unsplit tables
  of ``core/fft1d.py:block_mma_tables``, whose 3xTF32 split and fragment
  order the wrapper passes (one cache, shared with ``fft_block``);
* at n = 2048 and 4096 (the three-factor body, 16 x 16 x n3) the
  16-point and n3-point DFT matrices and the two twiddles of the TPU
  ``fft_matmul``'s ``repro.core.twiddle``, in block form, are bit for bit
  the tables the wrapper passes, in the order the kernel reads them;
* the torch emulation of the body (``tests/_torch_mma_emulation.py``) on
  planar input with a ragged batch of 37 (5 at n = 2048 and 4096) is
  within 1e-5 * max|plain| of ``fft_matmul_plain`` and of the JAX
  package's Pallas ``fft_matmul`` in interpret mode, the tolerance
  ``chip_smoke.py`` holds the kernel to (fp32 sums in another order);
* the kernels' build names a library by its source and every shared
  header, so an edited header is rebuilt, and a source includes only
  headers that lie beside it;
* ``kernels.reset_launch_counts`` clears the body's counter.

Inputs come from a numpy seed.
"""
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import twiddle as jtw
from repro.kernels import fft_matmul as jkm
from repro_torch import kernels
from repro_torch.core import fft1d as tf
from repro_torch.core import twiddle as ttw
from repro_torch.kernels import _build
from repro_torch.kernels import fft_block as tkb
from repro_torch.kernels import fft_matmul as tkm

from _torch_mma_emulation import emulate_planar

KERNEL_RTOL = 1e-5
MMA_NS = [64, 128, 256, 512, 1024]
MMA3_NS = [2048, 4096]
RNG = np.random.default_rng(15)


def _rel(got, want):
    return (max(float(np.abs(np.asarray(g) - np.asarray(w)).max()) for g, w in zip(got, want))
            / max(float(np.abs(np.asarray(w)).max()) for w in want))


@pytest.mark.parametrize("n", [1 << k for k in range(1, 13)])
def test_variant_is_mma_exactly_from_64_to_1024(n):
    """The tensor-core body's range, 64..1024 when this test was named,
    now 64..4096: the three-factor split took 2048 and 4096."""
    assert tkm.variant(n) == ('mma' if 64 <= n <= 4096 else 'fma')
    assert tkm.variant(n) == tkb.variant(n)
    assert tkm.MMA_LENGTHS == tkb.MMA_LENGTHS == (64, 4096)
    assert tkb.mma_factors(n) == ((16, 16, n // 256) if n >= 2048 else ttw.four_step_factors(n))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", MMA_NS)
def test_tpu_tables_in_block_form_are_the_block_mma_tables(n, inverse):
    """F1 a in planar form, (F1r ar - F1i ai, F1r ai + F1i ar), is
    [[F1r, -F1i], [F1i, F1r]] [ar; ai]; C F2 is [cr, ci] times
    [[F2r, F2i], [-F2i, F2r]]. Negation is exact, so the block matrices
    built from the Pallas kernel's fp32 constants equal the port's
    tables bitwise."""
    n1, n2 = jtw.four_step_factors(n)
    assert (n1, n2) == ttw.four_step_factors(n)

    def fp32(pair):
        return [np.asarray(jnp.asarray(a, jnp.float32)) for a in pair]

    f1r, f1i = fp32(jtw.dft_matrix_np(n1, inverse=inverse))
    f2r, f2i = fp32(jtw.dft_matrix_np(n2, inverse=inverse))
    wr, wi = fp32(jtw.four_step_twiddle_np(n1, n2, inverse=inverse))
    f1b = np.block([[f1r, -f1i], [f1i, f1r]])
    f2b = np.block([[f2r, f2i], [-f2i, f2r]])

    ref_f1b, ref_f2b, ref_w = tf._block_mma_np(n1, n2, inverse)
    assert np.array_equal(f1b, ref_f1b.astype(np.float32))
    assert np.array_equal(f2b, ref_f2b.astype(np.float32))
    assert np.array_equal(np.stack([wr, wi]), ref_w.astype(np.float32))

    split_f1b, split_f2b, w = tf.block_mma_tables(n1, n2, inverse, torch.device('cpu'))
    assert np.array_equal(split_f1b.numpy(), np.stack(tf.tf32_split(f1b)))
    assert np.array_equal(split_f2b.numpy(), np.stack(tf.tf32_split(f2b)))
    assert np.array_equal(w.numpy(), np.stack([wr, wi]))


def test_the_wrapper_passes_fft_blocks_tables_from_one_cache():
    assert tkm.mma_tables_for is tkb.mma_tables_for
    cpu = torch.device('cpu')
    assert all(a is b for a, b in zip(tkm.mma_tables_for(256, False, cpu),
                                      tkb.mma_tables(16, 16, False, cpu)))
    assert all(a is b for a, b in zip(tkm.mma_tables_for(4096, True, cpu),
                                      tkb.mma3_tables(16, True, cpu)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", MMA3_NS)
def test_tpu_tables_in_block_form_are_the_three_factor_tables(n, inverse):
    """The three-factor body's tables from the Pallas kernel's fp32
    constants of ``repro.core.twiddle``: the 16-point F as the block
    [[Fr, -Fi], [Fi, Fr]], the n3-point F as [[Fr, Fi], [-Fi, Fr]], the
    twiddles W1 = w_n^{j1 q} (16 x 16 n3) and W2 = w_{16 n3}^{j2 k3}
    (16 x n3); then in the kernel's order: A fragments of the 16-point
    table with rows in mma_rows order, B fragments of the n3-point one,
    W2 then W1 flat. Negation and the split are exact, so all bitwise."""
    n3 = n // 256

    def fp32(pair):
        return [np.asarray(jnp.asarray(a, jnp.float32)) for a in pair]

    f16r, f16i = fp32(jtw.dft_matrix_np(16, inverse=inverse))
    f3r, f3i = fp32(jtw.dft_matrix_np(n3, inverse=inverse))
    w1 = np.stack(fp32(jtw.four_step_twiddle_np(16, 16 * n3, inverse=inverse)))
    w2 = np.stack(fp32(jtw.four_step_twiddle_np(16, n3, inverse=inverse)))
    f1b = np.block([[f16r, -f16i], [f16i, f16r]])
    f3b = np.block([[f3r, f3i], [-f3i, f3r]])

    cpu = torch.device('cpu')
    split_f1b, split_f3b, got_w2, got_w1 = tf.block_mma3_tables(n3, inverse, cpu)
    assert np.array_equal(split_f1b.numpy(), np.stack(tf.tf32_split(f1b)))
    assert np.array_equal(split_f3b.numpy(), np.stack(tf.tf32_split(f3b)))
    assert np.array_equal(got_w1.numpy(), w1) and np.array_equal(got_w2.numpy(), w2)

    fa, fb, w = tkm.mma_tables_for(n, inverse, cpu)
    rows = tkb.mma_rows(16)
    assert torch.equal(fa, tkb.frag_a(torch.from_numpy(np.stack(tf.tf32_split(f1b)))[:, rows]))
    assert torch.equal(fb, tkb.frag_b(torch.from_numpy(np.stack(tf.tf32_split(f3b)))))
    assert np.array_equal(w.numpy(), np.concatenate([w2.ravel(), w1.ravel()]))
    assert fa.numel() == 2 * 4 * 16 * 16 and fb.numel() == 2 * 4 * n3 * n3


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [64, 256, 512])
def test_emulated_body_on_planar_input_matches_plain_and_pallas(n, inverse):
    """Batch 37 is not a multiple of the body's tile (64, 16 and 8
    pencils) nor of the Pallas block (16): the last tile is ragged on
    both sides."""
    x = [RNG.standard_normal((37, n)).astype(np.float32) for _ in range(2)]
    got = emulate_planar(*(torch.from_numpy(a) for a in x), inverse)
    plain = tkm.fft_matmul_plain(*(torch.from_numpy(a) for a in x), inverse=inverse)
    pallas = jkm.fft_matmul(*(jnp.asarray(a) for a in x), inverse=inverse, interpret=True)
    assert _rel(got, plain) <= KERNEL_RTOL
    assert _rel(got, pallas) <= KERNEL_RTOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", MMA3_NS)
def test_emulated_three_factor_body_on_planar_input_matches_plain_and_pallas(n, inverse):
    """Batch 5, not a multiple of the Pallas block; the body's tile is one
    pencil."""
    x = [RNG.standard_normal((5, n)).astype(np.float32) for _ in range(2)]
    got = emulate_planar(*(torch.from_numpy(a) for a in x), inverse)
    plain = tkm.fft_matmul_plain(*(torch.from_numpy(a) for a in x), inverse=inverse)
    pallas = jkm.fft_matmul(*(jnp.asarray(a) for a in x), inverse=inverse, interpret=True)
    assert _rel(got, plain) <= KERNEL_RTOL
    assert _rel(got, pallas) <= KERNEL_RTOL


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, 'CSRC', src)
    return src


@pytest.mark.parametrize("name", _build.SOURCES)
def test_editing_a_header_changes_the_library_path(csrc_copy, name):
    before = _build.library_path(name)
    assert _build.library_path(name) == before          # a digest, not a clock
    header = csrc_copy / 'four_step_mma.cuh'
    header.write_text(header.read_text() + '// edited\n')
    edited = _build.library_path(name)
    assert edited != before and edited.parent == before.parent
    (csrc_copy / 'another.cuh').write_text('#pragma once\n')
    assert _build.library_path(name) not in (before, edited)


def test_sources_include_only_headers_beside_them():
    """``nvcc`` finds a quoted include in the including file's own
    directory, so the build needs no ``-I`` flag."""
    seen = set()
    for name in _build.SOURCES:
        text = (_build.CSRC / f'{name}.cu').read_text()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert (_build.CSRC / inc).is_file() and '/' not in inc
            seen.add(inc)
    assert not any('-I' in flag for flag in _build.NVCC_FLAGS)
    assert seen == {'four_step_mma.cuh'}


def test_both_kernels_run_the_shared_body():
    for name, kernel in (('fft_block', 'block_mma_kernel'), ('fft_matmul', 'matmul_mma_kernel')):
        text = (_build.CSRC / f'{name}.cu').read_text()
        assert '#include "four_step_mma.cuh"' in text
        assert re.search(kernel + r'\([^{]*\{\s*extern __shared__[^;]*;\s*four_step_mma<', text)


@pytest.mark.parametrize("n", MMA3_NS)
def test_both_kernels_run_the_three_factor_body_at_the_wrappers_split(n):
    """The header dispatches n to the Mma3Shape of the wrappers'
    :func:`mma_factors`, and both sources run it by a kernel of their own."""
    header = (_build.CSRC / 'four_step_mma.cuh').read_text()
    n1, n2, n3 = tkb.mma_factors(n)
    assert re.search(rf'if \(n == {n}\) return f\(Mma3Shape<{n1}, {n2}, {n3}, \d+, \d+>', header)
    for name, kernel in (('fft_block', 'block_mma3_kernel'),
                         ('fft_matmul', 'matmul_mma3_kernel')):
        text = (_build.CSRC / f'{name}.cu').read_text()
        assert re.search(kernel + r'\([^{]*\{\s*extern __shared__[^;]*;\s*four_step_mma3<', text)
        assert re.search(r'mma_kernel_of\(Mma3Shape<[^)]*\)\s*\{\s*return ' + kernel, text)


def test_reset_clears_the_mma_counter():
    tkm.launches, tkm.launches_mma = 3, 2
    kernels.reset_launch_counts()
    assert (tkm.launches, tkm.launches_mma) == (0, 0)
