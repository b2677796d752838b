"""Pencils longer than 4096: the long body that all four kernels run for
4096 < n <= 65536 (``src/repro_torch/csrc/fft_long.cu``,
``kernels/_long.py``), on the CPU.

* (a) the torch emulation of its single pass (``tests/_torch_long_emulation.py``:
  a cluster's blocks and their slabs, the column and row phases through
  NaN-filled models of each block's shared memory, the fused route's
  scratch and tiled transpose), against ``np.fft`` in float64 and against
  the JAX package's kernels run as its own tests run them (interpret mode):
  ``fft_matmul``, ``fft_pencil``, ``fft_twiddle_transpose`` and
  ``fft_block`` at n = 8192 (forward and inverse) and 65536 (forward:
  the interpret mode compiles each call for about a second, and the
  reference's ``fft_block`` folds the twiddle into a (2, 256, 256, 2,
  256) constant there, ten seconds a call; the inverse at 65536 is held
  against numpy and the plain versions) on 3 pencils; and against the
  port's plain versions at every long n. Limit: relative L2 <= ``RTOL``
  = 2e-6, fp32 on both sides summed in other orders; every shared access
  of both kernels, each warp's 32 lanes on 32 distinct banks;
* (b) the shared bytes: ``kernels/smem.py`` and ``kernels/_long.py``
  mirror every C sizing function (``chip_smoke.py``'s ``[long]`` phase
  holds them equal to the C side on the card); for every power of two
  n from 2 to 65536 each module's ``variant(n)`` names a body whose
  block fits the 232,448 bytes of sm_90's opt-in limit (before the long
  body, ``fft_matmul``'s and ``fft_block``'s CUDA-core bodies took n =
  8192 and past the limit), and no body but the long one runs above
  4096;
* (c) on ``meta``: a CUDA-shaped call at n = 131072 raises
  ``ValueError`` naming the range, and ``hlostats.count()`` over
  ``plan((65536, 65536))`` and ``plan((1 << 30,))`` counts every launch
  on ``'long'``, allocating nothing.

Inputs come from a numpy seed.
"""
import math
import resource

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_block as jkb
from repro.kernels import fft_fused as jkf
from repro.kernels import fft_matmul as jkm
from repro.kernels import fft_pencil as jkp
import repro_torch.fft as tfft
from repro_torch.core import twiddle as ttw
from repro_torch.kernels import _long, smem
from repro_torch.kernels import fft_block as tkb
from repro_torch.kernels import fft_fused as tkf
from repro_torch.kernels import fft_matmul as tkm
from repro_torch.kernels import fft_pencil as tkp
from repro_torch.launch import hlostats
from repro_torch.launch.mesh import make_fft_mesh

from _torch_long_emulation import column_pass, emulate_fused_long, emulate_long

RTOL = 2e-6
LONG = [8192, 16384, 32768, 65536]
MODULES = {'fft_pencil': tkp, 'fft_fused': tkf, 'fft_matmul': tkm, 'fft_block': tkb}
RNG = np.random.default_rng(34)


def _planar(shape):
    return [RNG.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _rel(got, want):
    g = np.asarray(got[0], np.float64) + 1j * np.asarray(got[1], np.float64)
    w = np.asarray(want[0], np.float64) + 1j * np.asarray(want[1], np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def _np_fft(x, inverse):
    z = x[0].astype(np.float64) + 1j * x[1].astype(np.float64)
    y = np.fft.ifft(z) if inverse else np.fft.fft(z)
    return y.real, y.imag


# ---------------------------------------------------------------------------
# (a) the emulation against numpy, the plain versions and the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8192, 65536])
def test_column_pass_is_the_four_steps_first_half(n):
    """The column phase leaves in the tiles, read back as y[j NA + k1],
    w_n^(j k1) sum_i x[i NB + j] w_NA^(i k1)."""
    x = _planar((2, n))
    na, nb = ttw.four_step_factors(n)
    yr, yi = column_pass(*(torch.from_numpy(a) for a in x))
    z = (x[0].astype(np.float64) + 1j * x[1].astype(np.float64)).reshape(2, na, nb)
    w = np.exp(-2j * np.pi * np.outer(np.arange(na), np.arange(nb)) / n)
    want = (np.fft.fft(z, axis=1) * w).transpose(0, 2, 1).reshape(2, n)
    assert _rel((yr, yi), (want.real, want.imag)) <= RTOL


@pytest.mark.parametrize("n", LONG)
def test_emulation_matches_numpy_and_plain(n):
    x = _planar((3, n))
    xt = [torch.from_numpy(a) for a in x]
    for inverse in (False, True):
        got = emulate_long(*xt, inverse=inverse)
        assert all(torch.isfinite(g).all() for g in got)
        assert _rel(got, _np_fft(x, inverse)) <= RTOL
        plains = [tkp.fft_pencil_plain(*xt, inverse=inverse),
                  tkm.fft_matmul_plain(*xt, inverse=inverse)]
        if n < 65536:               # the plain block's constants at 65536 take seconds
            plains.append(tuple(tkb.fft_block_plain(torch.stack(xt), inverse=inverse)))
        for plain in plains:
            assert _rel(got, plain) <= RTOL


KERNEL_CASES = [(name, n) for n in (8192, 65536)
                for name in ('fft_matmul', 'fft_pencil', 'fft_block')]


@pytest.mark.parametrize("name, n", KERNEL_CASES, ids=[f"{a}-{b}" for a, b in KERNEL_CASES])
def test_emulation_matches_the_jax_kernel(name, n):
    x = _planar((3, n))
    xt = [torch.from_numpy(a) for a in x]
    xj = [jnp.asarray(a) for a in x]
    for inverse in (False, True) if n == 8192 else (False,):
        got = emulate_long(*xt, inverse=inverse)
        assert _rel(got, _np_fft(x, inverse)) <= RTOL
        if name == 'fft_matmul':
            want = jkm.fft_matmul(*xj, inverse=inverse, interpret=True)
        elif name == 'fft_pencil':
            want = jkp.fft_pencil(*xj, inverse=inverse, interpret=True)
        else:
            want = jkb.fft_block(jnp.stack(xj), inverse=inverse, interpret=True)
        assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("n", [8192, 65536])
def test_fused_emulation_matches_the_jax_kernel(n):
    """Rows (2, 2, n) with one (2, n) twiddle plane that both slices
    read in place (``wstride`` 0), against the JAX kernel and numpy."""
    x, w = _planar((2, 2, n)), _planar((2, n))
    xt, wt = [torch.from_numpy(a) for a in x], [torch.from_numpy(a) for a in w]
    assert tkf._twiddle_planes(xt[0], *wt)[2] == 0
    for inverse in (False, True) if n == 8192 else (False,):
        got = emulate_fused_long(*xt, *wt, inverse=inverse)
        assert got[0].shape == (2, n, 2) and all(torch.isfinite(g).all() for g in got)
        want = jkf.fft_twiddle_transpose(*(jnp.asarray(a) for a in x),
                                         *(jnp.asarray(a) for a in w),
                                         inverse=inverse, interpret=True)
        assert _rel(got, want) <= RTOL
        yr, yi = _np_fft(x, inverse)
        y = (yr + 1j * yi) * (w[0] + 1j * w[1])
        assert _rel(got, (y.real.transpose(0, 2, 1), y.imag.transpose(0, 2, 1))) <= RTOL


@pytest.mark.parametrize("twiddle", [False, True, 'shared'])
def test_fused_emulation_matches_plain(twiddle):
    """Rows (3, 5, 8192): no twiddle, a plane a slice (``wstride`` b n)
    and one plane for all slices."""
    n = 8192
    x = _planar((3, 5, n))
    w = {False: [None, None], True: _planar((3, 5, n)), 'shared': _planar((5, n))}[twiddle]
    xt = [torch.from_numpy(a) for a in x]
    wt = [None if a is None else torch.from_numpy(a) for a in w]
    for inverse in (False, True):
        got = emulate_fused_long(*xt, *wt, inverse=inverse)
        assert _rel(got, tkf.fft_twiddle_transpose_plain(*xt, *wt, inverse=inverse)) <= RTOL


# ---------------------------------------------------------------------------
# (b) the bodies, their shared bytes and the mirrors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << k for k in range(1, 17)])
def test_every_length_fits_a_block(n):
    """Each module's body for n, on a batch of 1, 3, 37, 512 or 262,144
    pencils, takes at most the opt-in shared bytes; above 4096 the body
    is the long one, in all four modules."""
    for name, mod in MODULES.items():
        body = mod.variant(n)
        assert (body == 'long') == (n > 4096), (name, n, body)
        for batch in (1, 3, 37, 512, 262144):
            got, b = smem.launch_smem_bytes(name, n, batch)
            assert got == body and 0 <= b <= smem.SMEM_LIMIT, (name, n, batch, body, b)


#: (NA, NB, blocks a pencil, threads a block, shared bytes a block), by hand:
#: the tile's two planes of NA x NB / C floats, and in a cluster the rows'
#: staging, two planes of 32 rows of NB a group (two groups at 32768, one
#: at 65536)
LONG_SIZES = {8192: (128, 64, 1, 512, 2 * 128 * 64 * 4),
              16384: (128, 128, 1, 512, 2 * 128 * 128 * 4),
              32768: (256, 128, 2, 1024, 2 * 256 * 64 * 4 + 2 * 2 * 32 * 128 * 4),
              65536: (256, 256, 4, 1024, 2 * 256 * 64 * 4 + 2 * 1 * 32 * 256 * 4)}


@pytest.mark.parametrize("n", LONG)
def test_long_mirror(n):
    """The long body's split, cluster, threads, shared, scratch and
    device-memory bytes as the C side computes them (``long_smem_bytes``,
    ``long_threads``, ``long_cluster``, ``long_scratch_bytes``,
    ``long_hbm_bytes``), worked by hand; within the opt-in limit."""
    na, nb, c, threads, smem_b = LONG_SIZES[n]
    assert ttw.four_step_factors(n) == (na, nb) == _long.factors(n)
    assert (_long.cluster(n), _long.threads(n), _long.smem_bytes(n)) == (c, threads, smem_b)
    assert smem_b <= smem.SMEM_LIMIT == 232448 and c in (1, 2, 4)
    p = _long.plan(n)
    # every group takes whole rounds of 32 columns and of 32 rows
    assert (p['J'] // 32) % p['GA'] == 0 and (p['KA'] // 32) % p['GB'] == 0
    assert p['GA'] * p['TA'] * 32 <= threads and p['GB'] * p['TB'] * 32 <= threads
    assert _long.TRANSPOSE_SMEM_BYTES == 2 * 32 * 33 * 4
    assert _long.scratch_bytes(n, 3, False) == 0
    assert _long.scratch_bytes(n, 3, True) == 2 * 4 * 3 * n
    pencils = (1 << 28) // n
    assert _long.scratch_bytes(n, pencils, True) == 2 * 4 * (1 << 24) == 2 * 4 * min(
        pencils * n, _long.SCRATCH_ELEMS)
    assert [_long.hbm_bytes_per_elem(False), _long.hbm_bytes_per_elem(True),
            _long.hbm_bytes_per_elem(True, twiddle=True)] == [16, 32, 40]
    # the tile is row-major, its loads by cp.async, where one block of two an SM
    # holds the pencil (8192); every column round is whole
    assert _long.row_major(n) == _long.async_loads(n) == (n == 8192)
    assert p['ROUNDS'] * p['GA'] * 32 == p['J']


BANK_CASES = [(n, fused) for n in LONG for fused in (False, True)]


@pytest.mark.parametrize("n, fused", BANK_CASES,
                         ids=[f"{n}-{'fused' if f else 'plain'}" for n, f in BANK_CASES])
def test_shared_accesses_touch_32_banks(n, fused):
    """Every shared access of both kernels, as the emulation makes it: the
    32 lanes of each warp touch 32 distinct banks (offset mod 32). The
    column phase's lanes are 32 columns (at 8192 also its ``cp.async``
    copies into the tile and their reads), the row phase's 32 rows, and
    the tile XORs the five low bits of one index into the other; the
    staging rows and the transpose's rows of 33 floats do the same by
    construction. A row phase's read of another block's tile (in a
    cluster, whose tiles are column-major) is one aligned 128-byte run a
    warp."""
    x = [torch.from_numpy(a) for a in _planar((1, 2, n) if fused else (2, n))]
    trace = []
    if fused:
        emulate_fused_long(*x, inverse=False, trace=trace)
    else:
        emulate_long(*x, inverse=False, trace=trace)
    kinds = {name for name, _ in trace}
    rows = {'row read'} if _long.cluster(n) == 1 else {'row remote read'}
    want = {'column exchange read', 'column exchange write', 'column twiddled write',
            'row exchange read', 'row exchange write'} | rows
    if fused:
        want |= {'transpose read', 'transpose write'}
    if _long.async_loads(n):
        want |= {'column load write', 'column load read'}
    assert kinds == want, kinds
    for name, at in trace:
        banks = torch.sort(at.reshape(-1, 32) % 32, dim=-1).values
        assert torch.equal(banks, torch.arange(32).expand_as(banks)), name
        if name == 'row remote read':
            runs = at.reshape(-1, 32) // 32
            assert torch.equal(runs.min(-1).values, runs.max(-1).values), name


def test_mirrors_by_hand():
    """The other bodies' sizing functions at lengths worked by hand: the
    CUDA-core four-step at 8192 needed 362,496 bytes, fft_block's 295,424
    with one G slice; the tensor-core body's blocks at 512 and 4096."""
    assert smem.four_step_smem_bytes(128, 64, 1) == 362496
    assert smem.fft_block_smem_bytes(128, 64, 1, 1) == 295424
    assert smem.fft_block_slices(128, 64, 1) == 0
    assert smem.fft_block_slices(4, 4, 128) == 4
    assert smem.stockham_smem_bytes(8192, 1, 8192) == 163840
    assert smem.stockham_smem_bytes(16384, 1, 16384) == 327680
    assert smem.mma_smem_bytes(4096) == (8 * 256 + 8 * 256 + 4 * 4096) * 4
    assert smem.mma_smem_bytes(512) == (8 * 32 * 32 + 8 * 16 * 16 + 2 * 32 * (8 * 16 + 8)
                                        + 8 * 32 * (2 * 16 + 4)) * 4
    assert [smem.mma_smem_bytes(n) for n in (32, 8192)] == [-1, -1]


# ---------------------------------------------------------------------------
# (c) the range on meta, and the dry run's count
# ---------------------------------------------------------------------------

CALLS = {
    'fft_pencil': lambda r, i: tkp.fft_pencil(r, i),
    'fft_matmul': lambda r, i: tkm.fft_matmul(r, i),
    'fft_block': lambda r, i: tkb.fft_block(torch.stack([r, i])),
    'fft_block_planar': lambda r, i: tkb.fft_block_planar(r, i),
    'fft_twiddle_transpose': lambda r, i: tkf.fft_twiddle_transpose(r, i),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_above_65536_raises_on_meta(name):
    r, i = (torch.empty((2, 1 << 17), device='meta') for _ in range(2))
    with pytest.raises(ValueError, match='65536'):
        CALLS[name](r, i)
    r, i = (torch.empty((2, 1 << 16), device='meta') for _ in range(2))
    CALLS[name](r, i)
    for mod in MODULES.values():
        with pytest.raises(ValueError, match='65536'):
            mod.variant(1 << 17)


def test_factors_other_than_the_split_raise_at_a_long_n():
    r, i = (torch.empty((2, 8192), device='meta') for _ in range(2))
    yr, _ = tkm.fft_matmul(r, i, factors=(128, 64))
    assert yr.shape == (2, 8192)
    with pytest.raises(ValueError, match='128, 64'):
        tkm.fft_matmul(r, i, factors=(64, 128))


@pytest.mark.parametrize("shape", [(65536, 65536), (1 << 30,)], ids=['2d', 'rank1'])
def test_dry_run_counts_every_launch_on_long(shape):
    mesh = make_fft_mesh(1, 1, device='meta')
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    p = tfft.plan(shape, mesh)
    x = tuple(torch.empty(tuple(p.local_shape(p.in_layout)), device='meta') for _ in range(2))
    with hlostats.count() as st:
        y = p.inverse(p.forward(x))
    assert tuple(y[0].shape) == shape and y[0].device.type == 'meta'
    k = st.analyze()['kernels']
    assert k and all(v['launches_by_body'] == {'long': v['launches']} for v in k.values()), k
    elems = math.prod(shape)
    assert sum(v['launches'] for v in k.values()) == 4       # two a direction
    assert all(v['bytes_written'] == 8 * elems * v['launches'] for v in k.values())
    # a real run of either would hold 8 GiB and more; meta holds nothing
    assert resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss < (1 << 20)
