"""Local (single-device) pencil FFTs, planar complex, batched: the plain
PyTorch versions.

Port of ``repro.core.fft1d``. Every function maps over arbitrary
leading batch dims and transforms the trailing axis. These are the
'reference' tier of the method registry and the CPU path of every
kernel wrapper; the CUDA kernels under ``repro_torch.kernels`` compute
the same functions.

* ``fft_stockham`` — radix-2 Stockham autosort (the paper-faithful
  pencil), the same stage order and twiddles as the reference.
* ``fft_four_step`` — Bailey four-step as planar matmuls against DFT
  matrices. It runs in full fp32 (the reference uses
  ``Precision.HIGHEST``): on a CUDA tensor it sets
  ``torch.backends.cuda.matmul.allow_tf32 = False`` before its
  products, so no TF32 rounding enters. With ``compute_dtype`` (e.g.
  ``torch.bfloat16``) its matrices and operands are rounded to that
  type first, the accumulation and the twiddle staying fp32.
* ``fft_four_step_block`` — the block-complex four-step: the complex
  axis carried as a leading size-2 axis, two real contractions per
  pencil against ``_block_consts_np``, full fp32 like the four-step.
* ``rfft_pencil`` / ``irfft_pencil`` / ``rfft_via`` — the real-input
  pencils: a length-n/2 complex FFT inside a Hermitian pack/combine.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import twiddle as tw
from repro_torch.core.twiddle import Planar


@functools.lru_cache(maxsize=None)
def _stage_tables(n: int, inverse: bool, device: torch.device):
    return tuple((tw.table(r, device), tw.table(i, device))
                 for r, i in tw.stage_twiddles_np(n, inverse=inverse))


def narrow(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``t`` rounded to ``compute_dtype`` and widened back to its own
    type (the identity for None). A product of two bf16 values is exact
    in fp32, so an fp32 product of narrowed operands is the reference's
    bf16 product with ``preferred_element_type=float32``, up to the
    order of its sums."""
    if compute_dtype is None or compute_dtype == t.dtype:
        return t
    return t.to(compute_dtype).to(t.dtype)


@functools.lru_cache(maxsize=None)
def four_step_tables(n1: int, n2: int, inverse: bool, device: torch.device):
    f1 = tuple(tw.table(a, device) for a in tw.dft_matrix_np(n1, inverse=inverse))
    f2 = tuple(tw.table(a, device) for a in tw.dft_matrix_np(n2, inverse=inverse))
    w = tuple(tw.table(a, device)
              for a in tw.four_step_twiddle_np(n1, n2, inverse=inverse))
    return f1, f2, w


def full_fp32_matmul(device: torch.device) -> None:
    """Keep float32 products at full precision on CUDA (no TF32)."""
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# Stockham radix-2 (paper-faithful)
# ---------------------------------------------------------------------------

def fft_stockham(re: torch.Tensor, im: torch.Tensor, *,
                 inverse: bool = False, compute_dtype=None) -> Planar:
    """Batched radix-2 Stockham FFT along the last axis.

    It has no matrix operands, so it ignores ``compute_dtype`` (the
    reference raises there).

    After the stage with subproblem size L the array viewed as (c, L)
    rows holds X[k, :] = DFT_L(x[k::c]), c = n / L; natural order in,
    natural order out."""
    n = re.shape[-1]
    stages = tw.log2i(n)
    batch = tuple(re.shape[:-1])
    twids = _stage_tables(n, inverse, re.device)
    for s in range(stages):
        L = 1 << s
        c = n >> s
        wr, wi = twids[s]
        xr = re.reshape(batch + (2, c // 2, L))
        xi = im.reshape(batch + (2, c // 2, L))
        ar, ai = xr[..., 0, :, :], xi[..., 0, :, :]
        br, bi = xr[..., 1, :, :], xi[..., 1, :, :]
        tr, ti = tw.cmul(br, bi, wr, wi)
        re = torch.cat([ar + tr, ar - tr], dim=-1).reshape(batch + (n,))
        im = torch.cat([ai + ti, ai - ti], dim=-1).reshape(batch + (n,))
    if inverse:
        re, im = re * (1.0 / n), im * (1.0 / n)
    return re, im


# ---------------------------------------------------------------------------
# Bailey four-step (matmul form)
# ---------------------------------------------------------------------------

def fft_four_step(re: torch.Tensor, im: torch.Tensor, *,
                  inverse: bool = False, compute_dtype=None) -> Planar:
    """Batched four-step FFT along the last axis.

    x[k], k = n2*k1 + k2  ->  y[j], j = j1 + n1*j2:
      1. A[k1, k2] = x.reshape(n1, n2)
      2. B = F_{n1} @ A
      3. C = B * W, W[j1, k2] = w_n^{j1 k2}
      4. D = C @ F_{n2}
      5. y = D.T.reshape(n)

    With ``compute_dtype`` the DFT matrices, A and C are rounded to it
    before their products (:func:`narrow`); B, the twiddle and D stay
    fp32, as in the reference.
    """
    n = re.shape[-1]
    n1, n2 = tw.four_step_factors(n)
    batch = tuple(re.shape[:-1])
    full_fp32_matmul(re.device)
    (f1r, f1i), (f2r, f2i), (wr, wi) = four_step_tables(n1, n2, inverse, re.device)
    f1r, f1i, f2r, f2i = (narrow(f, compute_dtype) for f in (f1r, f1i, f2r, f2i))
    ar = narrow(re.reshape(batch + (n1, n2)), compute_dtype)
    ai = narrow(im.reshape(batch + (n1, n2)), compute_dtype)
    br = f1r @ ar - f1i @ ai
    bi = f1r @ ai + f1i @ ar
    cr, ci = tw.cmul(br, bi, wr, wi)
    cr, ci = narrow(cr, compute_dtype), narrow(ci, compute_dtype)
    dr = cr @ f2r - ci @ f2i
    di = cr @ f2i + ci @ f2r
    yr = dr.transpose(-1, -2).reshape(batch + (n,))
    yi = di.transpose(-1, -2).reshape(batch + (n,))
    if inverse:
        yr, yi = yr / n, yi / n
    return yr, yi


# ---------------------------------------------------------------------------
# Block-complex four-step (complex carried as a leading size-2 axis)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _block_consts_np(n1: int, n2: int, inverse: bool):
    """Constants of the block-complex four-step, numpy float64.

    F1b[c, j, d, k]: one real contraction over (d, k) computes both
    complex components, [yr; yi] = [[Fr, -Fi], [Fi, Fr]] @ [xr; xi].
    G[c, m, j, d, l]: the twiddle folded into the second factor,
    G[j, l, m] = W[j, l] F2[l, m] as a complex number, so steps 3 and 4
    are one contraction that emits natural order."""
    f1r, f1i = tw.dft_matrix_np(n1, inverse=inverse)
    f2r, f2i = tw.dft_matrix_np(n2, inverse=inverse)
    wr, wi = tw.four_step_twiddle_np(n1, n2, inverse=inverse)
    f1b = np.zeros((2, n1, 2, n1))
    f1b[0, :, 0, :], f1b[0, :, 1, :] = f1r, -f1i
    f1b[1, :, 0, :], f1b[1, :, 1, :] = f1i, f1r
    gr = wr[:, :, None] * f2r[None] - wi[:, :, None] * f2i[None]
    gi = wr[:, :, None] * f2i[None] + wi[:, :, None] * f2r[None]
    g = np.zeros((2, n2, n1, 2, n2))          # [c, m, j, d, l]
    g[0, :, :, 0, :] = gr.transpose(2, 0, 1)
    g[0, :, :, 1, :] = -gi.transpose(2, 0, 1)
    g[1, :, :, 0, :] = gi.transpose(2, 0, 1)
    g[1, :, :, 1, :] = gr.transpose(2, 0, 1)
    return f1b, g


@functools.lru_cache(maxsize=None)
def block_tables(n1: int, n2: int, inverse: bool, device: torch.device):
    """(F1b, G) of :func:`_block_consts_np` as fp32 on ``device``."""
    return tuple(tw.table(a, device) for a in _block_consts_np(n1, n2, inverse))


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: the rounding of ``cvt.rna.tf32.f32``. Adds half a TF32
    ulp to the bit pattern and clears the low 13 bits."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(x: np.ndarray):
    """(big, small) TF32 pair of an fp32 array: big = rna(x),
    small = rna(x - big), so big + small is x to about 2^-22 of |x|."""
    x = np.asarray(x, dtype=np.float32)
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


@functools.lru_cache(maxsize=None)
def _block_mma_np(n1: int, n2: int, inverse: bool):
    """The block four-step with the twiddle kept apart from F2, numpy
    float64: F1b as a (2 n1, 2 n1) real matrix (rows (c, j1), columns
    (d, k1)); the block F2 as a (2 n2, 2 n2) matrix (rows (d, k2),
    columns (e, m)), [[F2r, F2i], [-F2i, F2r]]; and planar W (2, n1, n2).
    With b = F1b a and c = b * W as complex numbers, y[e, m n1 + j1] =
    sum_{d, k2} c[d, j1, k2] F2b[(d, k2), (e, m)]: the function of G."""
    f1b, _ = _block_consts_np(n1, n2, inverse)
    f2r, f2i = tw.dft_matrix_np(n2, inverse=inverse)
    f2b = np.block([[f2r, f2i], [-f2i, f2r]])
    return (f1b.reshape(2 * n1, 2 * n1), f2b,
            np.stack(tw.four_step_twiddle_np(n1, n2, inverse=inverse)))


@functools.lru_cache(maxsize=None)
def block_mma_tables(n1: int, n2: int, inverse: bool, device: torch.device):
    """The tensor-core ``fft_block``'s tables on ``device``: F1b (2, 2 n1,
    2 n1) and F2b (2, 2 n2, 2 n2) of :func:`_block_mma_np` as their
    3xTF32 pairs ([big, small] on the leading axis, split from the fp32
    table by :func:`tf32_split`), and W (2, n1, n2) in plain fp32 (the
    twiddle is applied on the CUDA cores, not in a product)."""
    f1b, f2b, w = _block_mma_np(n1, n2, inverse)
    return (tw.table(np.stack(tf32_split(f1b)), device),
            tw.table(np.stack(tf32_split(f2b)), device), tw.table(w, device))


@functools.lru_cache(maxsize=None)
def block_mma3_tables(n3: int, inverse: bool, device: torch.device):
    """The three-factor tensor-core body's tables for n = 16 * 16 * n3 on
    ``device``: F1b of 16 points and the block F of n3 points as their
    3xTF32 pairs and W2 (2, 16, n3) = w_{16 n3}^{j2 k3}, all three
    :func:`block_mma_tables` of (16, n3), then W1 (2, 16, 16 n3) =
    w_n^{j1 q}, q = k2 n3 + k3, in plain fp32. With
    b[j1, q] = (F16 x[k1, q])[j1] W1[j1, q], c[j1, j2, k3] = (F16
    b[j1, k2, k3])[j2] W2[j2, k3] and y[j1 + 16 j2 + 256 j3] = (c F_n3)
    [j1, j2, j3], y is the DFT of x viewed as (16, 16, n3)."""
    f1b, f3b, w2 = block_mma_tables(16, n3, inverse, device)
    w1 = tw.table(np.stack(tw.four_step_twiddle_np(16, 16 * n3, inverse=inverse)), device)
    return f1b, f3b, w2, w1


#: elements of one plane the block four-step's products take at once:
#: ``BLOCK_ELEMS // n`` pencils, the last block zero-padded. A contraction
#: that folds the batch into its columns may round differently for
#: another batch size (the CPU's BLAS does); with one shape for every
#: block a pencil's bits depend on its own values only, as in
#: :func:`dft_direct`, so a batch of requests gives each request's bits
BLOCK_ELEMS = 1 << 20


def fft_four_step_block(x: torch.Tensor, axis: int, *,
                        inverse: bool = False, compute_dtype=None) -> torch.Tensor:
    """Block-complex four-step FFT along ``axis`` of ``x``, whose leading
    axis of size 2 holds (re, im). Natural-order output, full fp32.

      b[c, j1, k2] = sum_{d, k1} F1b[c, j1, d, k1] a[d, k1, k2]
      y[c, m n1 + j1] = sum_{d, l} G[c, m, j1, d, l] b[d, j1, l]
    with a[d] = x[d] viewed as (n1, n2), on blocks of ``BLOCK_ELEMS // n``
    pencils. With ``compute_dtype`` F1b, G (the twiddle folded in), a and
    b are rounded to it before their products, as in the reference."""
    axis = axis % x.ndim
    n = x.shape[axis]
    n1, n2 = tw.four_step_factors(n)
    full_fp32_matmul(x.device)
    f1b, g = (narrow(t, compute_dtype) for t in block_tables(n1, n2, inverse, x.device))
    a = x.movedim(axis, -1)
    lead = tuple(a.shape[1:-1])
    a = narrow(a.reshape(2, -1, n1, n2), compute_dtype)
    rows, m = a.shape[1], max(1, BLOCK_ELEMS // n)
    parts = []
    for b0 in range(0, rows or 1, m):
        blk = a[:, b0:b0 + m]
        k = blk.shape[1]
        if k < m:
            blk = torch.cat([blk, blk.new_zeros((2, m - k, n1, n2))], 1)
        b = narrow(torch.einsum('cjdk,dakl->cajl', f1b, blk), compute_dtype)
        parts.append(torch.einsum('cmjdl,dajl->camj', g, b)[:, :k])
    d = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
    y = d.reshape((2,) + lead + (n,))
    if inverse:
        y = y * (1.0 / n)
    return y.movedim(-1, axis)


# ---------------------------------------------------------------------------
# Fused superstep: FFT + twiddle rotation + transposed emit
# ---------------------------------------------------------------------------

def fft_twiddle_transpose(re: torch.Tensor, im: torch.Tensor,
                          wr=None, wi=None, *, inverse: bool = False,
                          fft_fn=None, compute_dtype=None) -> Planar:
    """FFT along the LAST axis, optional planar twiddle multiply, and
    the last two axes exchanged:
    ``out[..., k, j] = (W * FFT(x))[..., j, k]``. ``wr``/``wi``
    broadcast against the pre-transpose output (..., b, n). Returns
    transposed views; a consumer that needs contiguous storage copies."""
    fft_fn = fft_stockham if fft_fn is None else fft_fn
    yr, yi = fft_fn(re, im, inverse=inverse, compute_dtype=compute_dtype)
    if wr is not None:
        yr, yi = tw.cmul(yr, yi, wr, wi)
    return yr.transpose(-1, -2), yi.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Real-input pencils: pack two reals as one complex
# ---------------------------------------------------------------------------
#
# A length-n real FFT is one length-n/2 complex FFT plus an O(n)
# Hermitian combine: c[t] = a[2t] + i a[2t+1], C = FFT_{n/2}(c); with
# Cm[k] = C[(n/2 - k) mod n/2], E = (C + conj(Cm))/2 and
# O = (C - conj(Cm))/(2i) are the even/odd half spectra, and
# A[k] = E[k] + w_n^k O[k] (k < n/2), A[n/2] = E[0] - O[0].

@functools.lru_cache(maxsize=None)
def _split_table(n: int, device: torch.device) -> Planar:
    return tuple(tw.table(a, device) for a in tw.rfft_split_twiddle_np(n))


def rfft_pencil(x: torch.Tensor, *, cfft) -> Planar:
    """Half-spectrum rfft of a real tensor along its last axis (n ->
    n//2 + 1 bins, ``np.fft.rfft``'s layout). ``cfft(re, im)`` is any
    length-n/2 forward complex FFT. The imaginary parts of bins 0 and
    n/2 are exactly zero."""
    n = x.shape[-1]
    if n % 2:
        raise ValueError(f"rfft pencil needs an even length, got {n}")
    cr, ci = cfft(x[..., 0::2], x[..., 1::2])
    cmr = torch.roll(torch.flip(cr, (-1,)), 1, -1)
    cmi = torch.roll(torch.flip(ci, (-1,)), 1, -1)
    er, ei = (cr + cmr) * 0.5, (ci - cmi) * 0.5
    our, oui = (ci + cmi) * 0.5, (cmr - cr) * 0.5
    wr, wi = _split_table(n, x.device)
    ar = er + (our * wr - oui * wi)
    ai = ei + (our * wi + oui * wr)
    edge_r = er[..., :1] - our[..., :1]
    return (torch.cat([ar, edge_r], dim=-1),
            torch.cat([ai, torch.zeros_like(edge_r)], dim=-1))


def irfft_pencil(re: torch.Tensor, im: torch.Tensor, *, cifft) -> torch.Tensor:
    """Inverse of :func:`rfft_pencil`: a planar half spectrum (last axis
    n//2 + 1) to the real tensor (last axis n). ``cifft`` is any
    length-n/2 inverse complex FFT with its 1/(n/2) scaling, so the 1/n
    of ``np.fft.irfft`` comes out exactly."""
    nh = re.shape[-1]
    h = nh - 1
    n = 2 * h
    if h < 1:
        raise ValueError(f"irfft pencil needs >= 2 spectrum bins, got {nh}")
    ar, ai = re[..., :h], im[..., :h]
    amr = torch.flip(re[..., 1:], (-1,))
    ami = torch.flip(im[..., 1:], (-1,))
    er, ei = (ar + amr) * 0.5, (ai - ami) * 0.5
    tr, ti = (ar - amr) * 0.5, (ai + ami) * 0.5
    wr, wi = _split_table(n, re.device)
    our = tr * wr + ti * wi
    oui = ti * wr - tr * wi
    cr, ci = cifft(er - oui, ei + our)
    return torch.stack([cr, ci], dim=-1).reshape(tuple(re.shape[:-1]) + (n,))


def rfft_via(pencil_fn):
    """A ``real_fn`` from a complex pencil ``(re, im, *, inverse,
    compute_dtype)``: the forward maps a real tensor to the planar half
    spectrum, the inverse (``real_fn(re, im, inverse=True)``) maps it
    back; ``compute_dtype`` passes through to the pencil."""
    def real_fn(x, im=None, *, inverse=False, compute_dtype=None):
        if inverse:
            return irfft_pencil(x, im, cifft=lambda r, i: pencil_fn(
                r, i, inverse=True, compute_dtype=compute_dtype))
        return rfft_pencil(x, cfft=lambda r, i: pencil_fn(
            r, i, inverse=False, compute_dtype=compute_dtype))
    return real_fn


# ---------------------------------------------------------------------------
# Direct DFT (oracle for tiny sizes and non-pow2 lengths)
# ---------------------------------------------------------------------------

#: pencils per matrix product in ``dft_direct``: a fixed shape, whatever
#: the batch, so the library picks one kernel for every block
DIRECT_ROWS = 16384


def dft_direct(re: torch.Tensor, im: torch.Tensor, *,
               inverse: bool = False, compute_dtype=None) -> Planar:
    """The dense DFT, y = x @ F.T, as four real matrix products in full
    fp32 (it ignores ``compute_dtype``, as the reference does), run on
    blocks of ``DIRECT_ROWS`` pencils with the last block zero-padded. A
    product's kernel (and its summation order) may change with the
    number of rows it is given; with one shape for every block a pencil's
    bits depend on its own values only, so a chunked plan gives the bits
    of the unchunked one."""
    n = re.shape[-1]
    batch = tuple(re.shape[:-1])
    full_fp32_matmul(re.device)
    fr, fi = (tw.table(a, re.device) for a in tw.dft_matrix_np(n, inverse=inverse))
    xr, xi = re.reshape(-1, n), im.reshape(-1, n)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    rows = xr.shape[0]
    for b0 in range(0, rows, DIRECT_ROWS):
        m = min(DIRECT_ROWS, rows - b0)
        br, bi = xr[b0:b0 + m], xi[b0:b0 + m]
        if m < DIRECT_ROWS:
            br = torch.cat([br, br.new_zeros(DIRECT_ROWS - m, n)])
            bi = torch.cat([bi, bi.new_zeros(DIRECT_ROWS - m, n)])
        pr, pi = (br @ fr.T - bi @ fi.T)[:m], (bi @ fr.T + br @ fi.T)[:m]
        if inverse:
            pr, pi = pr / n, pi / n
        yr[b0:b0 + m], yi[b0:b0 + m] = pr, pi
    return yr.reshape(batch + (n,)), yi.reshape(batch + (n,))
