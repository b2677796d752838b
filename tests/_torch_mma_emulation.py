"""A torch emulation of the tensor-core four-step bodies on the CPU.

``four_step_mma`` and ``four_step_mma3``
(``src/repro_torch/csrc/four_step_mma.cuh``), which ``fft_block``'s
``block_mma_kernel``/``block_mma3_kernel`` and ``fft_matmul``'s
``matmul_mma_kernel``/``matmul_mma3_kernel`` run, work only on the card.
This module repeats their arithmetic from the tables the host gives them
(``core/fft1d.py:block_mma_tables``, ``block_mma3_tables``): TF32
rounding by bit operations as ``cvt.rna`` rounds, three passes
small*big, big*small, big*big with fp32 sums (or the tensor cores'
truncating addition, modelled), the twiddles in fp32 between the
products, tiles of the kernel's P pencils with the last zero-filled, and
natural order out. :func:`emulate` takes the body a length runs (the
three-factor one at n = 2048 and 4096, whose tile is one pencil).
``tests/test_torch_block_mma.py`` and ``tests/test_torch_matmul_mma.py``
hold it against the plain versions and the JAX kernels.
"""
import torch

from repro_torch.core import fft1d as tf
from repro_torch.core import twiddle as ttw


def rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 to TF32 by bit operations, as ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = rna(x)
    return big, rna(x - big)


def rz(v: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def product(a, b, passes: int, accumulate: str = 'ieee') -> torch.Tensor:
    """a @ b in 3xTF32 as the kernel takes it: the small terms first,
    fp32 sums (TF32 products are exact in fp32); ``passes=1`` keeps
    big*big alone. ``a``/``b`` are (big, small) pairs.

    ``accumulate`` other than 'ieee' models the tensor cores' addition
    instead: each m16n8k8 mma adds its 8 exact products to C and rounds
    the sum toward zero. 'chained' takes every k-step's three mma into
    one accumulator; 'fresh' takes them into a fresh one and adds that
    to the running sum with an fp32 add, as the kernel does."""
    (ab, as_), (bb, bs) = a, b
    if accumulate == 'ieee':
        return ab @ bb if passes == 1 else (as_ @ bb + ab @ bs) + ab @ bb
    acc = torch.zeros(ab.shape[0], bb.shape[1])
    for k in range(0, ab.shape[1], 8):
        terms = [u[:, k:k + 8].double() @ v[k:k + 8].double()
                 for u, v in ((as_, bb), (ab, bs), (ab, bb))]
        d = acc if accumulate == 'chained' else torch.zeros_like(acc)
        for term in terms:
            d = rz(d.double() + term)
        acc = d if accumulate == 'chained' else acc + d
    return acc


def twiddle(b: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """b (2, ...) times the twiddle wr + i wi in fp32, as the kernel
    applies it to its accumulators."""
    return torch.stack([b[0] * wr - b[1] * wi, b[0] * wi + b[1] * wr])


def emulate3(x: torch.Tensor, inverse: bool, passes: int = 3,
             accumulate: str = 'ieee') -> torch.Tensor:
    """The three-factor body on a stacked (2, B, n), n = 16 * 16 * n3, a
    tile being one pencil (so no tile is ragged), each pencil viewed as
    x[k1, k2, k3]: stage 1 contracts k1 against the split 16-point F1b
    and applies W1[j1, k2 n3 + k3]; stage 2 contracts k2 against the same
    table and applies W2[j2, k3]; stage 3 contracts k3 against the split
    block F of n3 points, rows (j2, j1); natural order y[j1 + 16 j2 +
    256 j3] out."""
    _, batch, n = x.shape
    n3 = n // 256
    f1b, f3b, w2, w1 = tf.block_mma3_tables(n3, inverse, torch.device('cpu'))
    f16 = (f1b[0], f1b[1])
    # stage 1: rows (d, k1), cols (p, k2, k3)
    a = x.reshape(2, batch, 16, 16 * n3).permute(0, 2, 1, 3).reshape(32, -1)
    b = product(f16, split(a), passes, accumulate).reshape(2, 16, batch, 16 * n3)
    b = twiddle(b, w1[0][:, None, :], w1[1][:, None, :])             # (d, j1, p, k2 n3 + k3)
    # stage 2: rows (d, k2), cols (p, j1, k3)
    a = b.reshape(2, 16, batch, 16, n3).permute(0, 3, 2, 1, 4).reshape(32, -1)
    b = product(f16, split(a), passes, accumulate).reshape(2, 16, batch, 16, n3)
    b = twiddle(b, w2[0][:, None, None, :], w2[1][:, None, None, :])  # (d, j2, p, j1, k3)
    # stage 3: rows (p, j2, j1), cols (d, k3)
    c = b.permute(2, 1, 3, 0, 4).reshape(batch * 256, 2 * n3)
    y = product(split(c), (f3b[0], f3b[1]), passes, accumulate)     # cols (e, j3)
    y = y.reshape(batch, 16, 16, 2, n3).permute(3, 0, 4, 1, 2).reshape(2, batch, n)
    return y * (1.0 / n) if inverse else y


def emulate(x: torch.Tensor, inverse: bool, passes: int = 3,
            accumulate: str = 'ieee') -> torch.Tensor:
    """The tensor-core body on a stacked (2, B, n): tiles of P pencils
    (the last zero-filled), step 2 against the split F1b, the twiddle in
    fp32, step 3 against the split block F2, natural order out; at
    n = 2048 and 4096 the three-factor body (:func:`emulate3`)."""
    _, batch, n = x.shape
    if n in (2048, 4096):
        return emulate3(x, inverse, passes, accumulate)
    n1, n2 = ttw.four_step_factors(n)
    f1b, f2b, w = tf.block_mma_tables(n1, n2, inverse, torch.device('cpu'))
    P = (2048 if n >= 1024 else 4096) // n
    bp = -(-batch // P) * P
    xp = torch.zeros(2, bp, n)
    xp[:, :batch] = x
    a = xp.reshape(2, bp, n1, n2).permute(0, 2, 1, 3).reshape(2 * n1, bp * n2)
    b = product((f1b[0], f1b[1]), split(a), passes, accumulate).reshape(2, n1, bp, n2)
    c = twiddle(b, w[0][:, None, :], w[1][:, None, :])                # (d, j1, p, k2)
    c = c.permute(2, 1, 0, 3).reshape(bp * n1, 2 * n2)
    y = product(split(c), (f2b[0], f2b[1]), passes, accumulate)       # rows (p, j1), cols (e, m)
    y = y.reshape(bp, n1, 2, n2).permute(2, 0, 3, 1).reshape(2, bp, n)[:, :batch]
    return y * (1.0 / n) if inverse else y


def emulate_planar(re: torch.Tensor, im: torch.Tensor, inverse: bool):
    """The same body on a planar pair (B, n), as ``fft_matmul`` passes
    its two planes to it: the planes are the kernel's two pointers, so
    the pair is the stacked form's two halves; returns (re, im)."""
    y = emulate(torch.stack([re, im]), inverse)
    return y[0], y[1]
