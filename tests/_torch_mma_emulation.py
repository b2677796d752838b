"""A torch emulation of the tensor-core four-step body on the CPU.

``four_step_mma`` (``src/repro_torch/csrc/four_step_mma.cuh``), which
``fft_block``'s ``block_mma_kernel`` and ``fft_matmul``'s
``matmul_mma_kernel`` both run, works only on the card. This module
repeats its arithmetic from the tables the host gives it
(``core/fft1d.py:block_mma_tables``): TF32 rounding by bit operations as
``cvt.rna`` rounds, three passes small*big, big*small, big*big with fp32
sums (or the tensor cores' truncating addition, modelled), tiles of the
kernel's P pencils with the last zero-filled, and natural order out.
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


def emulate(x: torch.Tensor, inverse: bool, passes: int = 3,
            accumulate: str = 'ieee') -> torch.Tensor:
    """The tensor-core body on a stacked (2, B, n): tiles of P pencils
    (the last zero-filled), step 2 against the split F1b, the twiddle in
    fp32, step 3 against the split block F2, natural order out."""
    _, batch, n = x.shape
    n1, n2 = ttw.four_step_factors(n)
    f1b, f2b, w = tf.block_mma_tables(n1, n2, inverse, torch.device('cpu'))
    P = (2048 if n >= 1024 else 4096) // n
    bp = -(-batch // P) * P
    xp = torch.zeros(2, bp, n)
    xp[:, :batch] = x
    a = xp.reshape(2, bp, n1, n2).permute(0, 2, 1, 3).reshape(2 * n1, bp * n2)
    b = product((f1b[0], f1b[1]), split(a), passes, accumulate).reshape(2, n1, bp, n2)
    wr, wi = w[0][:, None, :], w[1][:, None, :]
    c = torch.stack([b[0] * wr - b[1] * wi, b[0] * wi + b[1] * wr])   # (d, j1, p, k2)
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
