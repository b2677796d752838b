"""Roots of unity, DFT matrices and planar-complex helpers.

Port of ``repro.core.twiddle``. The table factories are the same numpy
float64 arithmetic as the reference, so every table is bitwise equal to
it; the kernels and plain pencils cast them to fp32 on their device.
Complex numbers are planar throughout: a pair ``(re, im)`` of
equal-shape real tensors.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

Planar = Tuple[torch.Tensor, torch.Tensor]


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def log2i(n: int) -> int:
    if not is_pow2(n):
        raise ValueError(f"size must be a power of two, got {n}")
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# Host tables (numpy float64)
# ---------------------------------------------------------------------------

def roots_of_unity_np(n: int, *, inverse: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of w_n^k = exp(-2*pi*i*k/n), k in [0, n). ``inverse``
    negates the imaginary part."""
    k = np.arange(n, dtype=np.float64)
    ang = -2.0 * math.pi * k / n
    re = np.cos(ang)
    im = np.sin(ang)
    if inverse:
        im = -im
    return re, im


@functools.lru_cache(maxsize=None)
def stage_twiddles_np(n: int, *, inverse: bool = False) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
    """Per-stage Stockham twiddles: entry s holds w_{2L}^j, j in [0, L),
    L = 2^s, for s = 0 .. log2(n)-1."""
    out = []
    for s in range(log2i(n)):
        L = 1 << s
        j = np.arange(L, dtype=np.float64)
        ang = -2.0 * math.pi * j / (2 * L)
        im = np.sin(ang)
        if inverse:
            im = -im
        out.append((np.cos(ang), im))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def dft_matrix_np(n: int, *, inverse: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Planar (re, im) of the dense DFT matrix F[j, k] = w_n^{jk}."""
    jk = np.outer(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64))
    ang = -2.0 * math.pi * (jk % n) / n
    im = np.sin(ang)
    if inverse:
        im = -im
    return np.cos(ang), im


@functools.lru_cache(maxsize=None)
def four_step_twiddle_np(n1: int, n2: int, *, inverse: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """W[j1, k2] = w_{n1*n2}^{j1*k2}, the inter-factor twiddle of the
    Bailey four-step."""
    n = n1 * n2
    jk = np.outer(np.arange(n1, dtype=np.float64), np.arange(n2, dtype=np.float64))
    ang = -2.0 * math.pi * (jk % n) / n
    im = np.sin(ang)
    if inverse:
        im = -im
    return np.cos(ang), im


@functools.lru_cache(maxsize=None)
def rfft_split_twiddle_np(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of w_n^k, k in [0, n//2): the post-combine twiddles of
    the pack-two-reals-as-one-complex rfft (A[k] = E[k] + w_n^k O[k]).
    The inverse combine uses the conjugate."""
    k = np.arange(n // 2, dtype=np.float64)
    ang = -2.0 * math.pi * k / n
    return np.cos(ang), np.sin(ang)


def four_step_factors(n: int) -> Tuple[int, int]:
    """Split n = n1 * n2 with n1 >= n2, both powers of two, as square as
    possible."""
    k = log2i(n)
    k1 = (k + 1) // 2
    return 1 << k1, 1 << (k - k1)


# ---------------------------------------------------------------------------
# Device tables and planar helpers (torch)
# ---------------------------------------------------------------------------

def table(arr: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    """A host table as a contiguous tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)


def cmul(ar, ai, br, bi) -> Planar:
    """Planar complex multiply: 4 mul + 2 add."""
    return ar * br - ai * bi, ar * bi + ai * br


def to_planar(x, *, device, dtype=torch.float32) -> Planar:
    """A numpy (or torch) complex array as the planar pair (re, im) of
    ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        re, im = (x.real, x.imag) if x.is_complex() else (x, torch.zeros_like(x))
        return re.to(device=device, dtype=dtype), im.to(device=device, dtype=dtype)
    x = np.asarray(x)
    return (torch.as_tensor(np.ascontiguousarray(x.real), dtype=dtype, device=device),
            torch.as_tensor(np.ascontiguousarray(x.imag), dtype=dtype, device=device))


def from_planar(p: Planar) -> np.ndarray:
    """A planar pair as a numpy complex128 array on the host."""
    re, im = (t.detach().to('cpu', torch.float64).numpy() for t in p)
    return re + 1j * im


def full_fp32_matmul(device: torch.device) -> None:
    """Keep float32 products at full precision on CUDA (no TF32)."""
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False


def cmatmul(ar, ai, br, bi, *, preferred=torch.float32) -> Planar:
    """Planar complex matmul as four real ``torch.matmul`` products, each
    cast to ``preferred`` before the sums. On a CUDA tensor the products
    run in full fp32 (TF32 off), as the reference's run at its
    requested precision. Kept for parity with the reference; nothing in
    the port calls it."""
    full_fp32_matmul(ar.device)
    rr = torch.matmul(ar, br).to(preferred) - torch.matmul(ai, bi).to(preferred)
    ri = torch.matmul(ar, bi).to(preferred) + torch.matmul(ai, br).to(preferred)
    return rr, ri
