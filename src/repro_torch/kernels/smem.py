"""The shared bytes of every CUDA body, computed in Python.

Each function mirrors the C function of the same name in
``csrc/*.cu`` (``chip_smoke.py``'s ``[long]`` phase holds every one
equal to the C side on the card, for every power of two n from 2 to
65536). :func:`launch_smem_bytes` gives the bytes a block takes in the
launch a kernel module's ``variant(n)`` picks, so a test on the CPU can
show that every length the kernels take fits :data:`SMEM_LIMIT`.
"""
from __future__ import annotations

from repro_torch.core import twiddle as tw
from repro_torch.kernels import _long

#: the opt-in shared memory of one block on sm_90 (``kMaxSmemBytes``)
SMEM_LIMIT = 232448
#: the module names :func:`launch_smem_bytes` takes
MODULES = ('fft_pencil', 'fft_fused', 'fft_matmul', 'fft_block')


def stockham_smem_bytes(n: int, P: int, ld: int) -> int:
    """The radix-2 body (``fft_pencil.cu``): the master table, then two
    buffer pairs of P rows of ``ld`` floats."""
    half = n >> 1 if n > 1 else 1
    return (2 * half + 4 * P * ld) * 4


def four_step_smem_bytes(n1: int, n2: int, P: int) -> int:
    """``four_step_kernel`` (``fft_matmul.cu``'s ``carve``): F1 with rows
    of n1 + 1, F2, W, the tile and C with rows of n2 + 1, each planar."""
    n = n1 * n2
    return (2 * n1 * (n1 + 1) + 2 * n2 * n2 + 2 * n1 * n2 + 2 * P * n
            + 2 * P * n1 * (n2 + 1)) * 4


def fft_block_smem_bytes(n1: int, n2: int, P: int, jc: int) -> int:
    """``block_kernel`` (``fft_block.cu``'s ``carve``): F1b's c = 0 half
    with rows of 2 n1 + 1, the tile, the step-2 result and ``jc`` staged
    slices of G."""
    n = n1 * n2
    return (n1 * (2 * n1 + 1) + 4 * P * n + 2 * n2 * n2 * jc) * 4


def fft_block_slices(n1: int, n2: int, P: int) -> int:
    """G slices ``block_kernel`` stages at a time: all n1 when they fit,
    else the largest power of two that does; 0 when not even one fits."""
    jc = n1
    while jc >= 1:
        if fft_block_smem_bytes(n1, n2, P, jc) <= SMEM_LIMIT:
            return jc
        jc >>= 1
    return 0


def mma_smem_bytes(n: int) -> int:
    """A block of the tensor-core body of ``four_step_mma.cuh``
    (``fft_matmul_mma_smem_bytes``, ``fft_block_mma_smem_bytes``): the
    three-factor shape's FLOATS at n = 2048 and 4096, else the
    two-factor shape's; -1 where the body does not take n."""
    if n in (2048, 4096):
        n1, n3 = 16, n // 256
        return (8 * n1 * n1 + 8 * n3 * n3 + 4 * n) * 4
    if not (tw.is_pow2(n) and 64 <= n <= 1024):
        return -1
    n1, n2 = tw.four_step_factors(n)
    tile = 2048 if n >= 1024 else 4096
    P = tile // n
    xs = 2 * n1 * (P * n2 + 8)
    cs = P * n1 * (2 * n2 + 4)
    return (8 * n1 * n1 + 8 * n2 * n2 + xs + cs) * 4


def launch_smem_bytes(name: str, n: int, batch: int) -> tuple:
    """(body, shared bytes a block) of the launch module ``name``'s
    ``variant(n)`` picks for ``batch`` pencils of n (rows of ``batch``
    for ``fft_fused``); the long body's single-pass kernel (its
    transpose takes ``_long.TRANSPOSE_SMEM_BYTES``)."""
    import importlib
    mod = importlib.import_module(f'repro_torch.kernels.{name}')
    body = mod.variant(n)
    if body == 'long':
        return body, _long.smem_bytes(n)
    if body == 'mma':
        return body, mma_smem_bytes(n)
    if body == 'radix8':
        layout = mod.tile_layout(n, batch) if name == 'fft_fused' else mod.radix8_layout(n, batch)
        return body, layout[2]
    if body == 'radix2':
        if name == 'fft_fused':
            return body, stockham_smem_bytes(n, *mod._radix2_layout(n, batch))
        return body, stockham_smem_bytes(n, mod.tile_pencils(n, batch), n)
    n1, n2 = tw.four_step_factors(n)
    P = mod.tile_pencils(n, batch)
    if name == 'fft_matmul':
        return body, four_step_smem_bytes(n1, n2, P)
    return body, fft_block_smem_bytes(n1, n2, P, max(fft_block_slices(n1, n2, P), 1))
