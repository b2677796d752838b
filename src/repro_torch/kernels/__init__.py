"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

One module per TPU kernel it replaces (same names as ``repro.kernels``):

* :mod:`.fft_pencil` — Stockham pencil FFT
* :mod:`.fft_fused` — Stockham + optional twiddle + transposed emit
* :mod:`.fft_matmul` — Bailey four-step
* :mod:`.fft_block` — block-complex four-step

Each wrapper runs its plain version on a CPU tensor and launches its
kernel on a CUDA tensor (or raises), and counts its launches in the
module's ``launches`` integer (``fft_matmul`` and ``fft_block`` also
count those of their tensor-core body, the four-step of
``csrc/four_step_mma.cuh`` that both run, in ``launches_mma``;
``fft_pencil`` and ``fft_fused`` those of their radix-8 Stockham body
in ``launches_radix8``; ``fft_fused`` those that applied twiddle planes
in ``launches_twiddle``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import twiddle as tw

KERNEL_MODULES = ('fft_pencil', 'fft_fused', 'fft_matmul', 'fft_block')


def _modules():
    import importlib
    return {m: importlib.import_module(f'repro_torch.kernels.{m}')
            for m in KERNEL_MODULES}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, per kernel module."""
    return {m: mod.launches for m, mod in _modules().items()}


def reset_launch_counts() -> None:
    """Set every launch counter of every kernel module to 0 (``launches``
    and a module's per-body counters such as ``launches_mma``)."""
    for mod in _modules().values():
        for name in list(vars(mod)):
            if name.startswith('launches'):
                setattr(mod, name, 0)


def check_planar(name: str, re: torch.Tensor, im: torch.Tensor,
                 min_ndim: int = 1) -> int:
    """Validate a planar operand for a kernel wrapper; returns n, the
    length of the last axis. Raises on anything the kernel does not
    take: mismatched or non-fp32 planes, a non-contiguous plane, a
    non-pow2 length, or a device that is neither CPU nor CUDA."""
    if re.shape != im.shape or re.device != im.device:
        raise ValueError(f"{name}: re {tuple(re.shape)} on {re.device} and "
                         f"im {tuple(im.shape)} on {im.device} differ")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"{name}: planes must be float32, got {re.dtype}/{im.dtype}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError(f"{name}: planes must be contiguous")
    if re.ndim < min_ndim:
        raise ValueError(f"{name}: needs at least {min_ndim} dims, got {tuple(re.shape)}")
    if re.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"{name}: unsupported device {re.device}")
    n = re.shape[-1]
    if not tw.is_pow2(n):
        raise ValueError(f"{name}: pencil length must be a power of two, got {n}")
    return n


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a CUDA kernel is asked for a gradient. A kernel
    writes into buffers autograd does not record, so its output would
    carry no gradient without a word; the reference's kernel tier cannot
    be differentiated either (``jax.grad`` through its ``pallas_call``
    raises). The plain versions, ``kernel='reference'``, differentiate."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, as the reference's Pallas kernel "
            "has none (jax.grad through its pallas_call raises); plan with "
            "kernel='reference' to differentiate")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream

