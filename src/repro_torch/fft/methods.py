"""The pencil-method registry of the port.

Port of ``repro.fft.methods``. Every local pencil transform of the port
dispatches through here. A method owns a plain PyTorch ``pencil_fn``
(the 'reference' tier, along the LAST axis), where one exists an
``axis_fn`` (the plain transform along ANY axis: ``four_step`` and
``block``, the reference's registry entries; :func:`apply` does not
take them and moves a non-last axis last on every tier), where one
exists a ``kernel_fn`` (the wrapper of its hand-written CUDA kernel),
and a ``real_fn``: the real-input transform, the pencil inside the
Hermitian pack/combine of :func:`repro_torch.core.fft1d.rfft_via`.

The ``kernel=`` values keep the reference's names so that options
round-trip: ``'pallas'`` names the hand-written CUDA tier here.

* ``'auto'`` runs the kernel on a CUDA tensor and the plain version on a
  CPU tensor.
* ``'pallas'`` runs the kernel; on a CPU tensor it raises (there is no
  interpret mode).
* ``'reference'`` runs the plain version.

A method without a kernel (``'direct'``) runs its plain version under
every tier, as in the reference. ``'block'`` (the block-complex
four-step) runs on planar pairs like the others: its plain version
stacks (re, im) on a leading size-2 axis inside the pencil, its kernel
takes the planes.

``compute_dtype`` (e.g. ``torch.bfloat16``) rounds the operands of the
matmul-form pencils (``four_step``, ``block``) on the reference tier;
:func:`check_compute_dtype` is the one rule for every tier.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import fft1d as f1
from repro_torch.core import twiddle as tw
from repro_torch.core.plan import KERNEL_TIERS
from repro_torch.core.twiddle import Planar
from repro_torch.kernels import fft_block, fft_fused, fft_matmul, fft_pencil

#: below this pencil length 'auto' takes Stockham butterflies instead of
#: the four-step matmul form (dense DFT for non-pow2 lengths)
AUTO_MATMUL_MIN = 64

@dataclasses.dataclass(frozen=True)
class Method:
    """One registered local pencil algorithm."""
    name: str
    pencil_fn: Callable
    axis_fn: Optional[Callable] = None
    kernel_fn: Optional[Callable] = None
    real_fn: Optional[Callable] = None
    pow2_only: bool = True
    #: its plain version rounds its products' operands to ``compute_dtype``
    casts_operands: bool = False
    description: str = ''


_REGISTRY: Dict[str, Method] = {}


def register(method: Method) -> Method:
    if method.name in _REGISTRY:
        raise ValueError(f"method {method.name!r} already registered")
    _REGISTRY[method.name] = method
    return method


def names() -> Tuple[str, ...]:
    """Registered concrete method names (excludes the 'auto' alias)."""
    return tuple(_REGISTRY)


def get(name: str) -> Method:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown FFT method {name!r}; known: {names() + ('auto',)}"
        ) from None


def validate(name: str) -> str:
    """Check ``name`` is 'auto' or a registered method; returns it."""
    if name != 'auto':
        get(name)
    return name


def resolve(name: str, n: int) -> Method:
    """Resolve a method name (including 'auto') for pencil length n:
    four-step from AUTO_MATMUL_MIN up, Stockham below, direct DFT for
    non-pow2 lengths."""
    if name == 'auto':
        if n >= AUTO_MATMUL_MIN and tw.is_pow2(n):
            return _REGISTRY['four_step']
        return _REGISTRY['stockham' if tw.is_pow2(n) else 'direct']
    return get(name)


def validate_kernel(kernel: str) -> str:
    if kernel not in KERNEL_TIERS:
        raise ValueError(f"unknown kernel tier {kernel!r}; known: {KERNEL_TIERS}")
    return kernel


def resolve_kernel(kernel: str, method: Optional[Method] = None,
                   device=None) -> str:
    """The tier that runs for a tensor on ``device``: 'pallas' (the CUDA
    kernel) or 'reference' (the plain version). A ``meta`` tensor takes
    the card's tier: its kernels return their shapes and are counted
    (the dry run)."""
    validate_kernel(kernel)
    if kernel == 'reference':
        return 'reference'
    if method is not None and method.kernel_fn is None:
        return 'reference'
    on_cuda = device is not None and torch.device(device).type in ('cuda', 'meta')
    if kernel == 'pallas' and not on_cuda:
        raise ValueError(
            f"kernel='pallas' runs the CUDA kernels and a tensor on {device} "
            "has none (no interpret mode); use kernel='auto' or 'reference'")
    return 'pallas' if on_cuda else 'reference'


def _merge_kernel_arg(kernel: str, use_kernel: bool) -> str:
    """Fold the deprecated ``use_kernel`` boolean into the tier option:
    True means 'pallas' where ``kernel`` was left at 'auto'."""
    if use_kernel and kernel == 'auto':
        return 'pallas'
    return kernel


def check_compute_dtype(m: Method, tier: str, compute_dtype) -> None:
    """The rule for ``compute_dtype`` on method ``m`` run on ``tier``.

    ``stockham`` and ``direct`` have no matrix operands and ignore it on
    every tier. ``four_step`` and ``block`` honour it on the reference
    tier; on the kernel tier their tensor-core bodies take fp32 only, so
    any type other than None or float32 raises rather than running fp32
    where a narrower product was asked for."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return
    if tier == 'pallas' and m.casts_operands:
        raise ValueError(
            f"compute_dtype={compute_dtype} is not supported by the CUDA kernels of "
            f"method {m.name!r} (fp32 operands only); plan with kernel='reference' "
            "to round the products' operands, or leave compute_dtype unset")


def check_plan_compute_dtype(method: str, kernel: str, lengths, device,
                             compute_dtype) -> None:
    """:func:`check_compute_dtype` for every pencil length a plan runs,
    at plan time (``device`` None answers for the card)."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return
    device = 'cuda' if device is None else device
    for n in lengths:
        m = resolve(method, n)
        check_compute_dtype(m, resolve_kernel(kernel, m, device), compute_dtype)


def _checked(method: str, n: int) -> Method:
    m = resolve(method, n)
    if m.pow2_only and not tw.is_pow2(n):
        raise ValueError(
            f"method {m.name!r} requires a power-of-two pencil length, "
            f"got {n} (use method='direct' or 'auto')")
    return m


def apply(re: torch.Tensor, im: torch.Tensor, *, axis: int = -1,
          inverse: bool = False, method: str = 'auto',
          kernel: str = 'auto', compute_dtype=None) -> Planar:
    """Run a registered pencil method along ``axis`` of planar (re, im).

    The kernel tier needs the pencil axis last and contiguous: a
    non-last axis is moved to the end with a ``.contiguous()`` copy (one
    extra pass over device memory) and the result is returned as a view
    in the caller's axis order. The plain tier moves it the same way (a
    view; no ``axis_fn``), so both tiers run one pencil form."""
    axis = axis % re.ndim
    m = _checked(method, re.shape[axis])
    last = axis == re.ndim - 1
    tier = resolve_kernel(kernel, m, re.device)
    check_compute_dtype(m, tier, compute_dtype)
    if not last:
        re, im = re.movedim(axis, -1), im.movedim(axis, -1)
    if tier == 'pallas':
        yr, yi = m.kernel_fn(re.contiguous(), im.contiguous(), inverse=inverse)
    else:
        yr, yi = m.pencil_fn(re, im, inverse=inverse, compute_dtype=compute_dtype)
    if not last:
        yr, yi = yr.movedim(-1, axis), yi.movedim(-1, axis)
    return yr, yi


def apply_block(x: torch.Tensor, *, axis: int, inverse: bool = False,
                kernel: str = 'auto', compute_dtype=None) -> torch.Tensor:
    """The 'block' method on the stacked form: ``x`` carries a leading
    size-2 complex axis (x[0] = re, x[1] = im) and is transformed along
    ``axis``, counted over x's own dims. The kernel tier runs
    ``fft_block`` with the axis moved last and contiguous; the plain
    tier is :func:`repro_torch.core.fft1d.fft_four_step_block`."""
    axis = axis % x.ndim
    if x.ndim < 2 or x.shape[0] != 2 or axis == 0:
        raise ValueError(f"apply_block takes (2, ..., n) and a data axis, got "
                         f"{tuple(x.shape)} and axis {axis}")
    m = _checked('block', x.shape[axis])
    tier = resolve_kernel(kernel, m, x.device)
    check_compute_dtype(m, tier, compute_dtype)
    if tier == 'reference':
        return f1.fft_four_step_block(x, axis, inverse=inverse, compute_dtype=compute_dtype)
    last = axis == x.ndim - 1
    y = fft_block.fft_block((x if last else x.movedim(axis, -1)).contiguous(),
                            inverse=inverse)
    return y if last else y.movedim(-1, axis)


def apply_fused(re: torch.Tensor, im: torch.Tensor, *, inverse: bool = False,
                method: str = 'auto', kernel: str = 'auto',
                wr=None, wi=None, compute_dtype=None) -> Planar:
    """One fused superstep: FFT along the LAST axis, an optional planar
    twiddle, and the last two axes exchanged,
    ``out[..., k, j] = (W * FFT(x))[..., j, k]``.

    On the kernel tier Stockham runs the fused CUDA kernel (one pass);
    other methods run their kernel and return a transposed view."""
    if re.ndim < 2:
        raise ValueError("apply_fused needs a batch axis next to the "
                         f"pencil axis, got shape {tuple(re.shape)}")
    m = _checked(method, re.shape[-1])
    tier = resolve_kernel(kernel, m, re.device)
    check_compute_dtype(m, tier, compute_dtype)
    if tier == 'pallas':
        re, im = re.contiguous(), im.contiguous()
        if m.name == 'stockham':
            return fft_fused.fft_twiddle_transpose(re, im, wr, wi, inverse=inverse)
        yr, yi = m.kernel_fn(re, im, inverse=inverse)
        if wr is not None:
            yr, yi = tw.cmul(yr, yi, wr, wi)
        return yr.transpose(-1, -2), yi.transpose(-1, -2)
    return f1.fft_twiddle_transpose(re, im, wr, wi, inverse=inverse,
                                    fft_fn=m.pencil_fn, compute_dtype=compute_dtype)


def apply_real(x: torch.Tensor, im: Optional[torch.Tensor] = None, *,
               axis: int = -1, inverse: bool = False, method: str = 'auto',
               kernel: str = 'auto', compute_dtype=None):
    """Run a method's real-input transform along ``axis``.

    Forward (``im is None``): real tensor -> planar half spectrum, the
    axis going n -> n//2 + 1 (``np.fft.rfft``'s layout). Inverse: planar
    half spectrum ``(x, im)`` -> real tensor. 'auto' resolves by the
    half length n//2, the length of the complex pencil inside.

    On the kernel tier that length-n/2 complex FFT runs the method's
    CUDA kernel (the reference runs its plain pencil there for Stockham
    and four-step); the Hermitian combine is plain tensor ops on both
    tiers. A non-last axis is moved last and the result returned as a
    view in the caller's axis order."""
    axis = axis % x.ndim
    if inverse:
        if im is None:
            raise ValueError("inverse real transform takes a planar (re, im) half spectrum")
        n = 2 * (x.shape[axis] - 1)
    else:
        if im is not None:
            raise ValueError("forward real transform takes ONE real tensor")
        n = x.shape[axis]
    if n % 2:
        raise ValueError(f"real transforms need an even length, got {n}")
    m = _checked(method, max(n // 2, 1))
    tier = resolve_kernel(kernel, m, x.device)
    check_compute_dtype(m, tier, compute_dtype)
    if tier == 'pallas':
        # the pack reads every other element: the kernel takes contiguous planes
        real_fn = f1.rfft_via(lambda r, i, *, inverse, compute_dtype: m.kernel_fn(
            r.contiguous(), i.contiguous(), inverse=inverse))
    else:
        real_fn = m.real_fn
    last = axis == x.ndim - 1
    if not last:
        x = x.movedim(axis, -1)
        im = None if im is None else im.movedim(axis, -1)
    if inverse:
        y = real_fn(x, im, inverse=True, compute_dtype=compute_dtype)
        return y if last else y.movedim(-1, axis)
    yr, yi = real_fn(x, compute_dtype=compute_dtype)
    if not last:
        yr, yi = yr.movedim(-1, axis), yi.movedim(-1, axis)
    return yr, yi


def _block_pencil(re, im, *, inverse=False, compute_dtype=None) -> Planar:
    y = f1.fft_four_step_block(torch.stack([re, im]), -1, inverse=inverse,
                               compute_dtype=compute_dtype)
    return y[0], y[1]


def _block_axis(re, im, axis, *, inverse=False, compute_dtype=None) -> Planar:
    """The 'block' method along ``axis`` of a planar pair, through the
    stacked form (:func:`apply_block`), as the reference's."""
    y = apply_block(torch.stack([re, im]), axis=axis % re.ndim + 1, inverse=inverse,
                    compute_dtype=compute_dtype)
    return y[0], y[1]


register(Method(
    name='stockham',
    pencil_fn=f1.fft_stockham,
    kernel_fn=fft_pencil.fft_pencil,
    real_fn=f1.rfft_via(f1.fft_stockham),
    description='radix-2 Stockham autosort butterflies (paper-faithful)'))

register(Method(
    name='four_step',
    pencil_fn=f1.fft_four_step,
    axis_fn=f1.fft_four_step_axis,
    kernel_fn=fft_matmul.fft_matmul,
    real_fn=f1.rfft_via(f1.fft_four_step),
    casts_operands=True,
    description='Bailey four-step as dense DFT products'))

register(Method(
    name='block',
    pencil_fn=_block_pencil,
    axis_fn=_block_axis,
    kernel_fn=fft_block.fft_block_planar,
    real_fn=f1.rfft_via(_block_pencil),
    casts_operands=True,
    description='block-complex four-step: two real contractions, folded twiddle'))

register(Method(
    name='direct',
    pencil_fn=f1.dft_direct,
    real_fn=f1.rfft_via(f1.dft_direct),
    pow2_only=False,
    description='dense O(n^2) DFT matrix (oracle / non-pow2 sizes)'))
