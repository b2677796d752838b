"""The public plan/execute facade: ``repro_torch.fft.plan(...)`` -> ``FFT``.

Port of ``repro.fft.api``. A plan is built once and executed many
times. Rank 1 is the distributed four-step over the flattened mesh
(:mod:`repro_torch.fft.large1d`, the length n factored n1*n2), ranks 2
and 3 the pencil decomposition (:mod:`repro_torch.fft.pencil`). A
complex plan's ``forward``/``inverse`` take a complex64 tensor or a
planar ``(re, im)`` pair of float32 tensors, with any number of leading
batch dims, and return the same form. A real plan (:func:`rplan`,
``np.fft.rfftn`` semantics) takes ONE real float32 tensor forward and
returns the complex64 half spectrum; its inverse takes the half
spectrum (complex64 or planar) and returns the real tensor.

On a one-rank mesh the operand is the whole array. On a multi-rank mesh
each rank passes its LOCAL block under :attr:`FFT.in_layout` (see
``FFTMesh.shard``) and gets its block under :attr:`FFT.out_layout`, as
the reference's local function sees it inside ``shard_map``. A rank-1
plan's block is a contiguous run of n/p elements; a real rank-1 plan's
spectrum (``np.fft.rfft``'s n//2 + 1 bins) is whole on every rank, as
in the reference.

``comm='auto'`` (the default) resolves the strategy, the overlap depth
and, with ``method='auto'``, the method through the reference's cost
model (:func:`repro_torch.comm.cost.select`) on every mesh, the
abstract ones (``abstract_fft_mesh``) included; :meth:`FFT.cost_report`
prints the priced schedule.

:func:`plan_op` plans a fused spectral operator (forward -> pointwise
-> inverse, the spectrum kept in its native distributed layout):
:class:`SpectralOp`, with :func:`spectral_mul` as the usual pointwise.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import cost as costlib
from repro_torch.comm import strategies
from repro_torch.core import _deprecated
from repro_torch.core import twiddle as tw
from repro_torch.core.plan import Layout, PencilPlan
from repro_torch.fft import large1d, methods, pencil


def _default_axes(mesh, batch_spec) -> Tuple[str, ...]:
    """Every mesh axis but ``batch_spec``."""
    axes = tuple(a for a in mesh.axis_names if a != batch_spec)
    if not axes:
        raise ValueError(f"mesh {mesh.axis_names} has no FFT axes left "
                         f"after reserving batch_spec={batch_spec!r}")
    return axes


def plan(shape: Sequence[int], mesh, *, method: str = 'auto',
         compute_dtype=None, kernel: str = 'auto', use_kernel: bool = False,
         mesh_axes: Optional[Tuple[str, ...]] = None,
         layout: Optional[Layout] = None, comm: str = 'auto',
         overlap_chunks: Optional[int] = None, wire_dtype: str = 'native',
         restore_layout: bool = False, batch_spec: Optional[str] = None,
         real: bool = False, padded_spectrum: bool = False,
         donate: bool = True) -> 'FFT':
    """Plan a distributed FFT of a rank-1, rank-2 or rank-3 array.

    Args mirror ``repro.fft.plan``:
      shape: global transform shape, each axis a power of two. Rank 1
        factors n = n1*n2 (``four_step_factors``); the group of
        ``mesh_axes`` must divide both factors.
      mesh: the port's mesh (``repro_torch.launch.mesh.make_fft_mesh``).
      method: 'auto' | 'stockham' | 'four_step' | 'block' | 'direct'.
      compute_dtype: operand type of the matmul-form pencils' products
        (e.g. ``torch.bfloat16``, the paper's half-precision study):
        ``four_step`` and ``block`` round their matrices and operands to
        it and accumulate in fp32, on ``kernel='reference'`` only. The
        CUDA bodies take fp32 operands, so on the kernel tier those two
        methods raise ``ValueError`` for any type but float32;
        ``stockham`` and ``direct`` ignore it on every tier.
      kernel: 'auto' (CUDA kernels on a CUDA tensor, plain versions on
        a CPU tensor) | 'pallas' (the CUDA kernels; raises on the CPU) |
        'reference' (plain versions).
      use_kernel: deprecated alias of ``kernel='pallas'`` (applies when
        ``kernel`` is 'auto'); warns once.
      mesh_axes / layout: initial ownership, as in the reference: the
        (row, col) pair of rank 3; the axes ranks 1 and 2 flatten into
        one group. ``layout`` is for ranks 2/3 only. The default is
        every mesh axis but ``batch_spec`` (rank 3: ('x', 'y') where the
        mesh has both).
      comm: 'auto' | 'all_to_all' | 'ppermute' | 'hierarchical' |
        'pod_tree:<spec>'. 'auto' prices the schedule under every
        strategy with the paper's cycle model (under ``wire_dtype``, a
        real plan on its half spectrum) and takes the reference's pick
        of strategy, overlap depth and (with ``method='auto'``) method;
        rank 1 prices its four-step (``large1d_plan_cost``) and keeps one
        overlap chunk unless asked.
      overlap_chunks: pipeline each (fft, swap) pair over this many
        chunks of a free local axis, the swap of chunk i in flight while
        chunk i+1 computes; rank 1 pipelines its whole four-step over
        chunks of the leading batch. Default: the selector's pick under
        ``comm='auto'`` (ranks 2/3), else 1.
      wire_dtype: 'native' | 'fp16' | 'bf16' cast around each swap.
      restore_layout: forward and inverse consume and produce the input
        layout (extra swaps).
      batch_spec: a mesh axis (e.g. 'pod' of ``make_fft_mesh(...,
        pods=2)``) that ONE leading batch dim is sharded over: each rank
        passes its slice of the batch, and every transform stays inside
        one slice of that axis (its swaps run over the other axes'
        groups). Without it any leading dims are a replicated batch.
      real: an rfft/irfft plan (see :func:`rplan`): the last axis is
        transformed real-to-complex in the first superstep, and every
        later superstep and swap moves its half spectrum.
      padded_spectrum: real plans of rank 2/3 only. The half axis (n//2 + 1, odd)
        travels zero-padded to an extent every owning group divides. By
        default the forward slices the pad off (``np.fft.rfftn``'s
        layout; on a multi-rank mesh each rank keeps its part of it, the
        ranks that hold pad bins fewer) and the inverse puts it back;
        with ``padded_spectrum=True`` the padded spectrum is the
        operand, as the reference's native spectrum.
      donate: kept so options round-trip; the port never writes into an
        operand (its kernels are out of place), see
        :attr:`FFT.donates_input`.
    """
    shape = tuple(int(s) for s in shape)
    rank = len(shape)
    if rank not in (1, 2, 3):
        raise ValueError(f"repro_torch.fft.plan supports ranks 1-3, got shape {shape}")
    if real and shape[-1] % 2:
        raise ValueError(f"real plans need an even last axis, got {shape}")
    if padded_spectrum and not real:
        raise ValueError("padded_spectrum applies to real plans only")
    if padded_spectrum and rank == 1:
        raise ValueError("padded_spectrum applies to real plans of rank 2/3 only; a "
                         "rank-1 spectrum is whole on every rank")
    methods.validate(method)
    methods.validate_kernel(kernel)
    if use_kernel:
        _deprecated.warn_once('repro_torch.fft.plan(use_kernel=)', "kernel='pallas'")
        kernel = methods._merge_kernel_arg(kernel, use_kernel)
    comm = strategies.validate(comm)
    strategies.validate_wire_dtype(wire_dtype)
    if batch_spec is not None and batch_spec not in mesh.axis_names:
        raise ValueError(f"batch_spec {batch_spec!r} not a mesh axis of {mesh.axis_names}")
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    opts = dict(kernel=kernel, compute_dtype=compute_dtype, wire_dtype=wire_dtype,
                restore_layout=restore_layout, real=real, batch_spec=batch_spec,
                donate=donate)
    if rank == 1:
        if layout is not None:
            raise ValueError("layout applies to ranks 2/3 only; rank-1 plans take mesh_axes")
        axes = tuple(mesh_axes) if mesh_axes is not None else _default_axes(mesh, batch_spec)
        n1, n2 = tw.four_step_factors(shape[0])
        p = strategies.static_group_size(axes, mesh.shape)
        if n1 % p or n2 % p:
            raise ValueError(
                f"rank-1 FFT of n={shape[0]} factors as {n1}x{n2}; the {p} devices "
                f"of mesh axes {axes} must divide both factors")
        comm, oc, method = _resolve_comm_1d((n1, n2), axes, mesh.shape, comm,
                                            overlap_chunks, method, real, wire_dtype)
        strategies.check_runnable(comm)
        methods.check_plan_compute_dtype(
            method, kernel, _pencil_lengths((n1, n2), 0 if real else None), mesh.device,
            compute_dtype)
        return FFT(shape=shape, mesh=mesh, method=method, comm=comm, overlap_chunks=oc,
                   axes1d=axes, factors=(n1, n2), **opts)
    if layout is None:
        if rank == 2:
            axes = tuple(mesh_axes) if mesh_axes is not None else _default_axes(mesh, batch_spec)
            layout = (axes if len(axes) > 1 else axes[0], None)
        elif mesh_axes is not None:
            if len(mesh_axes) != 2:
                raise ValueError(
                    f"rank-3 mesh_axes must be a (row, col) pair of mesh "
                    f"axis names, got {mesh_axes!r}")
            layout = (mesh_axes[0], mesh_axes[1], None)
        else:
            cand = _default_axes(mesh, batch_spec)
            if 'x' in cand and 'y' in cand:
                layout = ('x', 'y', None)
            elif len(cand) >= 2:
                layout = (cand[0], cand[1], None)
            else:
                raise ValueError(f"rank-3 FFT needs two mesh axes, mesh has {cand}")
    comm, oc, method = _resolve_comm(shape, tuple(layout), mesh.shape, comm,
                                     overlap_chunks, method, real, wire_dtype)
    strategies.check_runnable(comm)
    methods.check_plan_compute_dtype(
        method, kernel, _pencil_lengths(shape, -1 if real else None), mesh.device,
        compute_dtype)
    pplan = PencilPlan(shape=shape, mesh=mesh, layout=tuple(layout),
                       method=method, kernel=kernel, comm=comm, real=real,
                       wire_dtype=wire_dtype, compute_dtype=compute_dtype)
    pplan.validate()
    return FFT(shape=shape, mesh=mesh, method=method, comm=comm, overlap_chunks=oc,
               padded_spectrum=padded_spectrum, pplan=pplan, **opts)


def _pencil_lengths(lengths, real_pos: Optional[int]) -> Tuple[int, ...]:
    """The complex pencil lengths a plan runs: the real-to-complex axis
    (``real_pos``; the column factor at rank 1, the last axis above)
    runs pencils of half its length."""
    lengths = list(lengths)
    if real_pos is not None:
        lengths[real_pos] = max(lengths[real_pos] // 2, 1)
    return tuple(lengths)


def rplan(shape: Sequence[int], mesh, **kw) -> 'FFT':
    """:func:`plan` with ``real=True``: the forward takes a real tensor
    and returns the half spectrum (last axis n//2 + 1), at about half
    the bytes and pencil work of the complex plan."""
    return plan(shape, mesh, real=True, **kw)


def spectral_mul(ar: torch.Tensor, ai: torch.Tensor, k) -> Tuple[torch.Tensor, torch.Tensor]:
    """The complex spectral product ``(ar + i ai) * (kr + i ki)`` of a
    planar spectrum and a planar factor ``k = (kr, ki)``: the usual
    pointwise stage of an operator plan (convolution, a Green's
    function). Each product rounds to fp32 on its own (eager PyTorch
    runs each as its own kernel and never contracts one into an FMA), so
    a fused operator and the unfused forward -> product -> inverse
    composition give the same bits. For finite values these are the
    bits of the reference's contraction-pinned product. Conjugation-
    equivariant, as the real rank-1 operator needs. Leading batch dims
    broadcast."""
    kr, ki = k
    return ar * kr - ai * ki, ar * ki + ai * kr


def plan_op(shape: Sequence[int], mesh, *, op: Callable, op_name: Optional[str] = None,
            real: bool = True, n_spectra: int = 0, spectra=None,
            spectra_form: str = 'plan', **kw) -> 'SpectralOp':
    """Plan a fused spectral OPERATOR: forward -> ``op`` -> inverse as one
    plan whose interior spectrum stays in its native distributed layout
    (a real rank-2/3 plan's padded half spectrum, the rank-1 four-step's
    own form), so the boundary gather and scatter of two back-to-back
    plans never happen.

    Args:
      shape, mesh: as :func:`plan`, whose options (``method``,
        ``kernel``, ``comm``, ``wire_dtype``, ``overlap_chunks``,
        ``compute_dtype``, ``donate``, ``mesh_axes``, ``layout``) pass
        through ``**kw``; ``batch_spec`` and ``restore_layout`` do not
        apply.
      op: the pointwise stage, ``op(re, im, *spectra) -> (re, im)``,
        called with this rank's block of the planar spectrum and one
        planar pair an extra spectrum (runtime ones first, then the
        baked ones in order). It must be elementwise in the bins and,
        for a real plan, conjugation-equivariant (any multiplicative
        factor is, :func:`spectral_mul`). Leading batch dims broadcast
        numpy-style across operands, e.g. a (B, d, n) signal against a
        (d, n) kernel.
      op_name: a tag for reports (default ``op.__name__``).
      real: operate on real arrays (rfft -> op -> irfft); False fuses a
        complex fft -> op -> ifft.
      n_spectra: extra RUNTIME operands :meth:`SpectralOp.apply` takes
        after the main one, each forward-transformed in the same call.
      spectra: static factors baked into the plan, transformed once at
        the first ``apply`` (:attr:`SpectralOp.bake_count`) and kept in
        the native layout. Global arrays (numpy or torch); each rank
        keeps its block.
      spectra_form: ``'plan'``: ``spectra`` are operand-space arrays
        (real for a real plan), transformed by this operator's own
        forward; ``'spectrum'``: already-transformed arrays in
        ``np.fft.rfftn`` order (complex plans ``np.fft.fftn``), e.g. an
        analytically known Green's function.
    """
    if not callable(op):
        raise ValueError(f"op must be callable, got {type(op).__name__}")
    if spectra_form not in ('plan', 'spectrum'):
        raise ValueError(f"spectra_form must be 'plan' or 'spectrum', got {spectra_form!r}")
    n_spectra = int(n_spectra)
    if n_spectra < 0:
        raise ValueError(f"n_spectra must be >= 0, got {n_spectra}")
    if kw.pop('restore_layout', False):
        raise ValueError("operator plans fuse forward and inverse back to the input "
                         "layout; restore_layout does not apply")
    if kw.pop('batch_spec', None) is not None:
        raise ValueError("operator plans batch over replicated leading dims; "
                         "batch_spec is not supported")
    kw.pop('padded_spectrum', None)   # derived: the interior is the native spectrum
    base = plan(shape, mesh, real=real, padded_spectrum=real and len(tuple(shape)) > 1, **kw)
    return SpectralOp(shape=base.shape, mesh=mesh, method=base.method,
                      compute_dtype=base.compute_dtype, kernel=base.kernel,
                      comm=base.comm, overlap_chunks=base.overlap_chunks,
                      wire_dtype=base.wire_dtype, real=real,
                      padded_spectrum=base.padded_spectrum, donate=base.donate,
                      pplan=base._pplan, axes1d=base._axes1d, factors=base._factors,
                      op=op, op_name=op_name, n_spectra=n_spectra, spectra=spectra,
                      spectra_form=spectra_form)


def _resolve_comm(shape, layout, mesh_shape, comm, overlap_chunks, method,
                  real=False, wire_dtype='native'):
    """(strategy, overlap_chunks, method). Explicit choices win; an
    explicit strategy keeps one overlap chunk unless asked. Under
    comm='auto' the selector prices the schedule under the plan's wire
    format, as the reference's does."""
    if comm != 'auto':
        return comm, 1 if overlap_chunks is None else overlap_chunks, method
    sel = costlib.select(shape, layout, mesh_shape, method=method, real=real,
                         wire_dtype=wire_dtype)
    oc = overlap_chunks if overlap_chunks is not None else sel.overlap_chunks
    meth = sel.method if method == 'auto' else method
    return sel.strategy, oc, meth


def _resolve_comm_1d(factors, axes, mesh_shape, comm, overlap_chunks, method,
                     real=False, wire_dtype='native'):
    """Rank-1 (strategy, overlap_chunks, method): under comm='auto' the
    strategy of the cheapest four-step schedule (``large1d_plan_cost``)
    over the registered names and the selector's pod trees, and with
    method='auto' the method both factor lengths pick (a real plan's
    column pencil is n1/2 long). Overlap stays 1 unless asked: it needs
    a batch, which only the operand shows."""
    oc = 1 if overlap_chunks is None else overlap_chunks
    mesh_axes = tuple(axes) if len(axes) > 1 else axes[0]
    if comm == 'auto':
        n1, n2 = factors
        cand = strategies.names() + tuple(
            t for t in costlib._tree_candidates(mesh_shape, 'auto', None)
            if t not in strategies.names())
        costs = {name: costlib.large1d_plan_cost(
                     n1, n2, mesh_axes, mesh_shape, method=method, strategy=name,
                     real=real, wire_dtype=wire_dtype)
                 for name in cand}
        comm = min(costs, key=lambda k: costs[k].cycles)
        if method == 'auto':
            lens = (max(n1 // 2, 1), n2) if real else factors
            picks = {costlib.select_method(n) for n in lens}
            method = picks.pop() if len(picks) == 1 else 'auto'
    return comm, oc, method


class FFT:
    """A planned distributed FFT: build once, execute many times.

    ``inverse(forward(x))`` is a round trip: the inverse consumes the
    forward's output layout and restores the input layout. A real plan
    changes the boundary types only: ``forward`` takes a real tensor of
    the planned shape and returns the complex half spectrum
    (:attr:`spectrum_shape`), ``inverse`` takes the half spectrum and
    returns the real tensor. With ``batch_spec`` an operand has exactly
    one leading batch dim, this rank's slice of the batch."""

    def __init__(self, *, shape, mesh, method: str, kernel: str, comm: str,
                 wire_dtype: str, real: bool, overlap_chunks: int = 1,
                 restore_layout: bool = False, padded_spectrum: bool = False,
                 donate: bool = True, compute_dtype=None, batch_spec=None,
                 pplan: Optional[PencilPlan] = None,
                 axes1d: Optional[Tuple[str, ...]] = None,
                 factors: Optional[Tuple[int, int]] = None):
        self.shape = tuple(shape)
        self.rank = len(self.shape)
        self.mesh = mesh
        self.method = method
        self.kernel = kernel
        self.comm = comm
        self.wire_dtype = wire_dtype
        self.overlap_chunks = overlap_chunks
        self.restore_layout = restore_layout
        self.real = real
        self.padded_spectrum = padded_spectrum
        self.donate = donate
        self.compute_dtype = compute_dtype
        self.batch_spec = batch_spec
        self._pplan = pplan
        self._axes1d = axes1d
        self._factors = factors
        self._fns = {}

    def __repr__(self) -> str:
        return (f"FFT(shape={self.shape}, real={self.real}, method={self.method!r}, "
                f"kernel={self.kernel!r}, comm={self.comm!r}, mesh={self.mesh}, "
                f"batch_spec={self.batch_spec!r})")

    @property
    def resolved_kernel(self) -> str:
        """The tier the last superstep's pencils run on this plan's
        device: 'pallas' (CUDA kernels) or 'reference'. An abstract mesh
        has no device and answers for the card, the default."""
        device = 'cuda' if self.mesh.device is None else self.mesh.device
        n = self._factors[1] if self.rank == 1 else self.shape[-1]
        return methods.resolve_kernel(self.kernel, methods.resolve(self.method, n), device)

    @property
    def donates_input(self) -> bool:
        """Always False in the port: every kernel writes a new buffer, so
        the operand stays valid after ``forward``/``inverse``."""
        return False

    # -- options ------------------------------------------------------------

    def _options(self) -> dict:
        """Every resolved option a re-plan needs; operator plans extend it."""
        kw = dict(method=self.method, compute_dtype=self.compute_dtype,
                  kernel=self.kernel, comm=self.comm,
                  overlap_chunks=self.overlap_chunks,
                  wire_dtype=self.wire_dtype,
                  restore_layout=self.restore_layout, batch_spec=self.batch_spec,
                  real=self.real, padded_spectrum=self.padded_spectrum,
                  donate=self.donate)
        if self.rank == 1:
            kw['mesh_axes'] = self._axes1d
        else:
            kw['layout'] = self._pplan.layout
        return kw

    def _replan(self, kw: dict) -> 'FFT':
        if not kw['real']:
            kw['padded_spectrum'] = False
        return plan(self.shape, self.mesh, **kw)

    def with_options(self, **overrides) -> 'FFT':
        """Re-plan with some options changed; everything else carries
        over already resolved. Operator plans round-trip their own
        options the same way."""
        kw = self._options()
        kw.update(overrides)
        return self._replan(kw)

    # -- layouts and shapes -------------------------------------------------

    @property
    def _mesh_axis_1d(self):
        return self._axes1d if len(self._axes1d) > 1 else self._axes1d[0]

    @property
    def in_layout(self) -> Layout:
        if self.rank == 1:
            return (self._mesh_axis_1d,)
        return self._pplan.layout

    @property
    def _rotated_layout(self) -> Layout:
        """Where the forward leaves the data (ranks 2/3)."""
        if self.restore_layout:
            return self.in_layout
        return pencil.forward_schedule(self._pplan.layout, self._pplan.real_axis)[1]

    @property
    def out_layout(self) -> Layout:
        """The forward's output layout. A rank-1 plan's is its input
        layout, or for a real plan ``(None,)``: the whole spectrum on
        every rank. A rank-2/3 real plan's unpadded spectrum on one rank
        has its whole half axis in memory, reported as the reference
        reports it (``None``); on several ranks each keeps its part of
        the half axis under the rotated layout (see
        :meth:`spectrum_local_shape`)."""
        if self.rank == 1:
            return (None,) if self.real else self.in_layout
        lay = self._rotated_layout
        if self.real and not self.padded_spectrum and self.mesh.size == 1:
            return lay[:-1] + (None,)
        return lay

    @property
    def _real_pad(self) -> int:
        """On-wire (padded) extent of the half axis (ranks 2/3)."""
        return pencil.real_padded_extent(self.shape, self._pplan.layout,
                                         self.mesh.shape,
                                         restore_layout=self.restore_layout)

    @property
    def spectrum_shape(self) -> Tuple[int, ...]:
        """Global shape of the forward's output: ``shape`` for a complex
        plan; for a real plan the half spectrum, last axis n//2 + 1, or
        its padded extent under ``padded_spectrum``."""
        if not self.real:
            return self.shape
        if self.padded_spectrum:
            return self.shape[:-1] + (self._real_pad,)
        return self.shape[:-1] + (pencil.real_half_extent(self.shape[-1]),)

    def local_shape(self, layout: Layout) -> Tuple[int, ...]:
        """This rank's block shape of the planned array under ``layout``."""
        return tuple(s // strategies.static_group_size(o, self.mesh.shape)
                     for s, o in zip(self.shape, layout))

    def spectrum_local_shape(self, position: Optional[int] = None) -> Tuple[int, ...]:
        """This rank's block of the forward's output (or the block of the
        rank at mesh ``position``). For an unpadded real spectrum the pad
        lies in the trailing shards of the half axis, so a rank keeps the
        bins below n//2 + 1 of its padded block."""
        if not self.real:
            return self.local_shape(self.out_layout)
        if self.rank == 1:
            return self.spectrum_shape
        lay = self._rotated_layout
        blk = pencil.packed_plan(self._pplan, self._real_pad).local_shape(lay)
        if self.padded_spectrum:
            return blk
        owner = lay[-1]
        first = 0
        if strategies.static_group_size(owner, self.mesh.shape) > 1:
            first = self.mesh.group_index(owner, position) * blk[-1]
        keep = min(blk[-1], max(0, pencil.real_half_extent(self.shape[-1]) - first))
        return blk[:-1] + (keep,)

    # -- cache sizing ---------------------------------------------------------

    def operand_nbytes(self, dtype=None, *, spectrum: bool = False) -> int:
        """Global bytes of ONE operand: the planned array (real for a
        real plan), or with ``spectrum=True`` the forward's output
        (:attr:`spectrum_shape`, complex). ``dtype`` is a numpy or torch
        type; the default complex64, or float32 for a real plan's input."""
        shape = self.spectrum_shape if spectrum else self.shape
        if dtype is None:
            dtype = torch.complex64 if spectrum or not self.real else torch.float32
        size = dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
        return math.prod(shape) * size

    @property
    def cached_executables(self) -> int:
        """The per-rank functions this plan holds: one a direction it has
        run (and, for an operator plan, one a set of operand batch
        ranks). Each takes any batch, so unlike the reference's jitted
        executables they are not one a batch shape."""
        return len(self._fns)

    def clear_cache(self) -> None:
        """Drop every cached per-rank function; the plan stays usable and
        builds them again on its next call."""
        self._fns.clear()

    # -- cost model -----------------------------------------------------------

    def plan_cost(self, precision: str = 'fp32', *, measured='auto') -> costlib.PlanCost:
        """The paper's cycle model applied to this plan's schedule under
        its resolved strategy, method and overlap (WSE cycles, not a GPU
        time). ``measured=None`` forces the analytic model."""
        if self.rank == 1:
            n1, n2 = self._factors
            return costlib.large1d_plan_cost(
                n1, n2, self._mesh_axis_1d, self.mesh.shape, precision=precision,
                method=self.method, strategy=self.comm,
                overlap_chunks=self.overlap_chunks, real=self.real,
                measured=measured, wire_dtype=self.wire_dtype,
                kernel=self.resolved_kernel)
        return costlib.pencil_plan_cost(
            self.shape, self._pplan.layout, self.mesh.shape, precision=precision,
            method=self.method, strategy=self.comm,
            overlap_chunks=self.overlap_chunks, real=self.real,
            padded_spectrum=self.padded_spectrum or not self.real,
            measured=measured, wire_dtype=self.wire_dtype,
            kernel=self.resolved_kernel)

    def cost_report(self, precision: str = 'fp32') -> str:
        """Predicted cycles per superstep and swap, beside the paper's
        Table 1 where the configuration is one it measured."""
        return costlib.format_report(self.plan_cost(precision), self.shape,
                                     self.mesh.shape)

    # -- execution ----------------------------------------------------------

    def forward(self, x):
        """FFT of ``x``: a complex64 tensor or planar float32 pair, or for
        a real plan ONE real float32 tensor (returns complex64)."""
        return self._apply('fwd', x)

    def inverse(self, x):
        """IFFT of ``x``; a round trip with :meth:`forward`. A real plan
        takes the half spectrum and returns the real tensor."""
        return self._apply('inv', x)

    def _operand(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            if a.device.type != self.mesh.device.type:
                raise ValueError(f"operand on {a.device}, plan on {self.mesh.device}")
            return a
        return torch.as_tensor(a, device=self.mesh.device)

    def _fn(self, direction: str):
        fn = self._fns.get(direction)
        if fn is None:
            inverse = direction == 'inv'
            if self.rank == 1:
                n1, n2 = self._factors
                kw = dict(inverse=inverse, method=self.method, kernel=self.kernel,
                          comm=self.comm, overlap_chunks=self.overlap_chunks,
                          wire_dtype=self.wire_dtype, compute_dtype=self.compute_dtype)
                if self.real:
                    # the real four-step mirrors itself on the same (n1, n2) view
                    fn = large1d.make_rfft1d_large(n1, n2, self.mesh, self._axes1d, **kw)
                else:
                    # the inverse reads the forward's natural-order output
                    # as the (n2, n1) view: the factors swap
                    f1, f2 = (n2, n1) if inverse else (n1, n2)
                    fn = large1d.make_fft1d_large(f1, f2, self.mesh, self._axes1d,
                                                  natural_order=True, **kw)
            else:
                fn, _, _ = pencil.make_fft(self._pplan, inverse=inverse,
                                           restore_layout=self.restore_layout,
                                           overlap_chunks=self.overlap_chunks)
            self._fns[direction] = fn
        return fn

    def _split(self, x):
        """(re, im, planar) of a complex64 tensor or a planar float32 pair."""
        planar = isinstance(x, (tuple, list))
        if planar:
            re, im = (self._operand(a) for a in x)
            if re.shape != im.shape or re.dtype != im.dtype:
                raise ValueError(
                    f"planar operand mismatch: re is {re.dtype}{tuple(re.shape)}, "
                    f"im is {im.dtype}{tuple(im.shape)}")
            if re.dtype != torch.float32:
                raise TypeError(f"planar operands must be float32, got {re.dtype}")
            return re, im, True
        x = self._operand(x)
        if x.dtype != torch.complex64:
            raise TypeError(f"complex operands must be complex64, got {x.dtype}")
        return x.real, x.imag, False

    def _real_operand(self, x) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            raise ValueError("real plan forward takes ONE real tensor, not a planar pair")
        x = self._operand(x)
        if x.is_complex():
            raise ValueError(f"real plan forward takes a REAL tensor, got {x.dtype}")
        if x.dtype != torch.float32:
            raise TypeError(f"real operands must be float32, got {x.dtype}")
        return x

    def _batch(self, shape, core) -> Tuple[int, ...]:
        """The leading batch shape of an operand whose trailing dims must
        be ``core``; exactly one dim under ``batch_spec``."""
        shape = tuple(shape)
        if len(shape) < self.rank or shape[len(shape) - self.rank:] != tuple(core):
            raise ValueError(
                f"operand shape {shape} does not end with this rank's block "
                f"{tuple(core)} of the planned transform {self.shape}")
        batch = shape[:len(shape) - self.rank]
        if self.batch_spec is not None and len(batch) != 1:
            raise ValueError(
                f"plan with batch_spec={self.batch_spec!r} takes exactly one leading "
                f"batch dim, got batch shape {batch}")
        return batch

    def _apply(self, direction: str, x):
        if self.mesh.device is None:
            raise RuntimeError(
                f"{self.mesh} prices plans and cannot run them; plan on "
                "make_fft_mesh to execute")
        if self.real:
            if self.rank == 1:
                return self._apply_real_1d(direction, x)
            return self._apply_real(direction, x)
        re, im, planar = self._split(x)
        lay_in, lay_out = ((self.in_layout, self.out_layout) if direction == 'fwd'
                           else (self.out_layout, self.in_layout))
        core = self.local_shape(lay_in)
        batch_shape = self._batch(re.shape, core)
        flat = (math.prod(batch_shape),)
        if self.rank == 1:
            # the four-step's row-major view of this rank's rows; its
            # natural-order output, and so the inverse's input, is (n2, n1)
            n1, n2 = self._factors
            f1, f2 = (n2, n1) if direction == 'inv' else (n1, n2)
            p = self.shape[0] // core[0]
            core = (f1 // p, f2)
        yr, yi = self._fn(direction)(re.reshape(flat + core), im.reshape(flat + core))
        out = batch_shape + self.local_shape(lay_out)
        yr, yi = yr.reshape(out), yi.reshape(out)
        return (yr, yi) if planar else torch.complex(yr, yi)

    def _apply_real(self, direction: str, x):
        """The real plan's boundary: the pipeline speaks the padded half
        spectrum; the forward slices the pad off its trailing shards
        unless ``padded_spectrum`` and the inverse puts it back."""
        real_core = self.local_shape(self.in_layout)
        spec_core = self.spectrum_local_shape()
        wire = self._real_pad // strategies.static_group_size(
            self._rotated_layout[-1], self.mesh.shape)
        if direction == 'fwd':
            x = self._real_operand(x)
            batch_shape = self._batch(x.shape, real_core)
            yr, yi = self._fn('fwd')(x.reshape((math.prod(batch_shape),) + real_core))
            keep = spec_core[-1]
            if keep != wire:
                yr, yi = yr[..., :keep], yi[..., :keep]
            out = batch_shape + spec_core
            return torch.complex(yr.reshape(out), yi.reshape(out))
        re, im, _ = self._split(x)
        batch_shape = self._batch(re.shape, spec_core)
        flat = (math.prod(batch_shape),) + spec_core
        re, im = re.reshape(flat), im.reshape(flat)
        if spec_core[-1] != wire:
            pad = (0, wire - spec_core[-1])
            re = torch.nn.functional.pad(re, pad)
            im = torch.nn.functional.pad(im, pad)
        y = self._fn('inv')(re, im)
        return y.reshape(batch_shape + real_core)

    def _apply_real_1d(self, direction: str, x):
        """The real rank-1 boundary. The four-step computes this rank's
        rows of the half plane D[j1, j2] = y[j1 + n1*j2], j1 <= n1//2
        (padded to ``nh1p`` rows); ``np.fft.rfft``'s order reads rows that
        other ranks own (bins with j1 > n1//2 are the Hermitian mirror
        conj(D[n1-j1, n2-1-j2])), so the forward gathers D over the
        plan's group and every rank assembles the whole spectrum. The
        inverse takes that spectrum, whole on every rank, and each rank
        takes its own rows of D from it, with no communication."""
        n1, n2 = self._factors
        n = n1 * n2
        nh, nh1 = n // 2 + 1, n1 // 2 + 1
        p = strategies.static_group_size(self._mesh_axis_1d, self.mesh.shape)
        nh1p = -(-nh1 // p) * p
        if direction == 'fwd':
            x = self._real_operand(x)
            batch_shape = self._batch(x.shape, (n // p,))
            flat = (math.prod(batch_shape),)
            dr, di = self._fn('fwd')(x.reshape(flat + (n1 // p, n2)))
            if p > 1:
                dr, di = (_gather_rows(t, self.mesh, self._mesh_axis_1d) for t in (dr, di))
            dr, di = dr[:, :nh1], di[:, :nh1]
            # rows n1//2 + 1 .. n1 - 1 of the full plane, Hermitian-mirrored
            fr = torch.cat([dr, dr[:, 1:n1 // 2].flip((1, 2))], 1)
            fi = torch.cat([di, -di[:, 1:n1 // 2].flip((1, 2))], 1)
            yr = fr.transpose(1, 2).reshape(flat + (n,))[:, :nh]
            yi = fi.transpose(1, 2).reshape(flat + (n,))[:, :nh]
            return torch.complex(yr, yi).reshape(batch_shape + (nh,))
        re, im, _ = self._split(x)
        batch_shape = self._batch(re.shape, (nh,))
        flat = (math.prod(batch_shape),)
        re, im = re.reshape(flat + (nh,)), im.reshape(flat + (nh,))
        # Hermitian-extend to the whole spectrum, viewed as D's rows
        fr = torch.cat([re, re[:, 1:n // 2].flip(1)], 1)
        fi = torch.cat([im, -im[:, 1:n // 2].flip(1)], 1)
        rl = nh1p // p
        first = self.mesh.group_index(self._mesh_axis_1d) * rl if p > 1 else 0
        rows = slice(first, min(first + rl, nh1))
        dr = fr.reshape(flat + (n2, n1)).transpose(1, 2)[:, rows]
        di = fi.reshape(flat + (n2, n1)).transpose(1, 2)[:, rows]
        pad = (0, 0, 0, rl - dr.shape[1])
        dr, di = torch.nn.functional.pad(dr, pad), torch.nn.functional.pad(di, pad)
        y = self._fn('inv')(dr, di)
        return y.reshape(batch_shape + (n // p,))


def _gather_rows(t: torch.Tensor, mesh, mesh_axis) -> torch.Tensor:
    """Every rank's (B, r, c) block of ``mesh_axis``'s group stacked along
    axis 1 in the group's row-major member order: (B, p*r, c). Its
    gradient is this rank's own rows of the cotangent (every rank uses the
    gathered spectrum alike)."""
    return strategies.all_gather(t, mesh, mesh_axis, 1)


class SpectralOp(FFT):
    """A fused spectral-operator plan (see :func:`plan_op`).

    :meth:`apply` runs forward -> op -> inverse on this rank's blocks;
    the inherited ``forward``/``inverse`` still run the plain transforms
    (with the padded spectrum for a real rank-2/3 plan), the unfused
    composition. The static spectra are transformed at the first
    :meth:`apply`, once, and kept as device tensors in the native
    layout. ``donates_input`` stays False, as for every plan of the
    port."""

    def __init__(self, *, op, op_name=None, n_spectra=0, spectra=None,
                 spectra_form='plan', **kw):
        super().__init__(**kw)
        self.op = op
        self.op_name = op_name or getattr(op, '__name__', 'op') or 'op'
        self.n_spectra = n_spectra
        self.spectra_form = spectra_form
        self._spectra_raw = None if spectra is None else tuple(spectra)
        self._baked = None        # flat (re, im, re, im, ...) device tensors
        self._baked_bnd = ()      # leading batch rank of each baked spectrum
        #: how many times the static spectra were transformed: once a plan
        self.bake_count = 0

    @property
    def n_baked(self) -> int:
        return 0 if self._spectra_raw is None else len(self._spectra_raw)

    def __repr__(self) -> str:
        return (f"SpectralOp(op={self.op_name!r}, shape={self.shape}, real={self.real}, "
                f"n_spectra={self.n_spectra}, n_baked={self.n_baked}, "
                f"method={self.method!r}, comm={self.comm!r}, kernel={self.kernel!r}, "
                f"wire_dtype={self.wire_dtype!r}, mesh={dict(self.mesh.shape)})")

    # -- options --------------------------------------------------------------

    def _options(self) -> dict:
        kw = super()._options()
        kw.update(op=self.op, op_name=self.op_name, n_spectra=self.n_spectra,
                  spectra=self._spectra_raw, spectra_form=self.spectra_form)
        return kw

    def _replan(self, kw: dict) -> 'SpectralOp':
        kw.pop('padded_spectrum', None)   # plan_op derives it
        return plan_op(self.shape, self.mesh, **kw)

    # -- execution ------------------------------------------------------------

    def __call__(self, x, *extras):
        return self.apply(x, *extras)

    def apply(self, x, *extras):
        """``apply(x, *runtime_spectra)``: the operated array, this rank's
        block in the input layout, of ``x``'s shape. A real plan takes
        and returns real tensors; a complex one takes a complex64 tensor
        or a planar pair an operand and returns the main operand's form.
        Leading dims batch, broadcasting across operands inside ``op``."""
        if len(extras) != self.n_spectra:
            raise ValueError(f"operator plan takes {self.n_spectra} runtime spectra, "
                             f"got {len(extras)}")
        if self.mesh.device is None:
            raise RuntimeError(f"{self.mesh} prices plans and cannot run them; plan on "
                               "make_fft_mesh to execute")
        core = self.local_shape(self.in_layout)
        args, batches, planar0 = [], [], isinstance(x, (tuple, list))
        for a in (x,) + tuple(extras):
            if self.real:
                if isinstance(a, (tuple, list)):
                    raise ValueError("real operator plan operands are single real arrays")
                a = self._operand(a)
                if a.is_complex():
                    raise ValueError(f"real operator plan takes real arrays, got {a.dtype}")
                if a.dtype != torch.float32:
                    raise TypeError(f"real operands must be float32, got {a.dtype}")
                parts = (a,)
            else:
                parts = self._split(a)[:2]
            batches.append(self._batch(parts[0].shape, core))
            args.extend(self._view(t, batches[-1]) for t in parts)
        baked = self._ensure_baked()
        y = self._op_fn(tuple(len(b) for b in batches))(*args, *baked)
        out = batches[0] + core
        if self.real:
            return y.reshape(out)
        yr, yi = y[0].reshape(out), y[1].reshape(out)
        return (yr, yi) if planar0 else torch.complex(yr, yi)

    def _view(self, t: torch.Tensor, batch) -> torch.Tensor:
        """A rank-1 operand as the four-step's (n1/p, n2) row view."""
        if self.rank != 1:
            return t
        n1, n2 = self._factors
        return t.reshape(tuple(batch) + (n1 // self._p1d, n2))

    @property
    def _p1d(self) -> int:
        return strategies.static_group_size(self._mesh_axis_1d, self.mesh.shape)

    def _op_fn(self, batch_ndims):
        key = ('op', batch_ndims)
        fn = self._fns.get(key)
        if fn is None:
            if self.rank == 1:
                n1, n2 = self._factors
                fn = large1d.make_fourstep_op(
                    n1, n2, self.mesh, self._axes1d, self.op, real=self.real,
                    batch_ndims=batch_ndims, baked_batch_ndims=self._baked_bnd,
                    method=self.method, kernel=self.kernel,
                    compute_dtype=self.compute_dtype, comm=self.comm,
                    wire_dtype=self.wire_dtype)
            else:
                fn, _, _ = pencil.make_fused_op(
                    self._pplan, self.op, batch_ndims=batch_ndims,
                    baked_batch_ndims=self._baked_bnd, overlap_chunks=self.overlap_chunks)
            self._fns[key] = fn
        return fn

    # -- baked spectra ----------------------------------------------------------

    def _ensure_baked(self):
        if self._baked is None:
            flat, bnds = [], []
            for s in (self._spectra_raw or ()):
                re, im, nb = self._bake_one(s)
                flat += [re, im]
                bnds.append(nb)
            self._baked, self._baked_bnd = tuple(flat), tuple(bnds)
            self.bake_count += 1
        return self._baked

    def _bake_one(self, s):
        """One static spectrum -> this rank's planar block of it in the
        native form (the padded rotated layout of ranks 2/3, the rank-1
        half plane or D-form), and its batch rank."""
        if self.spectra_form == 'plan':
            x = torch.as_tensor(s, device=self.mesh.device)
            nb = x.ndim - self.rank
            if nb < 0 or tuple(x.shape[nb:]) != self.shape:
                raise ValueError(f"spectra_form='plan' arrays must end with the planned "
                                 f"shape {self.shape}, got {tuple(x.shape)}")
            if not self.real:
                x = x.to(torch.complex64)
            elif x.is_complex():
                raise ValueError(f"a real operator plan bakes real arrays, got {x.dtype}")
            x = self.mesh.shard(x, self.in_layout, batch_ndim=nb)
            batch = tuple(x.shape[:nb])
            parts = (x.float(),) if self.real else (x.real, x.imag)
            views = [self._view(t, batch) for t in parts]
            flat = [v.reshape((math.prod(batch),) + tuple(v.shape[nb:])) for v in views]
            yr, yi = self._forward_chain()(*flat)
            out = batch + tuple(yr.shape[1:])
            return yr.reshape(out), yi.reshape(out), nb
        want = (self.shape[:-1] + (self.shape[-1] // 2 + 1,)) if self.real else self.shape
        y = s if isinstance(s, torch.Tensor) else np.asarray(s)
        nb = y.ndim - self.rank
        if nb < 0 or tuple(y.shape[nb:]) != want:
            raise ValueError(
                f"spectra_form='spectrum' arrays must end with the "
                f"{'rfftn' if self.real else 'fftn'}-order spectrum shape {want}, "
                f"got {tuple(y.shape)}")
        if self.rank == 1:
            d = self._spectrum_to_native_1d(
                y.cpu().numpy() if isinstance(y, torch.Tensor) else y)
            d = self.mesh.shard(torch.as_tensor(d.astype(np.complex64)),
                                (self._mesh_axis_1d, None), batch_ndim=nb)
            d = d.to(self.mesh.device)
            return d.real.contiguous(), d.imag.contiguous(), nb
        y = torch.as_tensor(y, device=self.mesh.device).to(torch.complex64)
        if self.real:
            y = torch.nn.functional.pad(y, (0, self._real_pad - y.shape[-1]))
        y = self.mesh.shard(y, self._spec_layout, batch_ndim=nb)
        return y.real.contiguous(), y.imag.contiguous(), nb

    def _forward_chain(self):
        """The operator's own forward on one leading batch axis: what
        runtime operands go through, and what bakes 'plan'-form spectra."""
        if self.rank == 1:
            n1, n2 = self._factors
            return large1d.fourstep_bodies(
                n1, n2, self.mesh, self._axes1d, real=self.real, method=self.method,
                kernel=self.kernel, comm=self.comm, wire_dtype=self.wire_dtype,
                compute_dtype=self.compute_dtype)[0]
        return pencil.make_fft(self._pplan, overlap_chunks=self.overlap_chunks)[0]

    @property
    def _spec_layout(self) -> Layout:
        """Layout of the native (padded) interior spectrum, ranks 2/3."""
        return pencil.forward_schedule(self._pplan.layout, self._pplan.real_axis)[1]

    def _spectrum_to_native_1d(self, y: np.ndarray) -> np.ndarray:
        """``np.fft.rfft``/``fft``-order bins -> the four-step's native
        form, global: the factor-transposed D (complex) or the half plane
        D[j1 <= n1//2, j2] with its pad rows zeroed (real). Pure indexing
        and conjugation, on the host, once a plan."""
        n1, n2 = self._factors
        n = n1 * n2
        if not self.real:
            return np.swapaxes(y.reshape(y.shape[:-1] + (n2, n1)), -1, -2)
        nh1 = n1 // 2 + 1
        nh1p = -(-nh1 // self._p1d) * self._p1d
        full = np.concatenate([y, np.conj(y[..., 1:n // 2][..., ::-1])], axis=-1)
        d = np.swapaxes(full.reshape(y.shape[:-1] + (n2, n1)), -1, -2)[..., :nh1, :]
        pad = [(0, 0)] * d.ndim
        pad[-2] = (0, nh1p - nh1)
        return np.pad(d, pad)

    # -- cost model -------------------------------------------------------------

    def plan_cost(self, precision: str = 'fp32', *, measured='auto') -> costlib.PlanCost:
        """The fused chain priced per superstep: forward, one chain a
        runtime spectrum, the pointwise stage, the mirrored inverse, the
        elided boundary work as a zero-cycle 'elided' step
        (:func:`repro_torch.comm.cost.spectral_op_cost`)."""
        if self.rank == 1:
            layout, factors = self._mesh_axis_1d, self._factors
        else:
            layout, factors = self._pplan.layout, None
        return costlib.spectral_op_cost(
            self.shape, layout, self.mesh.shape, factors=factors, precision=precision,
            method=self.method, strategy=self.comm, overlap_chunks=self.overlap_chunks,
            real=self.real, n_spectra=self.n_spectra, n_baked=self.n_baked,
            measured=measured, wire_dtype=self.wire_dtype, kernel=self.resolved_kernel)
