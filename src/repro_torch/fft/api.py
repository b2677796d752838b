"""The public plan/execute facade: ``repro_torch.fft.plan(...)`` -> ``FFT``.

Port of ``repro.fft.api`` for ranks 2 and 3. A plan is built once and
executed many times. A complex plan's ``forward``/``inverse`` take a
complex64 tensor or a planar ``(re, im)`` pair of float32 tensors, with
any number of leading batch dims, and return the same form. A real plan
(:func:`rplan`, ``np.fft.rfftn`` semantics) takes ONE real float32
tensor forward and returns the complex64 half spectrum; its inverse
takes the half spectrum (complex64 or planar) and returns the real
tensor.

On a one-rank mesh the operand is the whole array. On a multi-rank mesh
each rank passes its LOCAL block under :attr:`FFT.in_layout` (see
``FFTMesh.shard``) and gets its block under :attr:`FFT.out_layout`, as
the reference's local function sees it inside ``shard_map``.

Not ported yet: rank 1 (``fft/large1d.py``, complex and real),
``plan_op``, ``overlap_chunks > 1``, ``comm='auto'`` on a multi-rank
mesh (the cost-model selector) and strategies other than
``'all_to_all'``; each raises naming its ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.comm import cost as costlib
from repro_torch.comm import strategies
from repro_torch.core.plan import Layout, PencilPlan
from repro_torch.fft import methods, pencil


def plan(shape: Sequence[int], mesh, *, method: str = 'auto',
         kernel: str = 'auto', mesh_axes: Optional[Tuple[str, ...]] = None,
         layout: Optional[Layout] = None, comm: str = 'auto',
         overlap_chunks: Optional[int] = None, wire_dtype: str = 'native',
         restore_layout: bool = False, real: bool = False,
         padded_spectrum: bool = False, donate: bool = True) -> 'FFT':
    """Plan a distributed FFT of a rank-2 or rank-3 array.

    Args mirror ``repro.fft.plan``:
      shape: global transform shape, each axis a power of two.
      mesh: the port's mesh (``repro_torch.launch.mesh.make_fft_mesh``).
      method: 'auto' | 'stockham' | 'four_step' | 'block' | 'direct'.
      kernel: 'auto' (CUDA kernels on a CUDA tensor, plain versions on
        a CPU tensor) | 'pallas' (the CUDA kernels; raises on the CPU) |
        'reference' (plain versions).
      mesh_axes / layout: initial ownership, as in the reference.
      comm: 'auto' | 'all_to_all'. On a one-rank mesh 'auto' resolves
        as the reference's selector does there: 'all_to_all', one
        overlap chunk, and the method from the cost model per axis (a
        real plan's last axis priced at its half length n/2).
      overlap_chunks: 1 (the default); more is a later slice.
      wire_dtype: 'native' | 'fp16' | 'bf16' cast around each swap.
      restore_layout: forward and inverse consume and produce the input
        layout (extra swaps).
      real: an rfft/irfft plan (see :func:`rplan`): the last axis is
        transformed real-to-complex in the first superstep, and every
        later superstep and swap moves its half spectrum.
      padded_spectrum: real plans only. The half axis (n//2 + 1, odd)
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
    if rank == 1:
        raise NotImplementedError(
            "rank-1 plans (fft/large1d.py, complex and real) are not ported "
            "yet: ROADMAP queue 1, 'Rank 1/2'")
    if rank not in (2, 3):
        raise ValueError(f"repro_torch.fft.plan supports ranks 2-3, got shape {shape}")
    if real and shape[-1] % 2:
        raise ValueError(f"real plans need an even last axis, got {shape}")
    if padded_spectrum and not real:
        raise ValueError("padded_spectrum applies to real plans only")
    methods.validate(method)
    methods.validate_kernel(kernel)
    strategies.validate(comm)
    strategies.validate_wire_dtype(wire_dtype)
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    if layout is None:
        axes = tuple(mesh_axes) if mesh_axes is not None else tuple(mesh.axis_names)
        if rank == 2:
            layout = (axes if len(axes) > 1 else axes[0], None)
        else:
            if len(axes) != 2:
                raise ValueError(
                    f"rank-3 mesh_axes must be a (row, col) pair of mesh "
                    f"axis names, got {axes!r}")
            layout = (axes[0], axes[1], None)
    comm, oc, method = _resolve_comm(shape, mesh, comm, overlap_chunks, method, real)
    if oc != 1:
        raise NotImplementedError(
            "overlap_chunks > 1 is not ported yet: ROADMAP queue 1, 'Overlap'")
    pplan = PencilPlan(shape=shape, mesh=mesh, layout=tuple(layout),
                       method=method, kernel=kernel, comm=comm, real=real,
                       wire_dtype=wire_dtype)
    pplan.validate()
    return FFT(pplan, overlap_chunks=oc, restore_layout=restore_layout,
               padded_spectrum=padded_spectrum, donate=donate)


def rplan(shape: Sequence[int], mesh, **kw) -> 'FFT':
    """:func:`plan` with ``real=True``: the forward takes a real tensor
    and returns the half spectrum (last axis n//2 + 1), at about half
    the bytes and pencil work of the complex plan."""
    return plan(shape, mesh, real=True, **kw)


def plan_op(*args, **kwargs):
    """Fused spectral-operator plans are a later slice."""
    raise NotImplementedError(
        "operator plans (plan_op / SpectralOp) are not ported yet: ROADMAP "
        "queue 1, 'Operator plans'")


def _resolve_comm(shape, mesh, comm, overlap_chunks, method, real=False):
    """(strategy, overlap_chunks, method). Explicit choices win. Under
    comm='auto' on a one-rank mesh every swap is the identity, so the
    reference's selector lands on its first strategy ('all_to_all')
    with no overlap, and picks the method per axis by the cost model; a
    real plan spends its last axis on a length-n/2 pencil."""
    if comm != 'auto':
        return comm, 1 if overlap_chunks is None else overlap_chunks, method
    if mesh.size != 1:
        raise NotImplementedError(
            "comm='auto' on a multi-rank mesh needs the cost-model selector, "
            "not ported yet (ROADMAP queue 1, 'Cost model + selector'); "
            "pass comm='all_to_all'")
    oc = 1 if overlap_chunks is None else overlap_chunks
    if method == 'auto':
        lens = shape[:-1] + (max(shape[-1] // 2, 1),) if real else shape
        picks = {costlib.select_method(n) for n in lens}
        method = picks.pop() if len(picks) == 1 else 'auto'
    return 'all_to_all', oc, method


class FFT:
    """A planned distributed FFT: build once, execute many times.

    ``inverse(forward(x))`` is a round trip: the inverse consumes the
    forward's output layout and restores the input layout. A real plan
    changes the boundary types only: ``forward`` takes a real tensor of
    the planned shape and returns the complex half spectrum
    (:attr:`spectrum_shape`), ``inverse`` takes the half spectrum and
    returns the real tensor."""

    def __init__(self, pplan: PencilPlan, *, overlap_chunks: int = 1,
                 restore_layout: bool = False, padded_spectrum: bool = False,
                 donate: bool = True):
        self._pplan = pplan
        self.shape = pplan.shape
        self.rank = len(pplan.shape)
        self.mesh = pplan.mesh
        self.method = pplan.method
        self.kernel = pplan.kernel
        self.comm = pplan.comm
        self.wire_dtype = pplan.wire_dtype
        self.overlap_chunks = overlap_chunks
        self.restore_layout = restore_layout
        self.real = pplan.real
        self.padded_spectrum = padded_spectrum
        self.donate = donate
        self._fns = {}

    def __repr__(self) -> str:
        return (f"FFT(shape={self.shape}, real={self.real}, method={self.method!r}, "
                f"kernel={self.kernel!r}, comm={self.comm!r}, mesh={self.mesh})")

    @property
    def resolved_kernel(self) -> str:
        """The tier the last superstep's pencils run on this plan's
        device: 'pallas' (CUDA kernels) or 'reference'."""
        return methods.resolve_kernel(
            self.kernel, methods.resolve(self.method, self.shape[-1]),
            self.mesh.device)

    @property
    def donates_input(self) -> bool:
        """Always False in the port: every kernel writes a new buffer, so
        the operand stays valid after ``forward``/``inverse``."""
        return False

    # -- options ------------------------------------------------------------

    def _options(self) -> dict:
        return dict(method=self.method, kernel=self.kernel, comm=self.comm,
                    overlap_chunks=self.overlap_chunks,
                    wire_dtype=self.wire_dtype,
                    restore_layout=self.restore_layout, real=self.real,
                    padded_spectrum=self.padded_spectrum,
                    donate=self.donate, layout=self._pplan.layout)

    def with_options(self, **overrides) -> 'FFT':
        """Re-plan with some options changed; everything else carries
        over already resolved."""
        kw = self._options()
        kw.update(overrides)
        if not kw['real']:
            kw['padded_spectrum'] = False
        return plan(self.shape, self.mesh, **kw)

    # -- layouts and shapes -------------------------------------------------

    @property
    def in_layout(self) -> Layout:
        return self._pplan.layout

    @property
    def _rotated_layout(self) -> Layout:
        """Where the forward leaves the data."""
        if self.restore_layout:
            return self.in_layout
        return pencil.forward_schedule(self._pplan.layout, self._pplan.real_axis)[1]

    @property
    def out_layout(self) -> Layout:
        """The forward's output layout. A real plan's unpadded spectrum
        on one rank has its whole half axis in memory, reported as the
        reference reports it (``None``); on several ranks each keeps its
        part of the half axis under the rotated layout (see
        :meth:`spectrum_local_shape`)."""
        lay = self._rotated_layout
        if self.real and not self.padded_spectrum and self.mesh.size == 1:
            return lay[:-1] + (None,)
        return lay

    @property
    def _real_pad(self) -> int:
        """On-wire (padded) extent of the half axis."""
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
        return self._pplan.local_shape(layout)

    def spectrum_local_shape(self) -> Tuple[int, ...]:
        """This rank's block of the forward's output. For an unpadded real
        spectrum the pad lies in the trailing shards of the half axis, so
        a rank keeps the bins below n//2 + 1 of its padded block."""
        if not self.real:
            return self.local_shape(self.out_layout)
        lay = self._rotated_layout
        blk = pencil.packed_plan(self._pplan, self._real_pad).local_shape(lay)
        if self.padded_spectrum:
            return blk
        owner = lay[-1]
        first = 0
        if strategies.static_group_size(owner, self.mesh.shape) > 1:
            first = self.mesh.group_index(owner) * blk[-1]
        keep = min(blk[-1], max(0, pencil.real_half_extent(self.shape[-1]) - first))
        return blk[:-1] + (keep,)

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
            fn, _, _ = pencil.make_fft(self._pplan, inverse=direction == 'inv',
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

    def _batch(self, shape, core) -> Tuple[int, ...]:
        """The leading batch shape of an operand whose trailing dims must
        be ``core``."""
        shape = tuple(shape)
        if len(shape) < self.rank or shape[len(shape) - self.rank:] != tuple(core):
            raise ValueError(
                f"operand shape {shape} does not end with this rank's block "
                f"{tuple(core)} of the planned transform {self.shape}")
        return shape[:len(shape) - self.rank]

    def _apply(self, direction: str, x):
        if self.real:
            return self._apply_real(direction, x)
        re, im, planar = self._split(x)
        lay_in, lay_out = ((self.in_layout, self.out_layout) if direction == 'fwd'
                           else (self.out_layout, self.in_layout))
        core = self.local_shape(lay_in)
        batch_shape = self._batch(re.shape, core)
        flat = (math.prod(batch_shape),)
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
            if isinstance(x, (tuple, list)):
                raise ValueError("real plan forward takes ONE real tensor, not a planar pair")
            x = self._operand(x)
            if x.is_complex():
                raise ValueError(f"real plan forward takes a REAL tensor, got {x.dtype}")
            if x.dtype != torch.float32:
                raise TypeError(f"real operands must be float32, got {x.dtype}")
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
