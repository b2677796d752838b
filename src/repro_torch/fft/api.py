"""The public plan/execute facade: ``repro_torch.fft.plan(...)`` -> ``FFT``.

Port of ``repro.fft.api`` for ranks 2 and 3 (complex plans). A plan is
built once and executed many times; ``forward``/``inverse`` take a
complex64 tensor or a planar ``(re, im)`` pair of float32 tensors, with
any number of leading batch dims, and return the same form.

On a one-rank mesh the operand is the whole array. On a multi-rank mesh
each rank passes its LOCAL block under :attr:`FFT.in_layout` (see
``FFTMesh.shard``) and gets its block under :attr:`FFT.out_layout`, as
the reference's local function sees it inside ``shard_map``.

Not ported yet: rank 1 (``fft/large1d.py``), ``rplan``/``real=True``,
``plan_op``, ``overlap_chunks > 1``, ``comm='auto'`` on a multi-rank
mesh (the cost-model selector) and strategies other than
``'all_to_all'``; each raises ``NotImplementedError`` naming its
ROADMAP item.
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
         donate: bool = True) -> 'FFT':
    """Plan a distributed FFT of a rank-2 or rank-3 complex array.

    Args mirror ``repro.fft.plan``:
      shape: global transform shape, each axis a power of two.
      mesh: the port's mesh (``repro_torch.launch.mesh.make_fft_mesh``).
      method: 'auto' | 'stockham' | 'four_step' | 'direct'.
      kernel: 'auto' (CUDA kernels on a CUDA tensor, plain versions on
        a CPU tensor) | 'pallas' (the CUDA kernels; raises on the CPU) |
        'reference' (plain versions).
      mesh_axes / layout: initial ownership, as in the reference.
      comm: 'auto' | 'all_to_all'. On a one-rank mesh 'auto' resolves
        as the reference's selector does there: 'all_to_all', one
        overlap chunk, and the method from the cost model per axis.
      overlap_chunks: 1 (the default); more is a later slice.
      wire_dtype: 'native' | 'fp16' | 'bf16' cast around each swap.
      restore_layout: forward and inverse consume and produce the input
        layout (extra swaps).
      real: not ported yet (raises).
      donate: kept so options round-trip; the port never writes into an
        operand (its kernels are out of place), see
        :attr:`FFT.donates_input`.
    """
    shape = tuple(int(s) for s in shape)
    rank = len(shape)
    if rank == 1:
        raise NotImplementedError(
            "rank-1 plans (fft/large1d.py) are not ported yet: ROADMAP "
            "queue 1, 'Rank 1/2'")
    if rank not in (2, 3):
        raise ValueError(f"repro_torch.fft.plan supports ranks 2-3, got shape {shape}")
    if real:
        raise NotImplementedError(
            "real plans (rplan / rfft_via) are not ported yet: ROADMAP "
            "queue 1, 'Facade: real plans'")
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
    comm, oc, method = _resolve_comm(shape, mesh, comm, overlap_chunks, method)
    if oc != 1:
        raise NotImplementedError(
            "overlap_chunks > 1 is not ported yet: ROADMAP queue 1, 'Overlap'")
    pplan = PencilPlan(shape=shape, mesh=mesh, layout=tuple(layout),
                       method=method, kernel=kernel, comm=comm,
                       wire_dtype=wire_dtype)
    pplan.validate()
    return FFT(pplan, overlap_chunks=oc, restore_layout=restore_layout,
               donate=donate)


def _resolve_comm(shape, mesh, comm, overlap_chunks, method):
    """(strategy, overlap_chunks, method). Explicit choices win. Under
    comm='auto' on a one-rank mesh every swap is the identity, so the
    reference's selector lands on its first strategy ('all_to_all')
    with no overlap, and picks the method per axis by the cost model."""
    if comm != 'auto':
        return comm, 1 if overlap_chunks is None else overlap_chunks, method
    if mesh.size != 1:
        raise NotImplementedError(
            "comm='auto' on a multi-rank mesh needs the cost-model selector, "
            "not ported yet (ROADMAP queue 1, 'Cost model + selector'); "
            "pass comm='all_to_all'")
    oc = 1 if overlap_chunks is None else overlap_chunks
    if method == 'auto':
        picks = {costlib.select_method(n) for n in shape}
        method = picks.pop() if len(picks) == 1 else 'auto'
    return 'all_to_all', oc, method


class FFT:
    """A planned distributed FFT: build once, execute many times.

    ``inverse(forward(x))`` is a round trip: the inverse consumes the
    forward's output layout and restores the input layout."""

    def __init__(self, pplan: PencilPlan, *, overlap_chunks: int = 1,
                 restore_layout: bool = False, donate: bool = True):
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
        self.donate = donate
        self.real = False
        self._fns = {}

    def __repr__(self) -> str:
        return (f"FFT(shape={self.shape}, method={self.method!r}, "
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
                    donate=self.donate, layout=self._pplan.layout)

    def with_options(self, **overrides) -> 'FFT':
        """Re-plan with some options changed; everything else carries
        over already resolved."""
        kw = self._options()
        kw.update(overrides)
        return plan(self.shape, self.mesh, **kw)

    # -- layouts ------------------------------------------------------------

    @property
    def in_layout(self) -> Layout:
        return self._pplan.layout

    @property
    def out_layout(self) -> Layout:
        if self.restore_layout:
            return self.in_layout
        return pencil.forward_schedule(self._pplan.layout)[1]

    def local_shape(self, layout: Layout) -> Tuple[int, ...]:
        """This rank's block shape under ``layout``."""
        return self._pplan.local_shape(layout)

    # -- execution ----------------------------------------------------------

    def forward(self, x):
        """FFT of ``x`` (complex64 tensor or planar float32 pair)."""
        return self._apply('fwd', x)

    def inverse(self, x):
        """IFFT of ``x``; a round trip with :meth:`forward`."""
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

    def _apply(self, direction: str, x):
        planar = isinstance(x, (tuple, list))
        if planar:
            re, im = (self._operand(a) for a in x)
            if re.shape != im.shape or re.dtype != im.dtype:
                raise ValueError(
                    f"planar operand mismatch: re is {re.dtype}{tuple(re.shape)}, "
                    f"im is {im.dtype}{tuple(im.shape)}")
            if re.dtype != torch.float32:
                raise TypeError(f"planar operands must be float32, got {re.dtype}")
        else:
            x = self._operand(x)
            if x.dtype != torch.complex64:
                raise TypeError(f"complex operands must be complex64, got {x.dtype}")
            re, im = x.real, x.imag
        lay_in, lay_out = ((self.in_layout, self.out_layout) if direction == 'fwd'
                           else (self.out_layout, self.in_layout))
        core = self.local_shape(lay_in)
        shape = tuple(re.shape)
        if len(shape) < self.rank or shape[len(shape) - self.rank:] != core:
            raise ValueError(
                f"operand shape {shape} does not end with this rank's block "
                f"{core} of the planned transform {self.shape}")
        batch_shape = shape[:len(shape) - self.rank]
        flat = (math.prod(batch_shape),)
        yr, yi = self._fn(direction)(re.reshape(flat + core), im.reshape(flat + core))
        out = batch_shape + self.local_shape(lay_out)
        yr, yi = yr.reshape(out), yi.reshape(out)
        return (yr, yi) if planar else torch.complex(yr, yi)
