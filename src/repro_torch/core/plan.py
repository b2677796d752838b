"""PencilPlan: the layout state machine of the pencil decomposition.

Port of ``repro.core.plan``. The state is "which mesh axis (or None =
memory) owns each global array axis". One all-to-all along a mesh axis
swaps the memory axis with the axis that mesh axis owns: positions in
storage order never move, only ownership rotates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

MeshAxis = Union[str, Tuple[str, ...], None]
Layout = Tuple[MeshAxis, ...]   # per-array-axis owner; None = in memory

#: valid plan options, mirrored from ``fft.methods``/``comm.strategies``
#: (this module is imported by both, so it cannot import them)
KERNEL_TIERS = ('auto', 'pallas', 'reference')
WIRE_DTYPES = ('native', 'fp16', 'bf16')


def memory_axes(layout: Layout) -> Tuple[int, ...]:
    return tuple(i for i, o in enumerate(layout) if o is None)


def owner_pos(layout: Layout, mesh_axis: MeshAxis) -> int:
    for i, o in enumerate(layout):
        if o == mesh_axis:
            return i
    raise ValueError(f"mesh axis {mesh_axis!r} owns no array axis in {layout}")


def swap(layout: Layout, mesh_axis: MeshAxis, mem_pos: int) -> Layout:
    """Layout after swapping the memory axis at ``mem_pos`` with the axis
    owned by ``mesh_axis``."""
    if layout[mem_pos] is not None:
        raise ValueError(f"axis {mem_pos} is not a memory axis in {layout}")
    sp = owner_pos(layout, mesh_axis)
    out = list(layout)
    out[sp], out[mem_pos] = None, mesh_axis
    return tuple(out)


def plan_swaps(src: Layout, dst: Layout) -> Tuple[Tuple[MeshAxis, int], ...]:
    """Minimal sequence of (mesh_axis, mem_pos) swaps turning ``src``
    into ``dst``, by breadth-first search over layout states."""
    if src == dst:
        return ()
    axes = sorted({o for o in src if o is not None}, key=str)
    frontier = {src: ()}
    seen = {src}
    for _ in range(8):
        nxt = {}
        for st, path in frontier.items():
            for ax in axes:
                for mp in memory_axes(st):
                    st2 = swap(st, ax, mp)
                    if st2 == dst:
                        return path + ((ax, mp),)
                    if st2 not in seen:
                        seen.add(st2)
                        nxt[st2] = path + ((ax, mp),)
        frontier = nxt
        if not frontier:
            break
    raise ValueError(f"no swap path {src} -> {dst}")


@dataclasses.dataclass(frozen=True)
class PencilPlan:
    """Static description of a distributed FFT problem.

    shape       global array shape, each axis a power of two
    mesh        the port's mesh (:class:`repro_torch.launch.mesh.FFTMesh`)
    layout      initial ownership of each array axis
    method      local pencil algorithm ('stockham'|'four_step'|'auto'|...)
    kernel      local-compute tier ('auto'|'pallas'|'reference'); in the
                port 'pallas' names the hand-written CUDA kernels
    comm        redistribution strategy ('all_to_all')
    real        real-input (rfft) plan: the LAST axis is transformed
                real-to-complex in the first superstep and every later
                superstep sees its half spectrum (n -> n//2 + 1 bins,
                padded for even sharding)
    wire_dtype  swap wire format ('native'|'fp16'|'bf16')
    compute_dtype  operand type of the matmul-form pencils' products
                (e.g. ``torch.bfloat16``; None keeps fp32), reference tier
                only (:func:`repro_torch.fft.methods.check_compute_dtype`)
    """
    shape: Tuple[int, ...]
    mesh: object
    layout: Layout
    method: str = 'auto'
    kernel: str = 'auto'
    comm: str = 'all_to_all'
    real: bool = False
    wire_dtype: str = 'native'
    compute_dtype: object = None

    @property
    def real_axis(self) -> Optional[int]:
        """The axis the r2c/c2r transform runs along (the last, as in
        ``np.fft.rfftn``), or None for a complex plan."""
        return len(self.shape) - 1 if self.real else None

    def axis_size(self, mesh_axis: MeshAxis) -> int:
        if mesh_axis is None:
            return 1
        axes = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        out = 1
        for a in axes:
            out *= self.mesh.shape[a]
        return out

    def local_shape(self, layout: Optional[Layout] = None) -> Tuple[int, ...]:
        lay = self.layout if layout is None else layout
        return tuple(s // self.axis_size(o) for s, o in zip(self.shape, lay))

    def validate(self) -> None:
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unknown wire_dtype {self.wire_dtype!r}; known: {WIRE_DTYPES}")
        if self.kernel not in KERNEL_TIERS:
            raise ValueError(
                f"unknown kernel tier {self.kernel!r}; known: {KERNEL_TIERS}")
        for s, o in zip(self.shape, self.layout):
            p = self.axis_size(o)
            if s % p:
                raise ValueError(f"axis size {s} not divisible by mesh extent {p} ({o})")
        if self.real:
            if self.layout[-1] is not None:
                raise ValueError(
                    f"real plans transform the last axis first, so it must "
                    f"start in memory (None), got layout {self.layout}")
            if self.shape[-1] % 2:
                raise ValueError(f"real plans need an even last axis, got {self.shape}")


def make_fft3d_plan(n: int, mesh, row_axis: str = 'x', col_axis: str = 'y',
                    **kw) -> PencilPlan:
    """Paper layout: input(i,j,k) -> PE(i,j), z in memory."""
    return PencilPlan(shape=(n, n, n), mesh=mesh,
                      layout=(row_axis, col_axis, None), **kw)


def make_fft2d_plan(n0: int, n1: int, mesh,
                    axes: Tuple[str, ...] = ('x', 'y'), **kw) -> PencilPlan:
    """2-D transform: rows distributed over the flattened mesh."""
    return PencilPlan(shape=(n0, n1), mesh=mesh, layout=(axes, None), **kw)
