"""The port's meshes: the pencil grid ('x', 'y') or ('pod', 'x', 'y'), and the
language models' ('data', 'model').

Port of ``repro.launch.mesh.make_fft_mesh``. A JAX ``Mesh`` names axes
over devices and ``shard_map`` hands each device its block; here every
rank is one process holding its own local block, and a mesh axis names
a group of ranks for the swap collectives.

* A one-rank mesh (1 x 1) needs no process group: every swap is the
  identity.
* A larger mesh wraps a ``torch.distributed.device_mesh.DeviceMesh``
  over an initialised default process group, with one sub-group per
  axis and one per set of two or more axes (the flattened groups of
  tuple axes, e.g. the rank-2 layout ``(('x', 'y'), None)``).
* ``pods > 1`` adds a leading 'pod' axis, which only a plan's
  ``batch_spec='pod'`` uses: each pod holds a slice of the batch and
  runs its transforms over its own ('x', 'y') groups.
* :func:`abstract_fft_mesh` names extents only, the counterpart of
  ``jax.sharding.AbstractMesh``: plans on it are priced
  (``FFT.plan_cost``/``cost_report``) at any size, the paper's
  512 x 512 included, and cannot run.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.comm.strategies import axis_tuple, static_group_size
from repro_torch.core.plan import Layout, MeshAxis

AXES = ('x', 'y')
POD_AXES = ('pod', 'x', 'y')


def _axes_of(rows: int, cols: int, pods: int) -> Dict[str, int]:
    if pods > 1:
        return dict(zip(POD_AXES, (pods, rows, cols)))
    return dict(zip(AXES, (rows, cols)))


def _describe(shape: Dict[str, int]) -> str:
    return ", ".join(f"{a}={n}" for a, n in shape.items())


class FFTMesh:
    """Axis names, extents, this rank's device and its swap groups."""

    def __init__(self, shape: Dict[str, int], device: torch.device, device_mesh=None):
        self.axis_names = tuple(shape)
        self.shape: Dict[str, int] = dict(shape)
        self.size = math.prod(self.shape.values())
        self.device = device
        self.device_mesh = device_mesh
        self._tuple_groups = {}
        if device_mesh is None:
            self._coord = (0,) * len(self.axis_names)
        else:
            self._ranks = device_mesh.mesh.cpu()
            self._coord = tuple(device_mesh.get_coordinate())
            # collective: every rank makes every group, in the same order
            nd = len(self.axis_names)
            for k in range(2, nd + 1):
                for dims in itertools.combinations(range(nd), k):
                    rest = [d for d in range(nd) if d not in dims]
                    grid = self._ranks.permute(rest + list(dims)).reshape(-1, math.prod(
                        self._ranks.shape[d] for d in dims))
                    mine, _ = dist.new_subgroups_by_enumeration(
                        [sorted(int(r) for r in row) for row in grid])
                    self._tuple_groups[dims] = mine

    def __repr__(self) -> str:
        return f"FFTMesh({_describe(self.shape)}, device={self.device})"

    @property
    def coordinate(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._coord))

    def group_index(self, mesh_axis: MeshAxis) -> int:
        """This rank's row-major index within the (tuple) axis group."""
        idx = 0
        for a in axis_tuple(mesh_axis):
            idx = idx * self.shape[a] + self.coordinate[a]
        return idx

    def group(self, mesh_axis: MeshAxis):
        """``(process_group, members)``: the group that swaps over
        ``mesh_axis`` and its global ranks in row-major order of the
        tuple axes, the order of the blocks in a swap. The group holds
        the ranks that share this rank's coordinates on the other axes
        (on a pod mesh, this rank's pod for 'x' and 'y')."""
        axes = axis_tuple(mesh_axis)
        if self.device_mesh is None:
            raise RuntimeError("a one-rank mesh has no process groups")
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(len(self.axis_names)) if d not in dims]
        grid = self._ranks.permute(rest + dims)
        for d in rest:
            grid = grid[self._coord[d]]
        members = tuple(int(r) for r in grid.flatten())
        if len(axes) == 1:
            pg = self.device_mesh.get_group(axes[0])
        else:
            pg = self._tuple_groups[tuple(sorted(dims))]
        return pg, members

    def shard(self, x: torch.Tensor, layout: Layout, batch_ndim: int = 0,
              batch_spec: MeshAxis = None) -> torch.Tensor:
        """This rank's block of the global ``x`` under ``layout`` (the
        trailing ``len(layout)`` axes). Leading batch axes are whole,
        except that ``batch_spec`` slices the first of them by that mesh
        axis, as a plan with ``batch_spec`` takes it."""
        lead = [None] * batch_ndim
        if batch_spec is not None:
            lead[0] = batch_spec
        for ax, owner in enumerate(lead + list(layout)):
            p = static_group_size(owner, self.shape)
            if p == 1:
                continue
            blk = x.shape[ax] // p
            x = x.narrow(ax, self.group_index(owner) * blk, blk)
        return x.contiguous()


def make_fft_mesh(rows: int = 1, cols: int = 1, *, pods: int = 1,
                  device: Optional[str] = None) -> FFTMesh:
    """The paper's PE-grid analogue: a ``rows x cols`` ('x', 'y') mesh, or
    with ``pods > 1`` a ``pods x rows x cols`` ('pod', 'x', 'y') one.

    ``device`` is the device type ('cuda' or 'cpu'); the default is
    'cuda', and it raises when CUDA is absent rather than running on the
    CPU. A mesh of more than one rank needs an initialised default
    process group of at least that many ranks (NCCL for 'cuda', gloo
    for 'cpu'); each rank uses ``cuda:<local index>``."""
    return _make_mesh(_axes_of(rows, cols, pods), device, 'make_fft_mesh')


def require_one_rank(mesh_shape: Dict[str, int], what: str = 'the trainer') -> None:
    """Raise ``ValueError`` for a mesh of more than one rank: the trainer
    (``what``) runs on one rank until the sharded trainer (ROADMAP queue
    1 item 11i, the training half of 11g). The server runs on any mesh."""
    if any(n != 1 for n in mesh_shape.values()):
        dims = 'x'.join(str(n) for n in mesh_shape.values())
        raise ValueError(f'{what} runs on a 1x1 mesh only, not {dims}: the sharded trainer '
                         'is not ported yet (ROADMAP queue 1 item 11i, the training half '
                         'of 11g)')


def make_host_mesh(rows: int = 1, cols: int = 1, *, device: Optional[str] = None) -> FFTMesh:
    """The language models' ('data', 'model') mesh, port of the
    reference's ``make_host_mesh``; ``device`` and process groups as
    :func:`make_fft_mesh`'s: a mesh of more than one rank needs a
    default process group of at least ``rows * cols`` ranks."""
    return _make_mesh({'data': rows, 'model': cols}, device, 'make_host_mesh')


def make_production_mesh(*, multi_pod: bool = False, device: Optional[str] = None) -> FFTMesh:
    """The reference's production mesh: 16 x 16 ('data', 'model'), 256
    ranks; ``multi_pod`` adds a leading 2-pod axis, (2, 16, 16) ('pod',
    'data', 'model'), 512 ranks. Process groups as :func:`make_host_mesh`'s."""
    if multi_pod:
        return _make_mesh({'pod': 2, 'data': 16, 'model': 16}, device, 'make_production_mesh')
    return _make_mesh({'data': 16, 'model': 16}, device, 'make_production_mesh')


def _make_mesh(shape: Dict[str, int], device: Optional[str], who: str) -> FFTMesh:
    dev_type = 'cuda' if device is None else torch.device(device).type
    if dev_type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    dm = None
    if math.prod(shape.values()) > 1:
        if not dist.is_initialized():
            raise RuntimeError(
                f"{who}({_describe(shape)}) needs an initialised default "
                "process group (torch.distributed.init_process_group)")
        if dist.get_world_size() < math.prod(shape.values()):
            raise RuntimeError(f"{who}({_describe(shape)}) needs {math.prod(shape.values())} "
                               f"ranks; the process group has {dist.get_world_size()}")
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh(dev_type, tuple(shape.values()),
                              mesh_dim_names=tuple(shape))
    dev = (torch.device('cuda', torch.cuda.current_device()) if dev_type == 'cuda'
           else torch.device('cpu'))
    return FFTMesh(shape, dev, device_mesh=dm)


class AbstractFFTMesh:
    """Axis names and extents of an ('x', 'y') or ('pod', 'x', 'y') mesh,
    with no device and no process group: a mesh to price plans on, not
    to run them."""

    device = None

    def __init__(self, rows: int, cols: int, pods: int = 1):
        self.shape: Dict[str, int] = _axes_of(rows, cols, pods)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractFFTMesh({_describe(self.shape)})"

    def group(self, mesh_axis: MeshAxis):
        raise RuntimeError(f"{self} prices plans and has no process groups to swap over")


def abstract_fft_mesh(rows: int, cols: int, *, pods: int = 1) -> AbstractFFTMesh:
    """A ``rows x cols`` ('x', 'y') mesh (``pods > 1``: ('pod', 'x', 'y'))
    for cost-only plans:
    ``plan((512,)*3, abstract_fft_mesh(512, 512)).cost_report()``."""
    return AbstractFFTMesh(rows, cols, pods)
