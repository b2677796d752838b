"""The port's ('x', 'y') pencil-grid mesh.

Port of ``repro.launch.mesh.make_fft_mesh``. A JAX ``Mesh`` names axes
over devices and ``shard_map`` hands each device its block; here every
rank is one process holding its own local block, and a mesh axis names
a group of ranks for the swap collectives.

* A one-rank mesh (1 x 1) needs no process group: every swap is the
  identity.
* A larger mesh wraps a ``torch.distributed.device_mesh.DeviceMesh``
  over an initialised default process group, with one sub-group per
  axis and one flattened group for tuple axes (the rank-2 layout
  ``(('x', 'y'), None)``).
* :func:`abstract_fft_mesh` names extents only, the counterpart of
  ``jax.sharding.AbstractMesh``: plans on it are priced
  (``FFT.plan_cost``/``cost_report``) at any size, the paper's
  512 x 512 included, and cannot run.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.comm.strategies import axis_tuple, static_group_size
from repro_torch.core.plan import Layout, MeshAxis

AXES = ('x', 'y')


class FFTMesh:
    """Axis names, extents, this rank's device and its swap groups."""

    def __init__(self, rows: int, cols: int, device: torch.device,
                 device_mesh=None):
        self.axis_names = AXES
        self.shape: Dict[str, int] = {'x': rows, 'y': cols}
        self.size = rows * cols
        self.device = device
        self.device_mesh = device_mesh
        if device_mesh is None:
            self._coord = (0, 0)
        else:
            self._ranks = device_mesh.mesh.cpu()
            self._coord = tuple(device_mesh.get_coordinate())
            # collective: every rank builds the mesh in the same order
            self._flat_group = dist.new_group(
                sorted(int(r) for r in self._ranks.flatten()))

    def __repr__(self) -> str:
        return (f"FFTMesh(x={self.shape['x']}, y={self.shape['y']}, "
                f"device={self.device})")

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
        tuple axes, the order of the blocks in a swap."""
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
        elif sorted(dims) == list(range(len(self.axis_names))):
            pg = self._flat_group
        else:
            raise ValueError(f"no process group for mesh axes {axes}")
        return pg, members

    def shard(self, x: torch.Tensor, layout: Layout,
              batch_ndim: int = 0) -> torch.Tensor:
        """This rank's block of the global ``x`` under ``layout`` (the
        trailing ``len(layout)`` axes; leading batch axes are whole)."""
        for i, owner in enumerate(layout):
            p = static_group_size(owner, self.shape)
            if p == 1:
                continue
            ax = batch_ndim + i
            blk = x.shape[ax] // p
            x = x.narrow(ax, self.group_index(owner) * blk, blk)
        return x.contiguous()


def make_fft_mesh(rows: int = 1, cols: int = 1, *,
                  device: Optional[str] = None) -> FFTMesh:
    """The paper's PE-grid analogue: a ``rows x cols`` ('x', 'y') mesh.

    ``device`` is the device type ('cuda' or 'cpu'); the default is
    'cuda', and it raises when CUDA is absent rather than running on the
    CPU. A mesh of more than one rank needs an initialised default
    process group of at least ``rows * cols`` ranks (NCCL for 'cuda',
    gloo for 'cpu'); each rank uses ``cuda:<local index>``."""
    dev_type = 'cuda' if device is None else torch.device(device).type
    if dev_type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "make_fft_mesh: no CUDA device; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    dm = None
    if rows * cols > 1:
        if not dist.is_initialized():
            raise RuntimeError(
                f"make_fft_mesh({rows}, {cols}) needs an initialised default "
                "process group (torch.distributed.init_process_group)")
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh(dev_type, (rows, cols), mesh_dim_names=AXES)
    dev = (torch.device('cuda', torch.cuda.current_device()) if dev_type == 'cuda'
           else torch.device('cpu'))
    return FFTMesh(rows, cols, dev, device_mesh=dm)


class AbstractFFTMesh:
    """Axis names and extents of an ('x', 'y') mesh, with no device and
    no process group: a mesh to price plans on, not to run them."""

    device = None

    def __init__(self, rows: int, cols: int):
        self.axis_names = AXES
        self.shape: Dict[str, int] = {'x': rows, 'y': cols}
        self.size = rows * cols

    def __repr__(self) -> str:
        return f"AbstractFFTMesh(x={self.shape['x']}, y={self.shape['y']})"

    def group(self, mesh_axis: MeshAxis):
        raise RuntimeError(f"{self} prices plans and has no process groups to swap over")


def abstract_fft_mesh(rows: int, cols: int) -> AbstractFFTMesh:
    """A ``rows x cols`` ('x', 'y') mesh for cost-only plans:
    ``plan((512,)*3, abstract_fft_mesh(512, 512)).cost_report()``."""
    return AbstractFFTMesh(rows, cols)
