"""Checkpoints: atomic manifests, async writes, sharded saves, restore
onto a device and reshard on load.

Port of ``repro.checkpoint.ckpt``. A one-rank checkpoint has the
reference's directory layout, so either package restores the other's:

    <dir>/step_<n>.tmp/...  ->  rename  ->  <dir>/step_<n>/
      flat_<i>.npy    leaf i in sorted-key order, a flat uint8 view of
                      its bytes (a bf16 leaf too: no ml_dtypes needed)
      manifest.json   {step, num_leaves, treedef, leaves: [{shape, dtype}]}

``treedef`` is a description for readers; restore takes the structure
from ``like``.

A sharded run (a mesh of several ranks, each leaf's cut given as
``weights.Cut``) writes per-block files, as the reference says a fleet
does (its single-host container writes the gathered leaf): every rank
writes the blocks it is the first holder of, ``flat_<i>.<b>.npy`` with
``b`` the block's index under the leaf's spec (``sharding.shard_index``),
and after a barrier rank 0 writes the manifest, now with the mesh's
extents and each leaf's global shape, spec and whether it is a gated
``wi`` stored as [gate block ‖ up block], and renames the directory
(atomic). Restore joins a leaf's blocks on the host and cuts the
target rank's block under the target mesh's cut: a checkpoint restores
onto any mesh (the reference's reshard-on-load), a one-rank
checkpoint included, and onto one rank whole.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_map

#: manifest dtype names (numpy's, as the reference writes them)
_DTYPES = {'float32': torch.float32, 'float16': torch.float16,
           'bfloat16': torch.bfloat16, 'float64': torch.float64,
           'int8': torch.int8, 'int16': torch.int16, 'int32': torch.int32,
           'int64': torch.int64, 'uint8': torch.uint8, 'bool': torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _raw(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a flat uint8 array."""
    t = t.detach().contiguous().reshape(-1)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().view(np.uint8)


def _save_leaf(path: str, t: torch.Tensor) -> dict:
    np.save(path, _raw(t.cpu()))
    return {'shape': list(t.shape), 'dtype': _NAMES[t.dtype]}


def _load_leaf(path: str, shape, dtype_name: str) -> torch.Tensor:
    raw = torch.from_numpy(np.load(path))
    return raw.view(_DTYPES[dtype_name]).reshape(tuple(shape))


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return '{' + ', '.join(f'{k!r}: {_treedef(tree[k])}' for k in sorted(tree)) + '}'
    return '*'


def _mesh_axes(spec) -> set:
    out = set()
    for ma in spec:
        if ma is not None:
            out.update((ma,) if isinstance(ma, str) else ma)
    return out


def _first_holder(spec, mesh) -> bool:
    """Whether this rank is the first of the ranks that hold its block:
    coordinate 0 on every mesh axis the spec does not cut."""
    used = _mesh_axes(spec)
    return all(c == 0 for a, c in mesh.coordinate.items() if a not in used)


def _save_sharded(path: str, step: int, tree: Any, cuts: Any, mesh) -> str:
    import torch.distributed as dist

    from repro_torch.parallel.sharding import shard_index
    final = os.path.join(path, f'step_{step:08d}')
    tmp = final + '.tmp'
    rank0 = dist.get_rank() == 0
    if rank0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    dist.barrier()
    leaves, cut_leaves = tree_leaves(tree), tree_leaves(cuts)
    if len(cut_leaves) != len(leaves):
        raise ValueError(f'{len(leaves)} leaves, {len(cut_leaves)} cuts')
    for i, (leaf, cut) in enumerate(zip(leaves, cut_leaves)):
        if _first_holder(cut.spec, mesh):
            np.save(os.path.join(tmp, f'flat_{i}.{shard_index(cut.spec, mesh)}.npy'),
                    _raw(leaf.detach().cpu()))
    dist.barrier()
    if rank0:
        meta = {'step': step, 'num_leaves': len(leaves), 'treedef': _treedef(tree),
                'mesh': dict(mesh.shape),
                'leaves': [{'shape': list(cut.shape), 'dtype': _NAMES[leaf.dtype],
                            'spec': [list(ma) if isinstance(ma, tuple) else ma
                                     for ma in cut.spec], 'gated': cut.gated}
                           for leaf, cut in zip(leaves, cut_leaves)]}
        with open(os.path.join(tmp, 'manifest.json'), 'w') as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
    dist.barrier()
    return final


def save_checkpoint(path: str, step: int, tree: Any, *, cuts: Any = None, mesh=None) -> str:
    """Blocking save of a tree of tensors (any device). Returns the
    final directory. With ``mesh`` of several ranks, ``tree`` is this
    rank's blocks and ``cuts`` their twin tree of ``weights.Cut``: a
    sharded save, a collective every rank calls."""
    if mesh is not None and mesh.size > 1:
        if cuts is None:
            raise ValueError('a sharded save needs each leaf\'s cut')
        return _save_sharded(path, step, tree, cuts, mesh)
    final = os.path.join(path, f'step_{step:08d}')
    tmp = final + '.tmp'
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = tree_leaves(tree)
    meta = {'step': step, 'num_leaves': len(leaves), 'treedef': _treedef(tree),
            'leaves': [_save_leaf(os.path.join(tmp, f'flat_{i}.npy'), leaf)
                       for i, leaf in enumerate(leaves)]}
    with open(os.path.join(tmp, 'manifest.json'), 'w') as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    return final


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split('_')[1]) for d in os.listdir(path)
             if d.startswith('step_') and not d.endswith('.tmp')
             and os.path.exists(os.path.join(path, d, 'manifest.json'))]
    return max(steps) if steps else None


def _join(d: str, i: int, lm: dict, mesh_shape: dict) -> torch.Tensor:
    """Leaf ``i`` whole from its block files under its saved spec."""
    spec = [tuple(ma) if isinstance(ma, list) else ma for ma in lm['spec']]
    spec += [None] * (len(lm['shape']) - len(spec))
    sizes = [1 if ma is None else math.prod(mesh_shape[a] for a in
                                            ((ma,) if isinstance(ma, str) else ma))
             for ma in spec]
    shape = tuple(lm['shape'])
    whole = torch.empty(shape, dtype=_DTYPES[lm['dtype']])
    local = tuple(n // p for n, p in zip(shape, sizes))
    cut = [d_ for d_, p in enumerate(sizes) if p > 1]
    for b, coords in enumerate(itertools.product(*(range(sizes[d_]) for d_ in cut))):
        # a block's index: row-major over the cut dimensions (shard_index)
        blk = _load_leaf(os.path.join(d, f'flat_{i}.{b}.npy'), local, lm['dtype'])
        where = [slice(None)] * len(shape)
        for d_, r in zip(cut, coords):
            where[d_] = slice(r * local[d_], (r + 1) * local[d_])
        if lm['gated'] and cut and cut[-1] == len(shape) - 1:
            r, n, f = coords[-1], local[-1] // 2, shape[-1] // 2
            for part, off in ((blk[..., :n], 0), (blk[..., n:], f)):
                where[-1] = slice(off + r * n, off + (r + 1) * n)
                whole[tuple(where)] = part
        else:
            whole[tuple(where)] = blk
    return whole


def restore_checkpoint(path: str, step: int, like: Any, device=None, *, cuts: Any = None,
                       mesh=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included): new tensors of each ``like`` leaf's dtype, on
    ``device`` or else on that leaf's device. A sharded checkpoint's
    leaves are joined whole on the host; with ``mesh`` of several ranks
    and ``cuts`` (``weights.Cut`` of each leaf under the target mesh's
    rules) each is cut to this rank's block, ``like`` holding the blocks'
    shapes."""
    from repro_torch.weights import block_of
    d = os.path.join(path, f'step_{step:08d}')
    with open(os.path.join(d, 'manifest.json')) as f:
        meta = json.load(f)
    n = len(tree_leaves(like))
    if meta['num_leaves'] != n:
        raise ValueError(f"checkpoint {d} holds {meta['num_leaves']} leaves, the "
                         f"structure to restore has {n}")
    target = tree_leaves(cuts) if (mesh is not None and mesh.size > 1) else None
    if target is not None and len(target) != n:
        raise ValueError(f'{n} leaves to restore, {len(target)} cuts')
    it = iter(range(n))

    def load(lk: torch.Tensor) -> torch.Tensor:
        i = next(it)
        lm = meta['leaves'][i]
        if 'mesh' in meta:
            t = _join(d, i, lm, meta['mesh'])
        else:
            t = _load_leaf(os.path.join(d, f'flat_{i}.npy'), lm['shape'], lm['dtype'])
        if target is not None:
            t = block_of(t, target[i], mesh)
        if tuple(t.shape) != tuple(lk.shape):
            raise ValueError(f"leaf {i} of {d} has shape {tuple(t.shape)}, the "
                             f"structure to restore {tuple(lk.shape)}")
        return t.to(device=device if device is not None else lk.device, dtype=lk.dtype)
    return tree_map(load, like)


class AsyncCheckpointer:
    """Background-thread writer: ``save`` snapshots the tree to host
    memory before it returns (the caller's next step updates the same
    tensors in place) and writes it to disk off the training thread."""

    def __init__(self, path: str):
        self.path = path
        self._q: "queue.Queue" = queue.Queue()
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()
        self.errors: list = []

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            step, host_tree = item
            try:
                save_checkpoint(self.path, step, host_tree)
            except Exception as e:          # surfaced via .errors
                self.errors.append(e)
            self._q.task_done()

    def save(self, step: int, tree: Any) -> None:
        host = tree_map(lambda x: x.detach().to('cpu', copy=True), tree)
        self._q.put((step, host))

    def wait(self) -> None:
        self._q.join()
        if self.errors:
            raise self.errors[0]

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._t.join()
