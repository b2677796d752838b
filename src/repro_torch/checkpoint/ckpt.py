"""Checkpoints: atomic manifests, async writes, restore onto a device.

Port of ``repro.checkpoint.ckpt``, with the reference's directory
layout, so either package restores the other's checkpoint:

    <dir>/step_<n>.tmp/...  ->  rename  ->  <dir>/step_<n>/
      flat_<i>.npy    leaf i in sorted-key order, a flat uint8 view of
                      its bytes (a bf16 leaf too: no ml_dtypes needed)
      manifest.json   {step, num_leaves, treedef, leaves: [{shape, dtype}]}

``treedef`` is a description for readers; restore takes the structure
from ``like``. One rank holds every leaf whole, as the reference's
single-host container does.
"""
from __future__ import annotations

import json
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


def save_checkpoint(path: str, step: int, tree: Any) -> str:
    """Blocking save of a tree of tensors (any device). Returns the
    final directory."""
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


def restore_checkpoint(path: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included): new tensors of each ``like`` leaf's dtype, on
    ``device`` or else on that leaf's device."""
    d = os.path.join(path, f'step_{step:08d}')
    with open(os.path.join(d, 'manifest.json')) as f:
        meta = json.load(f)
    n = len(tree_leaves(like))
    if meta['num_leaves'] != n:
        raise ValueError(f"checkpoint {d} holds {meta['num_leaves']} leaves, the "
                         f"structure to restore has {n}")
    it = iter(range(n))

    def load(lk: torch.Tensor) -> torch.Tensor:
        i = next(it)
        lm = meta['leaves'][i]
        t = _load_leaf(os.path.join(d, f'flat_{i}.npy'), lm['shape'], lm['dtype'])
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
