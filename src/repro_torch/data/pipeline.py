"""Deterministic synthetic token pipeline with document packing.

Port of ``repro.data.pipeline``. :class:`SyntheticLM` is the reference's
numpy code, copied, so ``batch_at(step)`` gives the reference's bytes in
every mode (tokens, embeds, mrope positions). Batch ``i`` depends only
on (seed, i), so a restart from a checkpoint resumes the stream exactly
(the checkpoint stores the step counter, nothing else).

The generator packs zipf-length 'documents' of a Markov-ish token
process into fixed-length rows separated by EOS: enough structure that
a model's loss visibly drops below the uniform baseline within a few
hundred steps (``examples/torch_train_lm.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos: int = 0
    input_mode: str = 'tokens'        # tokens | embeds
    d_model: int = 0                  # for embeds mode
    mrope: bool = False

    def _perm(self) -> np.ndarray:
        """Fixed Markov successor table (function of the seed only)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0x5EED]))
        p = np.arange(1, self.vocab_size)
        rng.shuffle(p)
        perm = np.zeros(self.vocab_size, np.int64)
        perm[1:] = p                       # successor of v (v >= 1)
        perm[0] = 1 + rng.integers(self.vocab_size - 1)
        return perm

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The (deterministic) global batch for one step."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        perm = self._perm()
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        noise = 0.1
        toks = np.empty((B, S + 1), np.int32)
        for b in range(B):
            row = []
            while len(row) < S + 1:
                doclen = max(min(int(rng.zipf(1.5) * 8),
                                 S + 1 - len(row)), 1)
                # Markov-permutation docs: t_{i+1} = perm[t_i] with 10%
                # noise — a tiny LM learns the bigram table directly
                doc = np.empty(doclen, np.int64)
                doc[0] = 1 + rng.integers(V - 1)
                for i in range(1, doclen):
                    doc[i] = (1 + rng.integers(V - 1)
                              if rng.random() < noise else perm[doc[i - 1]])
                row.extend(doc.tolist())
                if len(row) < S + 1:
                    row.append(self.eos)
            toks[b] = np.asarray(row[:S + 1], np.int32)
        out: Dict[str, np.ndarray] = {
            'labels': toks[:, 1:].astype(np.int32)}
        if self.input_mode == 'embeds':
            emb = rng.standard_normal((B, S, self.d_model)).astype(np.float32)
            out['embeds'] = emb
        else:
            out['tokens'] = toks[:, :-1].astype(np.int32)
        if self.mrope:
            out['positions'] = np.broadcast_to(
                np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def shard_batch(batch: Dict[str, np.ndarray], mesh, dtype_map: Optional[Dict] = None, *,
                shardings: Optional[Dict] = None, microbatches: int = 1
                ) -> Dict[str, torch.Tensor]:
    """Place a host batch on the mesh's device, casting the keys
    ``dtype_map`` names. ``mesh`` is a mesh of :mod:`repro_torch.launch.mesh`
    or a device.

    Without ``shardings`` every rank gets the whole batch (one rank).
    With ``shardings`` (``trainstep.batch_shardings``: each key's
    ``(mesh, spec)``) each rank gets its block: the dimension the batch
    axes cut (the leading one; M-RoPE ``positions``' second), cut
    microbatch by microbatch, so that the step's split of this block
    into ``microbatches`` gives this rank's block of each of the global
    batch's microbatches, as the reference's step shards each one. Only
    the batch axes may cut a batch leaf."""
    device = getattr(mesh, 'device', mesh)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(v))
        if shardings is not None:
            t = _batch_block(t, shardings[k], microbatches)
        if dtype_map and k in dtype_map:
            t = t.to(dtype_map[k])
        out[k] = t.to(device)
    return out


def _batch_block(t: torch.Tensor, sharding, microbatches: int) -> torch.Tensor:
    from repro_torch import comm
    mesh, spec = sharding
    batch_axes = ('pod', 'data') if 'pod' in mesh.shape else ('data',)
    for d, ma in enumerate(spec):
        if ma is None or comm.group_size(mesh, ma) == 1:
            continue
        if comm.axis_tuple(ma) != batch_axes:
            raise ValueError(f'shard_batch cuts a batch leaf over its batch axes {batch_axes} '
                             f'only, not {ma}')
        p, r, B = comm.group_size(mesh, ma), comm.group_index(mesh, ma), t.shape[d]
        if B % (microbatches * p):
            raise ValueError(f'a batch of {B} does not split into {microbatches} microbatches '
                             f'over {p} ranks')
        n = B // microbatches // p
        t = t.unflatten(d, (microbatches, B // microbatches)).narrow(d + 1, r * n, n)
        t = t.flatten(d, d + 1)
    return t.contiguous()
