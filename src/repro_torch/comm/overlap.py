"""Compute/communication overlap.

Port of ``repro.comm.overlap``. The pencil schedule alternates a local
pencil FFT with an ownership swap; run back to back, the links idle
during compute and the SMs during the swap. Splitting the local block
into chunks and queueing chunk i+1's compute while chunk i's swap is in
flight overlaps the two.

Where the reference hands the chunked program to XLA's scheduler, the
port issues it in that order itself: chunk i's swap is *started*
(``Strategy.swap_start``: an ``all_to_all_single(..., async_op=True)``,
which NCCL runs on its own stream behind the compute queued before it)
before chunk i+1's FFT is queued, and every started swap is *finished*
(``PendingSwap.wait``) before the pieces are joined. On gloo ranks the
same code runs on CPU tensors; on one rank the swaps are local.

Two granularities live here:

* :func:`pipelined` and :func:`pipelined_pair` chunk ONE call's work
  on a rank's local block;
* :class:`StreamPipeline` / :func:`pipelined_stream` keep a bounded
  window of whole calls in flight on the host (a server's
  cross-request double buffer).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, List, Optional, Sequence

import torch


def pick_chunk_axis(local_shape: Sequence[int], exclude: Sequence[int],
                    n_chunks: int) -> Optional[int]:
    """First local axis that can carry the pipeline: not in ``exclude``
    (the pair's fft and swap axes) and divisible into ``n_chunks``.
    None when no axis qualifies (the caller runs the pair unchunked)."""
    if n_chunks <= 1:
        return None
    for pos, size in enumerate(local_shape):
        if pos not in exclude and size % n_chunks == 0 and size >= n_chunks:
            return pos
    return None


def _join(outs: List, axis: int):
    """Concatenate per-chunk results (tensors or tuples of them)."""
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[k] for o in outs], dim=axis)
                     for k in range(len(outs[0])))
    return torch.cat(outs, dim=axis)


def pipelined(n_chunks: int, axis: int, fn: Callable, *arrays: torch.Tensor):
    """``fn`` over ``n_chunks`` slices of ``arrays`` along ``axis``, the
    results concatenated along the same axis (``fn`` may change sizes on
    other axes, not the chunk axis's position). With ``n_chunks <= 1``
    this is ``fn(*arrays)``. The chunks run in order; for an overlap of
    a swap with compute, :func:`pipelined_pair` splits the swap."""
    if n_chunks <= 1:
        return fn(*arrays)
    parts = zip(*(torch.chunk(a, n_chunks, dim=axis) for a in arrays))
    return _join([fn(*chunk) for chunk in parts], axis)


def pipelined_pair(n_chunks: int, axis: int, *, compute: Callable,
                   swap_start: Callable, swap_first: bool = False,
                   arrays: Sequence[torch.Tensor]):
    """A (compute, swap) pair over ``n_chunks`` slices of ``arrays`` along
    ``axis``, with the swaps in flight while the next chunk computes.

    ``compute(*chunk)`` returns a tuple of tensors, each of which goes
    through ``swap_start(t) -> PendingSwap``. Forward order
    (``swap_first=False``): for each chunk, compute and start its swaps;
    then finish every swap. Mirrored order (``swap_first=True``, the
    (swap, compute) pair of an inverse): start every chunk's swaps, then
    for each chunk finish them and compute. The chunks' results are
    joined along ``axis``."""
    parts = list(zip(*(torch.chunk(a, n_chunks, dim=axis) for a in arrays)))
    if swap_first:
        started = [[swap_start(t) for t in chunk] for chunk in parts]
        outs = [compute(*(h.wait() for h in hs)) for hs in started]
    else:
        started = [[swap_start(t) for t in compute(*chunk)] for chunk in parts]
        outs = [tuple(h.wait() for h in hs) for hs in started]
    return _join(outs, axis)


class StreamPipeline:
    """A bounded window of dispatched-but-unforced calls that persists
    across pushes: the host-level double buffer of a continuous server.

    A call on CUDA tensors returns before the card has run it; pushing
    call i+1 right after call i queues both. :meth:`push` forces the
    oldest in-flight result (waits for the card to reach the end of its
    call) before dispatching a new one once ``depth`` are in flight, so
    at most ``depth`` operands are staged at once. ``on_result(result)``
    runs right after its call is forced, in push order;
    ``on_error(exc)`` names the call whose dispatch or force raised."""

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"StreamPipeline needs depth >= 1, got {depth}")
        self.depth = depth
        self._inflight: deque = deque()

    def __len__(self) -> int:
        return len(self._inflight)

    def _force_oldest(self):
        result, done, on_result, on_error = self._inflight.popleft()
        try:
            if done is not None:
                done.synchronize()
        except BaseException as exc:
            if on_error is not None:
                on_error(exc)
            raise
        if on_result is not None:
            on_result(result)
        return result

    def push(self, thunk: Callable, on_result: Optional[Callable] = None,
             on_error: Optional[Callable] = None):
        """Dispatch ``thunk()``, first forcing the oldest results so that
        at most ``depth`` are in flight (depth 1 serialises)."""
        while len(self._inflight) >= self.depth:
            self._force_oldest()
        try:
            result = thunk()
        except BaseException as exc:
            if on_error is not None:
                on_error(exc)
            raise
        self._inflight.append((result, _done_event(result), on_result, on_error))

    def drain(self) -> None:
        """Force every in-flight result, oldest first."""
        while self._inflight:
            self._force_oldest()

    def abort(self) -> int:
        """Drop every in-flight call unforced (their ``on_result`` never
        runs); returns the number dropped."""
        n = len(self._inflight)
        self._inflight.clear()
        return n


def _done_event(result) -> Optional['torch.cuda.Event']:
    """An event recorded behind the call that made ``result`` when it
    holds a CUDA tensor (CPU results are complete on return), else None."""
    leaves = result if isinstance(result, (tuple, list)) else (result,)
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            return ev
    return None


def pipelined_stream(fn: Callable, stream: Iterable, *,
                     depth: int = 2,
                     on_result: Optional[Callable] = None) -> List:
    """``fn`` over a stream of requests with at most ``depth`` results in
    flight (a one-shot :class:`StreamPipeline`); results in stream order."""
    pipe = StreamPipeline(depth)
    out: List = []

    def collect(r):
        if on_result is not None:
            on_result(r)
        out.append(r)

    for item in stream:
        pipe.push(lambda item=item: fn(item), collect)
    pipe.drain()
    return out
