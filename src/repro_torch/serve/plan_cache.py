"""LRU cache over the plans of a multi-shape FFT server.

Port of ``repro.serve.plan_cache``. One
:class:`repro_torch.serve.FFTEngine` serving a heterogeneous request
stream holds one plan (and the group shapes it has run) per (shape,
kind) it has seen. Unbounded, that is a memory leak shaped like a
cache; this module bounds it two ways:

* ``max_entries`` — a plain LRU count cap, and
* ``max_bytes`` — a byte budget over per-entry sizes. Entries *grow*
  after insertion (each new group shape adds its staged operand bytes
  via :meth:`LRUPlanCache.grow`), and growth triggers the same
  least-recently-used eviction as insertion.

Eviction never removes the entry being inserted or grown (the engine
is about to execute with it), so the budget is guaranteed whenever any
*other* entry can be freed; a single entry larger than the whole
budget is served but owns the cache alone. ``on_evict(key, value)``
fires once per evicted entry — the engine uses it to drop the evicted
plan's per-rank functions. A hook that *raises* must not poison the
cache: the entry (and its byte accounting) is already gone when the
hook runs, so the exception is swallowed into a ``RuntimeWarning``
(counted in :attr:`LRUPlanCache.evict_errors`) and eviction continues
— a flaky user callback can cost its own side effects, never the
engine's serving loop or the budget invariant.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Callable, Hashable, List, Optional, Tuple


class LRUPlanCache:
    """An ordered (key -> value) map with LRU eviction by entry count
    and/or total bytes. ``get`` marks the entry most-recently-used;
    ``put``/``grow`` evict least-recently-used entries until the caps
    hold again (sparing the entry just touched)."""

    def __init__(self, max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 on_evict: Optional[Callable[[Hashable, object], None]] = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.on_evict = on_evict
        self._entries: 'OrderedDict[Hashable, object]' = OrderedDict()
        self._nbytes: dict = {}
        self.evictions = 0
        self.evict_errors = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    @property
    def total_bytes(self) -> int:
        return sum(self._nbytes.values())

    def keys(self) -> List[Hashable]:
        """Keys in eviction order: least-recently-used first."""
        return list(self._entries)

    def get(self, key):
        """The cached value (marked most-recently-used), or None."""
        if key not in self._entries:
            return None
        self._entries.move_to_end(key)
        return self._entries[key]

    def put(self, key, value, nbytes: int = 0) -> None:
        """Insert (or replace) an entry and evict LRU entries until the
        caps hold; the new entry itself is never evicted."""
        self._entries[key] = value
        self._entries.move_to_end(key)
        self._nbytes[key] = int(nbytes)
        self._shrink(spare=key)

    def grow(self, key, delta: int) -> None:
        """Add ``delta`` bytes to an entry's accounted size (a new group
        shape) and re-apply the byte budget."""
        if key not in self._entries:
            return
        self._nbytes[key] += int(delta)
        self._entries.move_to_end(key)
        self._shrink(spare=key)

    def nbytes(self, key) -> int:
        return self._nbytes.get(key, 0)

    def set_nbytes(self, key, nbytes: int) -> None:
        """Reset an entry's accounted size (e.g. after its group shapes
        were dropped) without touching recency."""
        if key in self._entries:
            self._nbytes[key] = int(nbytes)

    def pop(self, key):
        """Remove an entry without firing ``on_evict`` (the caller owns
        the teardown). Returns the value or None."""
        self._nbytes.pop(key, None)
        return self._entries.pop(key, None)

    def _shrink(self, spare) -> None:
        def over() -> bool:
            if self.max_entries is not None and len(self._entries) > self.max_entries:
                return True
            return (self.max_bytes is not None
                    and self.total_bytes > self.max_bytes)

        while over():
            victim = next(iter(self._entries))
            if victim == spare:
                # only the just-touched entry remains: it is about to be
                # used, so it stays even when alone it busts the budget
                break
            value = self._entries.pop(victim)
            self._nbytes.pop(victim, None)
            self.evictions += 1
            if self.on_evict is not None:
                try:
                    self.on_evict(victim, value)
                except Exception as exc:
                    # the entry and its bytes are already dropped: the
                    # budget invariant holds no matter what the hook
                    # did, so a hook failure must not unwind a put()/
                    # grow() mid-serve
                    self.evict_errors += 1
                    warnings.warn(
                        f"on_evict hook failed for {victim!r}: {exc!r} "
                        f"(entry evicted anyway; byte accounting is "
                        f"consistent)", RuntimeWarning, stacklevel=3)

    def items(self) -> List[Tuple[Hashable, object]]:
        return list(self._entries.items())
