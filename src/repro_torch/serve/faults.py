"""Deterministic fault injection for the serving stack.

Port of ``repro.serve.faults`` (standard library only; the port keeps
its own copy). A :class:`FaultPlan` is threaded through the stack's
*named sites*, the reference's names:

====================  =====================================================
site                  where it fires
====================  =====================================================
``protocol.send``     :func:`repro_torch.serve.protocol.send_frame` — before
                      the bytes hit the socket (writer loops, client submits)
``protocol.recv``     :func:`repro_torch.serve.protocol.recv_frame` — before
                      the header read (reader loops)
``service.accept``    :class:`repro_torch.serve.service.FFTService` accept
                      loop, per accepted connection
``service.reader``    per received frame in the service's connection loop
``service.writer``    per outbound item in the service's writer loop
``engine.dispatch``   :meth:`repro_torch.serve.fft_engine.FFTEngine._run_group`
                      — one coalesced group's dispatch
``engine.drainer``    top of every drainer pass (stalls the serving loop)
``policy.clock``      every :class:`repro_torch.serve.policy.AdaptivePolicy` /
                      service clock read (skew accumulates)
====================  =====================================================

Each :class:`FaultPoint` names a site, an action and a *schedule*:
either a per-hit probability ``p`` (drawn from a per-site
``random.Random`` seeded by ``(plan seed, site)`` — the same plan
replayed against the same traffic fires identically) or a scripted
``at=`` hit-index list / ``every=`` period. Actions:

* ``'drop'`` — hard-close the socket and raise a connection error;
* ``'truncate'`` — send a prefix of the frame, then close (the peer
  observes a mid-frame EOF, i.e. a typed truncation);
* ``'delay'`` — sleep ``delay_s`` then proceed (slow frame / stall);
* ``'raise'`` — raise :class:`FaultInjected` (dispatch exceptions);
* ``'stall'`` — sleep ``delay_s`` (drainer stalls; distinct name so a
  plan reads as what it does);
* ``'skew'`` — advance the site's accumulated clock offset by
  ``skew_s`` (only meaningful on clock sites).

The plan never *acts* by itself: injection sites call
:meth:`FaultPlan.draw` and perform the action with their own
resources, so this module imports nothing from the stack it breaks.
Every hit and fire is counted per site (:meth:`FaultPlan.stats`), and
the whole plan is safe under concurrent callers.
"""
from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence

ACTIONS = ('drop', 'truncate', 'delay', 'raise', 'stall', 'skew')


class FaultInjected(RuntimeError):
    """An injected failure (the ``'raise'`` action). Typed so tests
    can tell injected faults from real bugs."""

    def __init__(self, site: str, note: str = ''):
        super().__init__(f"injected fault at {site!r}"
                         + (f": {note}" if note else ""))
        self.site = site


class FaultPoint:
    """One fault at one site.

    Args:
      site: the named injection site this point arms.
      action: one of :data:`ACTIONS`.
      p: per-hit fire probability (exclusive with ``at``/``every``).
      at: scripted 0-based hit indices that fire (exclusive with ``p``).
      every: fire every Nth hit (1-based period; exclusive with ``p``).
      limit: stop firing after this many fires (None = unlimited).
      delay_s: sleep length for ``delay``/``stall``.
      skew_s: clock offset added per ``skew`` fire.
      note: free-text carried into :class:`FaultInjected`.
    """

    __slots__ = ('site', 'action', 'p', 'at', 'every', 'limit',
                 'delay_s', 'skew_s', 'note', 'fires')

    def __init__(self, site: str, action: str, *, p: float = 0.0,
                 at: Optional[Sequence[int]] = None,
                 every: Optional[int] = None,
                 limit: Optional[int] = None,
                 delay_s: float = 0.0, skew_s: float = 0.0,
                 note: str = ''):
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(have {ACTIONS})")
        scheduled = (at is not None) + (every is not None) + (p > 0)
        if scheduled != 1:
            raise ValueError(
                "a FaultPoint needs exactly ONE schedule: p>0, at=, "
                "or every=")
        if every is not None and every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.site = site
        self.action = action
        self.p = float(p)
        self.at = None if at is None else frozenset(int(i) for i in at)
        self.every = None if every is None else int(every)
        self.limit = None if limit is None else int(limit)
        self.delay_s = float(delay_s)
        self.skew_s = float(skew_s)
        self.note = note
        self.fires = 0

    def _should_fire(self, hit_index: int, rng: random.Random) -> bool:
        if self.limit is not None and self.fires >= self.limit:
            # exhausted points still consume their probability draw so
            # the OTHER points' draw sequence stays schedule-invariant
            if self.p > 0:
                rng.random()
            return False
        if self.at is not None:
            return hit_index in self.at
        if self.every is not None:
            return (hit_index + 1) % self.every == 0
        return rng.random() < self.p

    def __repr__(self):
        sched = (f"p={self.p}" if self.p > 0 else
                 f"at={sorted(self.at)}" if self.at is not None else
                 f"every={self.every}")
        return (f"FaultPoint({self.site!r}, {self.action!r}, {sched}"
                + (f", limit={self.limit}" if self.limit is not None else "")
                + ")")


class FaultPlan:
    """A seeded, deterministic set of :class:`FaultPoint`\\ s.

    ``draw(site)`` is the one call every injection site makes: it
    advances that site's hit counter, asks each armed point whether it
    fires on this hit, and returns the first firing point (or None).
    Determinism: the probability stream for a site is
    ``random.Random(seed ^ crc32(site))`` consumed strictly in hit
    order, so two runs that visit a site the same number of times see
    the same fires — regardless of what other sites did in between.

    A plan with no points for a site costs one dict lookup per hit;
    the stack is built to accept ``faults=None`` and skip even that.
    """

    def __init__(self, points: Sequence[FaultPoint] = (), *, seed: int = 0):
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._points: Dict[str, List[FaultPoint]] = {}
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._skew: Dict[str, float] = {}
        for pt in points:
            self.add(pt)

    def add(self, point: FaultPoint) -> 'FaultPlan':
        with self._lock:
            self._points.setdefault(point.site, []).append(point)
        return self

    def sites(self) -> List[str]:
        with self._lock:
            return sorted(self._points)

    # -- the one call every site makes ----------------------------------

    def draw(self, site: str) -> Optional[FaultPoint]:
        """Advance ``site``'s hit counter and return the firing point,
        if any. Thread-safe and deterministic in hit order."""
        with self._lock:
            pts = self._points.get(site)
            if not pts:
                return None
            i = self._hits.get(site, 0)
            self._hits[site] = i + 1
            rng = self._rngs.get(site)
            if rng is None:
                rng = self._rngs[site] = random.Random(
                    self.seed ^ zlib.crc32(site.encode('utf-8')))
            fired = None
            for pt in pts:
                if pt._should_fire(i, rng) and fired is None:
                    fired = pt
            if fired is None:
                return None
            fired.fires += 1
            self._fired[site] = self._fired.get(site, 0) + 1
            if fired.action == 'skew':
                self._skew[site] = (self._skew.get(site, 0.0)
                                    + fired.skew_s)
            return fired

    # -- convenience wrappers for common site shapes --------------------

    def perhaps_raise(self, site: str) -> None:
        """Fire-and-raise for exception sites (``engine.dispatch``):
        a ``raise`` fire raises :class:`FaultInjected`; ``delay`` and
        ``stall`` sleep; everything else is ignored (those actions
        need a socket the caller owns)."""
        pt = self.draw(site)
        if pt is None:
            return
        if pt.action == 'raise':
            raise FaultInjected(site, pt.note)
        if pt.action in ('delay', 'stall'):
            time.sleep(pt.delay_s)

    def perhaps_stall(self, site: str) -> float:
        """Sleep out a ``stall``/``delay`` fire; returns the seconds
        slept (0.0 when nothing fired)."""
        pt = self.draw(site)
        if pt is not None and pt.action in ('stall', 'delay'):
            time.sleep(pt.delay_s)
            return pt.delay_s
        return 0.0

    def clock(self, site: str = 'policy.clock'):
        """A ``time.monotonic``-shaped callable whose reads pass
        through this plan: each read is a hit at ``site``, ``skew``
        fires accumulate into the returned time. Hand it to
        anything that accepts a ``clock=`` to test time-discontinuity
        robustness."""
        def _clock() -> float:
            self.draw(site)
            with self._lock:
                off = self._skew.get(site, 0.0)
            return time.monotonic() + off
        return _clock

    def skew_s(self, site: str = 'policy.clock') -> float:
        """The accumulated clock offset at a clock site."""
        with self._lock:
            return self._skew.get(site, 0.0)

    # -- observability --------------------------------------------------

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-site ``{'hits': n, 'fired': m}`` counters (sites with
        armed points only — un-armed sites are never tracked)."""
        with self._lock:
            return {site: {'hits': self._hits.get(site, 0),
                           'fired': self._fired.get(site, 0)}
                    for site in self._points}

    def total_fired(self) -> int:
        with self._lock:
            return sum(self._fired.values())

    def __repr__(self):
        with self._lock:
            parts = [f"{s}:{len(p)}pt/{self._fired.get(s, 0)}f"
                     for s, p in sorted(self._points.items())]
        return f"FaultPlan(seed={self.seed}, {', '.join(parts) or 'empty'})"


def kill_socket(sock) -> None:
    """Hard-close a socket so the peer observes a reset/EOF now, not
    at GC time — the 'drop' action's teeth. Never raises."""
    try:
        sock.shutdown(2)                    # SHUT_RDWR
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass
