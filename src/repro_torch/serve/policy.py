"""Adaptive drainer policy: trade coalesce width against observed load.

Port of ``repro.serve.policy`` (pure Python): the same estimator, load
levels and decisions, persisted through the port's own schedule table
(:class:`repro_torch.comm.cost.ScheduleTable`). A row's ``backend`` tag
is the serving mesh's device type, ``'cuda'`` or ``'cpu'``.

The drainer's two triggers — the coalesce-width ``watermark`` and the
``max_wait_ms`` deadline — are a latency/throughput dial with no
single right setting: under a trickle, any watermark above 1 makes
every request wait out the full deadline for batchmates that never
come; under a flood, watermark 1 burns a whole multi-device dispatch
per request and throughput collapses (exactly the schedule-depends-on-
load lesson of Near-Optimal Wafer-Scale Reduce, arXiv 2404.15888, and
the streaming many-small-requests workload of Slide FFT, arXiv
2401.05427). This module closes the loop:

* :class:`RateEstimator` — an exponentially-weighted arrival-rate
  estimate (events/sec) that any intake path feeds with
  :meth:`~RateEstimator.observe`;
* :class:`AdaptivePolicy` — maps the estimated rate to a *load level*
  (level k ~ 2**k expected arrivals per drainer window) and per level
  decides (watermark, max_wait_ms): width grows with load up to
  ``max_coalesce``, the wait is just long enough to fill that width at
  the observed rate, never beyond ``max_wait_ms``.

Decisions are cached per load level and persist as load-tagged rows in
the serving :class:`repro_torch.comm.cost.ScheduleTable`
(``BENCH_torch_serve_schedule.json``), so a restarted service starts warm —
the first burst after a restart is served with last week's measured
settings instead of a cold ramp. The engine's own load-less schedule
lookup never sees these rows (:meth:`ScheduleTable.lookup` separates
the namespaces by the ``load`` tag).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Sequence

from repro_torch.comm import cost as ccost


class RateEstimator:
    """EWMA arrival-rate estimator (events per second).

    A decayed event counter with time constant ``tau_s``: each
    :meth:`observe` first decays the counter by ``exp(-dt/tau)`` and
    then adds the new events; :meth:`rate` reads the decayed counter
    divided by ``tau``. Under a sustained Poisson arrival rate λ the
    counter converges to ``λ·tau``, so the estimate converges to λ;
    after arrivals stop it decays smoothly to zero. Monotone in the
    obvious ways: more events at the same instant never lower the
    estimate, and the estimate never grows while idle.

    Not thread-safe by itself — callers serialize (the service observes
    under its admission lock).

    ``clock`` replaces ``time.monotonic`` as the default time source
    (the fault-injection seam: a skewed clock from
    :meth:`repro_torch.serve.faults.FaultPlan.clock` exercises the
    robustness below). A BACKWARD step is absorbed, never amplified:
    ``_decay_to`` only moves time forward, so a skewed read can stall
    the estimate but cannot make it negative or explode it.
    """

    def __init__(self, tau_s: float = 0.5, *, clock=None):
        if tau_s <= 0:
            raise ValueError(f"tau_s must be > 0, got {tau_s}")
        self.tau_s = float(tau_s)
        self._clock = time.monotonic if clock is None else clock
        self._count = 0.0
        self._t: Optional[float] = None

    def _decay_to(self, now: float) -> None:
        if self._t is not None and now > self._t:
            self._count *= math.exp(-(now - self._t) / self.tau_s)
        if self._t is None or now > self._t:
            self._t = now

    def observe(self, n: int = 1, now: Optional[float] = None) -> None:
        """Record ``n`` arrivals at ``now`` (default: the clock)."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        now = self._clock() if now is None else now
        self._decay_to(now)
        self._count += n

    def rate(self, now: Optional[float] = None) -> float:
        """Estimated arrivals/second at ``now``; 0.0 before any
        observation."""
        if self._t is None:
            return 0.0
        now = self._clock() if now is None else now
        self._decay_to(now)
        return self._count / self.tau_s


@dataclasses.dataclass(frozen=True)
class DrainerDecision:
    """One policy output: the drainer settings for the current load."""
    watermark: int
    max_wait_ms: float
    load_level: int
    rate_per_s: float


class AdaptivePolicy:
    """Arrival-rate-adaptive (watermark, max_wait_ms) for the drainer.

    Args:
      max_coalesce: hard ceiling on the watermark (the engine's
        coalesce bound) — a decision NEVER exceeds it.
      min_wait_ms / max_wait_ms: bounds on the deadline trigger. The
        widest wait also defines the load window: level k means
        ~2**k expected arrivals per ``max_wait_ms``.
      tau_s: the rate estimator's time constant.
      overlap_chunks: recorded into persisted rows (the in-call
        pipelining depth the engine serves with; purely descriptive
        here).
      clock: replaces ``time.monotonic`` for every internal time read
        (rate estimation and level bucketing) — the fault-injection
        clock-skew seam. Decisions stay clamped to
        ``[1, max_coalesce]`` x ``[min_wait_ms, max_wait_ms]`` no
        matter what the clock does.
    """

    def __init__(self, max_coalesce: int = 16, *,
                 min_wait_ms: float = 0.5, max_wait_ms: float = 50.0,
                 tau_s: float = 0.5, overlap_chunks: int = 1,
                 clock=None):
        if max_coalesce < 1:
            raise ValueError(f"max_coalesce must be >= 1, got {max_coalesce}")
        if not 0 < min_wait_ms <= max_wait_ms:
            raise ValueError(
                f"need 0 < min_wait_ms <= max_wait_ms, got "
                f"({min_wait_ms}, {max_wait_ms})")
        self.max_coalesce = int(max_coalesce)
        self.min_wait_ms = float(min_wait_ms)
        self.max_wait_ms = float(max_wait_ms)
        self.overlap_chunks = int(overlap_chunks)
        self.clock = time.monotonic if clock is None else clock
        self.estimator = RateEstimator(tau_s, clock=self.clock)
        #: the top load level: widths are 2**level capped at
        #: max_coalesce, so levels beyond ceil(log2(max_coalesce))
        #: collapse onto the cap.
        self.n_levels = max(1, math.ceil(math.log2(self.max_coalesce)) + 1)
        # level -> (watermark, max_wait_ms); seeded rows and computed
        # decisions both land here, and rows() reads it back out
        self._levels: Dict[int, tuple] = {}
        self._level_us: Dict[int, float] = {}   # observed us/request EWMA

    # -- intake -------------------------------------------------------------

    def observe(self, n: int = 1, now: Optional[float] = None) -> None:
        """Feed the rate estimator — call once per *offered* request
        (admitted or not: backpressure decisions need the offered
        load, not the admitted one)."""
        self.estimator.observe(n, now)

    def note_latency(self, us: float, now: Optional[float] = None) -> None:
        """Record one served request's latency (EWMA per current load
        level) — persisted rows carry it as ``us_per_request`` so the
        table doubles as a load/latency profile."""
        level = self.load_level(self.estimator.rate(now))
        prev = self._level_us.get(level)
        self._level_us[level] = (float(us) if prev is None
                                 else 0.9 * prev + 0.1 * float(us))

    # -- the decision -------------------------------------------------------

    def load_level(self, rate_per_s: float) -> int:
        """Bucket an arrival rate: level k ⇔ expected arrivals per
        widest drainer window in [2**k, 2**(k+1)), clamped to the level
        range. Taking the FLOOR keeps the invariant that level k's
        width 2**k can actually fill within ``max_wait_ms`` at the
        observed rate — a width the window cannot fill would make every
        remainder request donate the whole wait for batchmates that
        never come."""
        expected = rate_per_s * self.max_wait_ms / 1e3
        if expected < 2.0:
            return 0
        return min(int(math.log2(expected)), self.n_levels - 1)

    def decide(self, now: Optional[float] = None) -> DrainerDecision:
        """The drainer settings for the load observed *now*. A seeded
        (persisted) row for the level wins; otherwise the width is
        2**level (capped at ``max_coalesce``) and the wait is just long
        enough to fill that width at the observed rate."""
        rate = self.estimator.rate(now)
        level = self.load_level(rate)
        if level in self._levels:
            w, wait = self._levels[level]
        else:
            w = min(self.max_coalesce, 1 << level)
            if w <= 1:
                w, wait = 1, self.min_wait_ms
            else:
                # time to accumulate w arrivals at the observed rate;
                # the level-0 guard above means rate > 0 here
                wait = min(self.max_wait_ms,
                           max(self.min_wait_ms, w / rate * 1e3))
            self._levels[level] = (w, wait)
        w = min(int(w), self.max_coalesce)       # seeded rows obey the cap
        return DrainerDecision(watermark=w, max_wait_ms=float(wait),
                               load_level=level, rate_per_s=rate)

    # -- persistence (load-tagged ScheduleTable rows) -----------------------

    def rows(self, mesh_shape, shape: Sequence[int], kind: str,
             strategy: str, *, backend: Optional[str] = None) -> list:
        """The decided levels as load-tagged schedule rows, ready for
        :func:`repro_torch.comm.cost.persist_schedule_rows`."""
        mesh_k, shape_k, kind_k, strat_k = ccost.ScheduleTable.make_key(
            mesh_shape, shape, kind, strategy)
        out = []
        for level in sorted(self._levels):
            w, wait = self._levels[level]
            row = dict(mesh=mesh_k, shape=shape_k, kind=kind_k,
                       strategy=strat_k, load=int(level),
                       coalesce_width=int(w),
                       overlap_chunks=self.overlap_chunks,
                       max_wait_ms=float(wait))
            if backend is not None:
                row['backend'] = backend
            if level in self._level_us:
                row['us_per_request'] = self._level_us[level]
            out.append(row)
        return out

    def seed(self, table: Optional['ccost.ScheduleTable'], mesh_shape,
             shape: Sequence[int], kind: str, strategy: str, *,
             backend: Optional[str] = None) -> int:
        """Warm-start from persisted load-tagged rows: every level with
        an EXACT-level row adopts its (width, wait). Returns how many
        levels were seeded. Nearest-level fallback is deliberately not
        used here — a wrong-level seed would stick (seeded levels are
        never recomputed)."""
        if table is None:
            return 0
        seeded = 0
        for level in range(self.n_levels):
            row = table.lookup(mesh_shape, shape, kind, strategy,
                               backend=backend, load=level)
            if row is None or row.get('load') is None:
                continue
            if int(row['load']) != level:
                continue
            w = min(int(row['coalesce_width']), self.max_coalesce)
            wait = float(row.get('max_wait_ms', self.max_wait_ms))
            wait = min(max(wait, self.min_wait_ms), self.max_wait_ms)
            self._levels[level] = (w, wait)
            if 'us_per_request' in row:
                self._level_us[level] = float(row['us_per_request'])
            seeded += 1
        return seeded

    def __repr__(self):
        return (f"AdaptivePolicy(max_coalesce={self.max_coalesce}, "
                f"wait=[{self.min_wait_ms},{self.max_wait_ms}]ms, "
                f"levels={{{', '.join(f'{k}: {v}' for k, v in sorted(self._levels.items()))}}})")
