"""Multi-tenant FFT service: a socket front-end over one FFTEngine.

Port of ``repro.serve.service``. It speaks the same ``WFFT`` frames
(:mod:`repro_torch.serve.protocol`), so a client of either package is
served by a service of the other. Differences kept on purpose:

* a result reaches the host in the writer thread (``Tensor.cpu()``,
  planar pairs each), after its group's CUDA event was synchronized —
  a ticket resolves only then;
* the dedup window keeps the host arrays of a delivered result, never
  the engine ticket: a result is a view of its group's batched output
  on the card, and a window of tickets would keep every keyed group's
  output alive for ``dedup_window_s``. A redelivery sends those same
  host arrays (bit-identical, never recomputed);
* schedule rows carry the mesh's device type (``'cuda'``/``'cpu'``) as
  their ``backend`` tag;
* the service needs a background engine, and the port's engine runs its
  drainer on one rank only: on a larger mesh building the service's
  engine raises ``ValueError``;
* :meth:`FFTService.close` shuts the listener down, which wakes the
  accept thread at once (closing it alone leaves ``accept()`` blocked).

The engine already keeps a single warm pipeline saturated —
but only for the process that owns it. Every additional client process
would pay its own plan cache, its own compilations, its own cold
pipeline. :class:`FFTService` multiplexes many client connections onto
ONE shared engine: requests arrive as length-prefixed frames
(:mod:`repro_torch.serve.protocol`), are admission-controlled per tenant,
queued into the engine's coalescing drainer, and answered
asynchronously as they resolve. Production concerns are the feature:

* **admission control** — per-tenant token buckets (sustained rate +
  burst) and inflight quotas, plus a global inflight window sized to
  the engine's pipeline. Saturation is an explicit, typed
  ``RETRY_AFTER`` answer carrying a retry hint — never silent
  queueing, so a flooding tenant observes backpressure instead of
  inflating everyone's latency.
* **latency SLO classes** — each request resolves an SLO class
  (request field, else tenant default) whose budget propagates into
  the drainer as that request's ``max_wait_ms`` deadline: interactive
  requests ripen their queue in milliseconds while batch requests
  wait out wide coalesces, on the same engine.
* **adaptive drainer policy** — the service feeds every *offered*
  request into :class:`repro_torch.serve.policy.AdaptivePolicy`'s rate
  estimator and retargets the engine's (watermark, max_wait_ms) as
  the load level shifts; decided levels persist as load-tagged
  schedule rows so restarts start warm.
* **metrics** — per-tenant and per-shape counters, p50/p99 latency vs
  the SLO deadline, admission rejections by reason, engine queue
  depths and the coalesce-width histogram, exported as one JSON
  document (the ``METRICS`` frame and :meth:`FFTService.metrics`).
* **graceful drain** — :meth:`FFTService.close` stops accepting,
  waits for every admitted request to resolve, persists the policy,
  and closes the engine it owns.

Partial failure is the steady state of an always-on service, so the
front-end carries its own resilience machinery (validated by the
deterministic fault plane in :mod:`repro_torch.serve.faults` and the
chaos cases of ``tests/test_torch_service_chaos.py``):

* **per-tenant fair scheduling** — admitted requests flow through
  weighted deficit round-robin over per-tenant sub-queues
  (:class:`_FairScheduler`) before reaching the engine's drainer, so
  an admitted burst from one tenant can no longer push another
  tenant's whole window behind it (admission quotas bound *how much*
  enters; the scheduler bounds *in what order*).
* **idempotent resubmit** — clients stamp each request with a dedup
  ``key``; the service keeps a bounded server-side dedup window
  (:class:`_DedupWindow`): a resubmitted completed request is
  re-delivered from cache (bit-identical, never recomputed), a
  resubmitted in-flight request re-attaches delivery to the new
  connection (never duplicated). With heartbeats and dead-connection
  reaping, an :class:`FFTClient` survives a mid-flight connection
  drop with exactly-once results.
* **brownout degradation** — a circuit breaker
  (:class:`BrownoutBreaker`) tied to the adaptive policy's load level
  and the dispatch failure stream sheds configured (default
  ``batch``) SLO classes with typed ``RETRY_AFTER('brownout')`` under
  sustained overload, keeping interactive traffic inside its
  deadline, and recovers automatically through half-open probes.
* **hot config reload** — :meth:`FFTService.reload_tenants` (driven
  by the ``RELOAD`` frame, or SIGHUP on the launcher) atomically
  swaps :class:`TenantConfig` entries without dropping inflight
  requests; the reload generation is part of the metrics surface.

:class:`FFTClient` is the thin matching client: ``submit`` returns a
ticket, a reader thread demultiplexes result/backpressure frames by
request id, and ``transform`` adds honor-the-hint retries with capped
exponential backoff, a total-deadline budget (typed
:class:`ServiceUnavailable` at exhaustion) and
reconnect-and-resubmit on dropped connections.
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import random
import socket
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from repro_torch.comm import cost as ccost
from repro_torch.serve import protocol as proto
from repro_torch.serve.faults import FaultInjected, kill_socket
from repro_torch.serve.fft_engine import FFTEngine, ResultTimeout
from repro_torch.serve.policy import AdaptivePolicy

Address = Union[str, Tuple[str, int]]


class RetryAfter(RuntimeError):
    """Typed backpressure: the service refused admission and the
    caller should retry after ``retry_after_ms``. ``reason`` is one of
    ``'rate'`` (token bucket empty), ``'tenant_quota'`` (per-tenant
    inflight cap), ``'inflight_window'`` (the service-wide window) or
    ``'brownout'`` (the circuit breaker is shedding this SLO class
    under overload)."""

    def __init__(self, reason: str, retry_after_ms: float,
                 tenant: Optional[str] = None):
        super().__init__(
            f"admission refused ({reason}"
            + (f", tenant {tenant!r}" if tenant else "")
            + f"): retry after {retry_after_ms:.1f} ms")
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)
        self.tenant = tenant


class ServiceUnavailable(RuntimeError):
    """The client exhausted its retry budget (attempts or total
    deadline) without a served result. ``last_error`` carries the
    final failure (a :class:`RetryAfter`, ``ConnectionError``, ...)."""

    def __init__(self, msg: str, last_error: Optional[BaseException] = None):
        super().__init__(msg)
        self.last_error = last_error


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One latency class. ``deadline_ms`` is the p99 target the
    metrics report violations against; ``max_wait_ms`` is how long a
    request of this class may sit in a coalescing queue (the drainer
    deadline propagated per request) — by default a quarter of the
    deadline, leaving the rest for execution."""
    name: str
    deadline_ms: float
    max_wait_ms: Optional[float] = None

    def wait_ms(self) -> float:
        return (self.deadline_ms / 4.0 if self.max_wait_ms is None
                else self.max_wait_ms)


def default_slo_classes() -> Dict[str, SLOClass]:
    return {c.name: c for c in (
        SLOClass('interactive', deadline_ms=50.0, max_wait_ms=2.0),
        SLOClass('standard', deadline_ms=250.0, max_wait_ms=20.0),
        SLOClass('batch', deadline_ms=2000.0, max_wait_ms=100.0),
    )}


@dataclasses.dataclass
class TenantConfig:
    """Static per-tenant admission policy. ``rate_per_s`` / ``burst``
    parameterize a token bucket over *offered* requests;
    ``max_inflight`` caps this tenant's admitted-but-unresolved
    requests; ``slo`` names the default SLO class; ``token`` is an
    optional shared secret the client must echo in HELLO; ``weight``
    is this tenant's fair-scheduler share (deficit round-robin
    quantum — 2.0 drains twice as fast as 1.0 under contention);
    ``admin`` lets the tenant drive ``RELOAD`` frames."""
    name: str
    rate_per_s: float = math.inf
    burst: int = 64
    max_inflight: int = 16
    slo: str = 'standard'
    token: Optional[str] = None
    weight: float = 1.0
    admin: bool = False

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0, "
                             f"got {self.weight}")

    def to_dict(self) -> dict:
        """JSON-safe form (the RELOAD frame / --tenant-file format)."""
        d = dataclasses.asdict(self)
        if math.isinf(d['rate_per_s']):
            d['rate_per_s'] = None
        return d

    @classmethod
    def from_dict(cls, d: dict) -> 'TenantConfig':
        d = dict(d)
        if d.get('rate_per_s') in (None, 'inf'):
            d['rate_per_s'] = math.inf
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown TenantConfig fields {sorted(unknown)}")
        return cls(**d)


class _TokenBucket:
    """Classic token bucket; returns 0.0 on admit, else the seconds
    until a token will exist."""

    def __init__(self, rate_per_s: float, burst: int):
        self.rate = float(rate_per_s)
        self.burst = max(1, int(burst))
        self.tokens = float(self.burst)
        self._t = time.monotonic()

    def try_take(self, now: Optional[float] = None) -> float:
        if math.isinf(self.rate):
            return 0.0
        now = time.monotonic() if now is None else now
        # a skewed clock (fault plane: 'skew') may hand us time that
        # runs backward; clamping dt at 0 means skew can only pause
        # refill, never confiscate banked tokens or inflate the wait
        dt = max(0.0, now - self._t)
        self.tokens = min(self.burst, self.tokens + dt * self.rate)
        self._t = max(self._t, now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        if self.rate <= 0:
            return math.inf
        return (1.0 - self.tokens) / self.rate


class _Tenant:
    """Runtime state for one tenant. Survives a hot config reload:
    :meth:`swap_cfg` replaces the policy (bucket, quota, weight)
    while every counter and inflight request rides through."""

    def __init__(self, cfg: TenantConfig):
        self.cfg = cfg
        self.bucket = _TokenBucket(cfg.rate_per_s, cfg.burst)
        self.inflight = 0
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.scheduled = 0          # dispatched to the engine (DRR order)
        self.retired = False        # removed by reload: no new admits
        self.rejected: Dict[str, int] = {}
        # slo name -> deque of latency_ms samples (bounded reservoir)
        self.latencies: Dict[str, deque] = {}

    def swap_cfg(self, cfg: TenantConfig) -> None:
        """Atomic-under-the-service-lock policy swap: new bucket
        (full burst — a reload should never instantly reject),
        counters and inflight untouched."""
        self.cfg = cfg
        self.bucket = _TokenBucket(cfg.rate_per_s, cfg.burst)
        self.retired = False

    def record_latency(self, slo: str, ms: float) -> None:
        self.latencies.setdefault(slo, deque(maxlen=4096)).append(ms)


def _percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of a non-empty sample list."""
    s = sorted(samples)
    return s[min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))]


class _Pending:
    """One admitted request parked between admission and engine
    dispatch (the fair scheduler's queue element)."""

    __slots__ = ('x', 'direction', 'real', 'op', 'wait_ms', 'conn',
                 'tenant', 'slo', 'shape_key', 'req_id', 'key', 't_submit')

    def __init__(self, x, direction, real, wait_ms, conn, tenant, slo,
                 shape_key, req_id, key, t_submit, op=None):
        self.x = x
        self.direction = direction
        self.real = real
        self.op = op
        self.wait_ms = wait_ms
        self.conn = conn
        self.tenant = tenant
        self.slo = slo
        self.shape_key = shape_key
        self.req_id = req_id
        self.key = key
        self.t_submit = t_submit


class _FairScheduler:
    """Weighted deficit round-robin over per-tenant sub-queues.

    Admission quotas bound HOW MUCH each tenant may have unresolved;
    this scheduler bounds IN WHAT ORDER admitted requests reach the
    engine's (FIFO-coalescing) drainer. It holds at most ``window``
    requests dispatched-but-unresolved; the rest wait in their
    tenant's sub-queue and are released in DRR order — each rotation
    grants every backlogged tenant ``weight`` units of deficit, one
    unit buys one dispatch, an emptied queue forfeits its leftover
    deficit (the classic no-banking rule, so an idle tenant cannot
    save up a burst). A tenant with weight 2.0 therefore drains twice
    as fast as a weight-1.0 tenant under contention, and a flood from
    one tenant can no longer push another tenant's whole window behind
    it.

    Not thread-safe by itself — the service serializes calls under its
    scheduler lock and performs the actual dispatches outside it.
    """

    def __init__(self, window: int):
        self.window = max(1, int(window))
        self.active = 0                        # dispatched, not yet resolved
        self._queues: 'OrderedDict[str, deque]' = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self._weights: Dict[str, float] = {}
        # persistent rotation pointer: the next take() resumes at the
        # tenant AFTER the last one served, so a tenant that fills the
        # window never also goes first on the next turn
        self._ring: deque = deque()

    def offer(self, tenant: str, weight: float, item) -> None:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._ring.append(tenant)
        self._weights[tenant] = float(weight)
        q.append(item)

    def done(self) -> None:
        self.active -= 1

    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def take(self) -> List[tuple]:
        """``(tenant, item)`` pairs to dispatch now, in DRR order, up
        to the window. Increments ``active`` per pair — the caller
        calls :meth:`done` as each resolves."""
        out: List[tuple] = []
        while (self.active < self.window
               and any(self._queues.values())):
            t = self._ring[0]
            q = self._queues[t]
            if not q:
                self._deficit[t] = 0.0
                self._ring.rotate(-1)
                continue
            d = self._deficit.get(t, 0.0) + self._weights.get(t, 1.0)
            while q and d >= 1.0 and self.active < self.window:
                out.append((t, q.popleft()))
                d -= 1.0
                self.active += 1
            self._deficit[t] = d if q else 0.0
            self._ring.rotate(-1)
        return out


def _host_array(v: torch.Tensor) -> np.ndarray:
    """One result on the host, in memory of its own: the tensor (a view
    of its group's batched output, on the card or the CPU) is copied out,
    so nothing kept from it holds the group's output alive."""
    return v.detach().to('cpu', copy=True).numpy()


class _Delivery:
    """One settled request's answer as the wire sends it. The engine
    ticket is read once — by the first writer to send it, on the writer
    thread, after the ticket resolved — into host arrays (or the error
    text), and dropped: a redelivery from the dedup window sends the same
    arrays and never touches the engine or the card."""

    __slots__ = ('_lock', '_ticket', '_payload', 'keyed')

    def __init__(self, ticket, *, keyed: bool):
        self._lock = threading.Lock()
        self._ticket = ticket
        self._payload: Optional[tuple] = None
        self.keyed = keyed

    def payload(self) -> tuple:
        """``('error', text)``, or ``(form, arrays)`` with form
        ``'planar'`` or ``'array'``."""
        with self._lock:
            if self._payload is None:
                t, self._ticket = self._ticket, None
                try:
                    value = t.result(timeout=0)   # a failed ticket raises
                    if isinstance(value, tuple):
                        self._payload = ('planar',
                                         [_host_array(v) for v in value])
                    else:
                        self._payload = ('array', [_host_array(value)])
                except Exception as exc:
                    # the request's failure, or a failed copy to the
                    # host: either way it is answered, never dropped
                    self._payload = ('error', f"{type(exc).__name__}: {exc}")
            return self._payload


class _DedupEntry:
    __slots__ = ('state', 'delivery', 'conn', 'req_id', 'done_t')


class _DedupWindow:
    """Bounded server-side request-id dedup window (exactly-once
    delivery for keyed submits).

    Keyed by ``(tenant, client key)``. An ``'inflight'`` entry means
    the work is queued or running: a resubmit RE-ATTACHES delivery to
    the new connection (never a second computation). A ``'done'``
    entry holds the settled request's :class:`_Delivery` for
    ``window_s`` seconds — its host arrays once a writer has sent it,
    never the engine's output — and a resubmit is RE-DELIVERED from
    it, bit-identical, never recomputed. Capacity eviction drops the
    oldest *done* entries only — inflight entries are pinned (the
    admission window bounds how many can exist, so a ``max_entries``
    above it can always make room).
    """

    def __init__(self, window_s: float = 30.0, max_entries: int = 1024,
                 *, clock=None):
        self.window_s = float(window_s)
        self.max_entries = max(1, int(max_entries))
        self._clock = time.monotonic if clock is None else clock
        self._lock = threading.Lock()
        self._entries: 'OrderedDict[tuple, _DedupEntry]' = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.redelivered = 0
        self.reattached = 0

    def begin(self, tenant: str, key: str, conn, req_id):
        """Register/lookup one keyed submit. Returns one of
        ``('new', None)`` (fresh work — caller admits and dispatches),
        ``('done', delivery)`` (re-deliver from cache), or
        ``('inflight', (old_conn, old_req_id))`` (delivery re-attached
        to ``conn``/``req_id``; caller transfers DRAIN tracking)."""
        k = (tenant, key)
        with self._lock:
            self._expire_locked(self._clock())
            e = self._entries.get(k)
            if e is None:
                self.misses += 1
                e = _DedupEntry()
                e.state, e.delivery = 'inflight', None
                e.conn, e.req_id, e.done_t = conn, req_id, None
                self._entries[k] = e
                self._evict_locked()
                return 'new', None
            self.hits += 1
            if e.state == 'done':
                self.redelivered += 1
                self._entries.move_to_end(k)
                return 'done', e.delivery
            old = (e.conn, e.req_id)
            e.conn, e.req_id = conn, req_id
            self.reattached += 1
            return 'inflight', old

    def settle(self, tenant: str, key: str, delivery: _Delivery):
        """Mark keyed work done; returns the CURRENT ``(conn,
        req_id)`` attachment (the resubmitting connection, if delivery
        was re-attached mid-flight), or None if the entry was
        forgotten."""
        with self._lock:
            e = self._entries.get((tenant, key))
            if e is None:
                return None
            e.state, e.delivery, e.done_t = 'done', delivery, self._clock()
            return (e.conn, e.req_id)

    def forget(self, tenant: str, key: str) -> None:
        """Drop an entry (pre-engine failure: the retry must redo the
        admission walk, not observe a half-registered entry)."""
        with self._lock:
            self._entries.pop((tenant, key), None)

    def expire(self) -> None:
        with self._lock:
            self._expire_locked(self._clock())

    def _expire_locked(self, now: float) -> None:
        dead = [k for k, e in self._entries.items()
                if e.state == 'done' and now - e.done_t > self.window_s]
        for k in dead:
            del self._entries[k]

    def _evict_locked(self) -> None:
        if len(self._entries) <= self.max_entries:
            return
        for k in list(self._entries):
            if self._entries[k].state == 'done':
                del self._entries[k]
                if len(self._entries) <= self.max_entries:
                    return

    def info(self) -> dict:
        with self._lock:
            return {'entries': len(self._entries), 'hits': self.hits,
                    'misses': self.misses,
                    'redelivered': self.redelivered,
                    'reattached': self.reattached}


class BrownoutBreaker:
    """Circuit breaker driving brownout degradation.

    Under sustained overload the right failure mode is PARTIAL: keep
    interactive traffic inside its deadline by shedding the classes
    that can wait. The breaker trips ``closed -> open`` on either
    signal:

    * ``failure_threshold`` CONSECUTIVE dispatch failures (the engine
      is sick), or
    * the adaptive policy reporting its top load level for
      ``overload_trip`` consecutive decisions (the offered load is
      beyond what coalescing can absorb).

    While open, requests in ``shed_slos`` (default: ``batch``) are
    refused with ``RETRY_AFTER('brownout', <cooldown left>)``; other
    classes are NEVER shed here. After ``cooldown_s`` the breaker
    half-opens: up to ``probe_quota`` shed-class requests pass as
    probes — ``probe_quota`` successes close it, any failure reopens
    it (fresh cooldown). All transitions are counted for the metrics
    surface. Thread-safe; ``clock`` is the fault-injection seam.
    """

    def __init__(self, *, shed_slos: Sequence[str] = ('batch',),
                 failure_threshold: int = 5, overload_trip: int = 8,
                 cooldown_s: float = 1.0, probe_quota: int = 3,
                 clock=None):
        if failure_threshold < 1 or overload_trip < 1 or probe_quota < 1:
            raise ValueError("failure_threshold, overload_trip and "
                             "probe_quota must all be >= 1")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        self.shed_slos = frozenset(shed_slos)
        self.failure_threshold = int(failure_threshold)
        self.overload_trip = int(overload_trip)
        self.cooldown_s = float(cooldown_s)
        self.probe_quota = int(probe_quota)
        self._clock = time.monotonic if clock is None else clock
        self._lock = threading.Lock()
        self.state = 'closed'
        self.transitions: Dict[str, int] = {}
        self.shed_count = 0
        self._consec_fail = 0
        self._consec_overload = 0
        self._opened_at: Optional[float] = None
        self._probes_out = 0
        self._probe_ok = 0

    # all _-methods below run with the lock held

    def _move(self, new: str) -> None:
        key = f"{self.state}_to_{new}"
        self.transitions[key] = self.transitions.get(key, 0) + 1
        self.state = new

    def _trip(self) -> None:
        self._move('open')
        self._opened_at = self._clock()

    def _tick(self) -> None:
        if (self.state == 'open'
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._move('half_open')
            self._probes_out = 0
            self._probe_ok = 0

    # -- inputs ---------------------------------------------------------

    def note_load(self, level: int, n_levels: int) -> None:
        """Feed one adaptive-policy decision (its load level)."""
        with self._lock:
            if n_levels > 1 and level >= n_levels - 1:
                self._consec_overload += 1
            else:
                self._consec_overload = 0
            if (self.state == 'closed'
                    and self._consec_overload >= self.overload_trip):
                self._trip()

    def record_success(self) -> None:
        with self._lock:
            self._consec_fail = 0
            if self.state == 'half_open':
                self._probe_ok += 1
                if self._probe_ok >= self.probe_quota:
                    self._move('closed')
                    self._consec_overload = 0

    def record_failure(self) -> None:
        with self._lock:
            self._consec_fail += 1
            if self.state == 'half_open':
                self._trip()
            elif (self.state == 'closed'
                  and self._consec_fail >= self.failure_threshold):
                self._trip()

    # -- the decision ---------------------------------------------------

    def should_shed(self, slo_name: str) -> Optional[float]:
        """The retry-after hint (ms) when this request must be shed,
        None when it may proceed (possibly as a half-open probe)."""
        with self._lock:
            self._tick()
            if slo_name not in self.shed_slos:
                return None
            if self.state == 'open':
                self.shed_count += 1
                left = self.cooldown_s - (self._clock() - self._opened_at)
                return max(1.0, left * 1e3)
            if self.state == 'half_open':
                if self._probes_out < self.probe_quota:
                    self._probes_out += 1
                    return None
                self.shed_count += 1
                return max(1.0, self.cooldown_s * 5e2)
            return None

    def info(self) -> dict:
        with self._lock:
            return {'state': self.state, 'shed': self.shed_count,
                    'consecutive_failures': self._consec_fail,
                    'transitions': dict(self.transitions)}

    def __repr__(self):
        return (f"BrownoutBreaker(state={self.state!r}, "
                f"shed={sorted(self.shed_slos)}, "
                f"transitions={self.transitions})")


class _Conn:
    """One client connection: its socket, tenant, outbound queue (one
    writer thread serializes the socket), an inflight counter for
    DRAIN semantics, and a liveness stamp for the reaper."""

    def __init__(self, sock):
        self.sock = sock
        self.outq: 'queue.Queue' = queue.Queue()
        self.tenant: Optional[_Tenant] = None
        self.client_id: Optional[str] = None
        self.inflight = 0
        self.cond = threading.Condition()
        self.dead = False
        self.closed = False             # the writer was told to stop
        self.last_seen = time.monotonic()

    def track(self, delta: int) -> None:
        with self.cond:
            self.inflight += delta
            if self.inflight <= 0:
                self.cond.notify_all()

    def send(self, msg_type: int, meta: dict, arrays: Sequence = ()) -> None:
        """Queue one frame for the writer thread (pre-packing happens
        there; what crosses this queue is cheap to build)."""
        self.outq.put(('frame', msg_type, meta, tuple(arrays)))

    def deliver(self, item: tuple) -> bool:
        """Queue one result for the writer; False once the writer was
        told to stop (nothing would ever send or drop the item)."""
        with self.cond:
            if self.closed:
                return False
            self.outq.put(item)
            return True

    def stop_writer(self) -> None:
        with self.cond:
            self.closed = True
            self.outq.put(None)


class FFTService:
    """The multi-tenant socket front-end over one :class:`FFTEngine`.

    Args:
      mesh: device mesh for the engine the service builds (ignored
        when ``engine`` is given).
      engine: an existing *background* engine to serve with; the
        service takes over its drainer triggers when the adaptive
        policy is on. Default: the service builds (and owns, and
        closes) ``FFTEngine(mesh=mesh, background=True,
        **engine_kwargs)``.
      address: a unix socket path (str) or a ``(host, port)`` TCP
        tuple; may instead be passed to :meth:`start`.
      tenants: :class:`TenantConfig` entries. With none given, unknown
        tenants are auto-admitted under a default config; with any
        given, unknown tenants are rejected unless
        ``allow_unknown_tenants=True``.
      slo_classes: latency classes by name
        (default :func:`default_slo_classes`).
      max_inflight: the service-wide admitted-but-unresolved window —
        beyond it every tenant sees ``RETRY_AFTER('inflight_window')``.
      policy: ``'adaptive'`` (default) builds an
        :class:`AdaptivePolicy` sized to the engine and retargets the
        drainer as load shifts; an :class:`AdaptivePolicy` instance is
        used as given; None leaves the engine's triggers alone.
      persist_policy: persist the policy's load-level rows into the
        serving schedule table on :meth:`close` (needs the engine's
        schedule table enabled).
      faults: a :class:`repro_torch.serve.faults.FaultPlan` armed against
        this service's injection sites (tests/chaos only; None — the
        default — costs nothing). Also threaded into the engine the
        service builds and into every policy clock read.
      dedup_window_s / dedup_max_entries: the idempotent-resubmit
        window — how long (and how many) settled keyed results stay
        re-deliverable.
      heartbeat_timeout_s: reap (hard-close) a connection whose last
        frame — heartbeats count — is older than this. None disables
        reaping.
      brownout: True (default) builds a :class:`BrownoutBreaker` with
        defaults; a :class:`BrownoutBreaker` instance is used as
        given; False/None disables brownout shedding.
      fair_scheduling: run admitted requests through weighted deficit
        round-robin (:class:`_FairScheduler`) instead of straight to
        the engine; ``sched_window`` bounds dispatched-but-unresolved
        requests (default ``max(4, 2 * engine.max_coalesce)``).
      **engine_kwargs: forwarded to the engine the service builds.
    """

    def __init__(self, mesh=None, *, engine: Optional[FFTEngine] = None,
                 address: Optional[Address] = None,
                 tenants: Sequence[TenantConfig] = (),
                 slo_classes: Optional[Dict[str, SLOClass]] = None,
                 max_inflight: int = 64,
                 policy: Union[str, AdaptivePolicy, None] = 'adaptive',
                 allow_unknown_tenants: Optional[bool] = None,
                 persist_policy: bool = True,
                 faults=None,
                 dedup_window_s: float = 30.0,
                 dedup_max_entries: int = 1024,
                 heartbeat_timeout_s: Optional[float] = None,
                 brownout: Union[bool, BrownoutBreaker, None] = True,
                 fair_scheduling: bool = True,
                 sched_window: Optional[int] = None,
                 ops: Optional[Dict[str, object]] = None,
                 **engine_kwargs):
        if engine is not None:
            if engine_kwargs:
                raise ValueError(
                    f"engine_kwargs {sorted(engine_kwargs)} are for the "
                    f"engine the service builds; an explicit engine "
                    f"arrives fully configured")
            if not engine._background:
                raise ValueError(
                    "FFTService needs a background engine (its drainer "
                    "is the serving loop); construct it with "
                    "background=True or a drainer trigger")
            self.engine = engine
            self._own_engine = False
            if faults is not None and self.engine.faults is None:
                self.engine.faults = faults
        else:
            if mesh is None:
                raise ValueError("FFTService(mesh=...) is required when "
                                 "no engine is given")
            engine_kwargs.setdefault('background', True)
            engine_kwargs.setdefault('faults', faults)
            self.engine = FFTEngine(mesh=mesh, **engine_kwargs)
            self._own_engine = True
        # named operator plans (fft.plan_op, fully baked): clients hit
        # them with submit(op=name) and the whole coalesced group runs
        # rfft -> op -> irfft as one dispatch
        for op_name, op_plan in (ops or {}).items():
            self.engine.register_op(op_name, op_plan)
        self._faults = faults
        # admission/policy time reads pass through the fault plane's
        # clock (skew injection); latency measurement stays on the
        # real monotonic clock
        self._clock = (time.monotonic if faults is None
                       else faults.clock('policy.clock'))

        self.slo_classes = dict(slo_classes if slo_classes is not None
                                else default_slo_classes())
        self.max_inflight = int(max_inflight)
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {max_inflight}")
        self._lock = threading.Lock()
        self._drain_cond = threading.Condition(self._lock)
        self._tenants: Dict[str, _Tenant] = {}
        for cfg in tenants:
            if cfg.slo not in self.slo_classes:
                raise ValueError(f"tenant {cfg.name!r} defaults to "
                                 f"unknown SLO class {cfg.slo!r}")
            self._tenants[cfg.name] = _Tenant(cfg)
        self.allow_unknown_tenants = (not tenants
                                      if allow_unknown_tenants is None
                                      else allow_unknown_tenants)
        self._inflight_total = 0
        self._lat_ewma_ms: Optional[float] = None
        self._shape_lat: Dict[str, deque] = {}

        if brownout is True:
            self._breaker: Optional[BrownoutBreaker] = BrownoutBreaker(
                clock=self._clock)
        elif brownout:
            self._breaker = brownout
        else:
            self._breaker = None
        self._dedup = _DedupWindow(dedup_window_s, dedup_max_entries)
        self._sched_lock = threading.Lock()
        if fair_scheduling:
            if sched_window is None:
                sched_window = max(4, 2 * self.engine.max_coalesce)
            self._sched: Optional[_FairScheduler] = _FairScheduler(
                sched_window)
        else:
            self._sched = None
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._reload_generation = 0
        self._hk_stop = threading.Event()
        self._hk_thread: Optional[threading.Thread] = None

        if policy == 'adaptive':
            base_wait = self.engine.max_wait_ms
            policy = AdaptivePolicy(
                max_coalesce=self.engine.max_coalesce,
                max_wait_ms=(50.0 if base_wait in (None, 0)
                             else float(base_wait)),
                overlap_chunks=1,
                clock=None if faults is None else self._clock)
        self.policy: Optional[AdaptivePolicy] = policy
        self.persist_policy = persist_policy and policy is not None
        self._last_decision = None
        if (self.policy is not None and self.engine.shape is not None
                and self.engine._schedule_table is not None):
            # warm start: adopt persisted load-level rows for the
            # engine's default config before the first request lands
            self.policy.seed(
                self.engine._schedule_table, dict(self.engine.mesh.shape),
                self.engine.shape, 'complex',
                self.engine._plan_kwargs.get('comm', 'auto'),
                backend=self.engine.mesh.device.type)
        self._apply_policy(force=True)

        self.address: Optional[Address] = address
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: List[_Conn] = []
        self._conn_lock = threading.Lock()
        self._closed = False
        self._t0 = time.monotonic()

    # -- lifecycle ----------------------------------------------------------

    def start(self, address: Optional[Address] = None) -> 'FFTService':
        """Bind, listen, and serve connections on a daemon accept
        thread. Returns self (so ``with FFTService(...).start() as s``
        works)."""
        if self._listener is not None:
            raise RuntimeError("the service is already serving")
        if self._closed:
            raise RuntimeError("start() after close()")
        if address is not None:
            self.address = address
        if self.address is None:
            raise ValueError("no address: pass a unix socket path or a "
                             "(host, port) tuple")
        if isinstance(self.address, str):
            if os.path.exists(self.address):
                os.unlink(self.address)
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            self._listener.bind(self.address)
        else:
            host, port = self.address
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind((host, int(port)))
            if port == 0:
                self.address = self._listener.getsockname()
        self._listener.listen(64)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name='FFTService-accept', daemon=True)
        self._accept_thread.start()
        self._hk_thread = threading.Thread(
            target=self._housekeeping_loop, name='FFTService-housekeeping',
            daemon=True)
        self._hk_thread.start()
        return self

    def _housekeeping_loop(self) -> None:
        """Expire the dedup window and reap silent connections (when
        ``heartbeat_timeout_s`` is set): a peer whose last frame —
        heartbeats count — is too old gets hard-closed, which wakes
        its blocked reader and releases the connection. Inflight work
        still resolves; keyed results stay re-deliverable from the
        dedup window."""
        while not self._hk_stop.wait(0.1):
            self._dedup.expire()
            if self.heartbeat_timeout_s is None:
                continue
            now = time.monotonic()
            with self._conn_lock:
                conns = list(self._conns)
            for c in conns:
                if (not c.dead and c.tenant is not None
                        and now - c.last_seen > self.heartbeat_timeout_s):
                    c.dead = True
                    kill_socket(c.sock)

    def __enter__(self) -> 'FFTService':
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Graceful shutdown: stop accepting, optionally wait for
        every admitted request to resolve, persist the adaptive
        policy's load-level rows, close the connections and (when the
        service built it) the engine. Idempotent."""
        already = self._closed
        self._closed = True
        self._hk_stop.set()
        if self._listener is not None:
            # shutdown wakes the accept thread's blocked accept(); a
            # close alone leaves it blocked until its join times out
            kill_socket(self._listener)
            if isinstance(self.address, str):
                try:
                    os.unlink(self.address)
                except OSError:
                    pass
        if drain and not already:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            with self._drain_cond:
                while self._inflight_total > 0:
                    left = (None if deadline is None
                            else deadline - time.monotonic())
                    if left is not None and left <= 0:
                        break
                    self._drain_cond.wait(0.1 if left is None
                                          else min(left, 0.1))
        if not already:
            self._persist_policy_rows()
        # half-close every connection: the handler sees EOF, its writer
        # flushes all queued result frames IN ORDER, then the socket
        # closes — a drained shutdown never drops an answered request
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.sock.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with self._conn_lock:
                if not self._conns:
                    break
            time.sleep(0.01)
        with self._conn_lock:
            conns, self._conns = list(self._conns), []
        for c in conns:                        # stragglers: force-close
            c.stop_writer()
            try:
                c.sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        if self._hk_thread is not None:
            self._hk_thread.join(timeout=2.0)
        if self._own_engine and not already:
            self.engine.close()

    def local_client(self, tenant: str = 'default',
                     token: Optional[str] = None) -> 'FFTClient':
        """A connected client for this service's address."""
        if self.address is None:
            raise RuntimeError("the service is not serving yet")
        return FFTClient(self.address, tenant=tenant, token=token)

    # -- hot config reload --------------------------------------------------

    def reload_tenants(self, configs: Sequence[TenantConfig], *,
                       retire_missing: bool = False) -> int:
        """Atomically swap tenant configs without dropping inflight.

        Existing tenants get the new policy (fresh token bucket at
        full burst, new quota/weight/SLO) while their counters and
        inflight requests ride through; unknown names are created.
        With ``retire_missing``, configured tenants absent from
        ``configs`` are RETIRED: new submits are refused (typed auth
        error), inflight requests still resolve and deliver. Validates
        everything before touching anything — a bad batch changes
        nothing. Returns the new reload generation."""
        configs = list(configs)
        for cfg in configs:
            if cfg.slo not in self.slo_classes:
                raise ValueError(f"tenant {cfg.name!r} defaults to "
                                 f"unknown SLO class {cfg.slo!r}")
        with self._lock:
            names = {cfg.name for cfg in configs}
            for cfg in configs:
                t = self._tenants.get(cfg.name)
                if t is None:
                    self._tenants[cfg.name] = _Tenant(cfg)
                else:
                    t.swap_cfg(cfg)
            if retire_missing:
                for name, t in self._tenants.items():
                    if name not in names:
                        t.retired = True
            self._reload_generation += 1
            return self._reload_generation

    # -- admission ----------------------------------------------------------

    def _tenant(self, name: str, token: Optional[str]) -> _Tenant:
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                if not self.allow_unknown_tenants:
                    raise PermissionError(f"unknown tenant {name!r}")
                t = _Tenant(TenantConfig(name))
                self._tenants[name] = t
            if t.retired:
                raise PermissionError(
                    f"tenant {name!r} was retired by a config reload")
            if t.cfg.token is not None and token != t.cfg.token:
                raise PermissionError(f"bad token for tenant {name!r}")
            return t

    def _resolve_slo(self, name: Optional[str],
                     tenant: _Tenant) -> SLOClass:
        if name is None:
            name = tenant.cfg.slo
        slo = self.slo_classes.get(name)
        if slo is None:
            raise ValueError(f"unknown SLO class {name!r} (have "
                             f"{sorted(self.slo_classes)})")
        return slo

    def _retry_hint_ms(self, slo: SLOClass) -> float:
        """How long a refused caller should back off: roughly one
        request's observed end-to-end latency (a slot frees about that
        fast), floored at 1 ms."""
        base = self._lat_ewma_ms
        if base is None:
            base = slo.wait_ms()
        return max(1.0, base)

    def _admit(self, tenant: _Tenant, slo: SLOClass) -> None:
        """Charge admission or raise :class:`RetryAfter`. Every
        *offered* request feeds the policy's rate estimator — the
        adaptive drainer must see the load the service is asked to
        carry, not the post-rejection residue. The brownout breaker
        gets first refusal: shed classes answer before spending rate
        tokens."""
        with self._lock:
            now = self._clock()
            if self.policy is not None:
                self.policy.observe(1, now)
            tenant.submitted += 1
            if self._breaker is not None:
                hint_ms = self._breaker.should_shed(slo.name)
                if hint_ms is not None:
                    tenant.rejected['brownout'] = (
                        tenant.rejected.get('brownout', 0) + 1)
                    raise RetryAfter('brownout', hint_ms, tenant.cfg.name)
            wait_s = tenant.bucket.try_take(now)
            if wait_s > 0:
                tenant.rejected['rate'] = tenant.rejected.get('rate', 0) + 1
                raise RetryAfter('rate', wait_s * 1e3, tenant.cfg.name)
            if tenant.inflight >= tenant.cfg.max_inflight:
                tenant.rejected['tenant_quota'] = (
                    tenant.rejected.get('tenant_quota', 0) + 1)
                raise RetryAfter('tenant_quota', self._retry_hint_ms(slo),
                                 tenant.cfg.name)
            if self._inflight_total >= self.max_inflight:
                tenant.rejected['inflight_window'] = (
                    tenant.rejected.get('inflight_window', 0) + 1)
                raise RetryAfter('inflight_window',
                                 self._retry_hint_ms(slo), tenant.cfg.name)
            tenant.inflight += 1
            self._inflight_total += 1
        self._apply_policy()

    def _release(self, tenant: _Tenant, *, ok: bool, slo: SLOClass,
                 shape_key: str, latency_ms: Optional[float]) -> None:
        with self._lock:
            tenant.inflight -= 1
            self._inflight_total -= 1
            if ok:
                tenant.completed += 1
            else:
                tenant.failed += 1
            if latency_ms is not None:
                tenant.record_latency(slo.name, latency_ms)
                self._shape_lat.setdefault(
                    shape_key, deque(maxlen=4096)).append(latency_ms)
                self._lat_ewma_ms = (
                    latency_ms if self._lat_ewma_ms is None
                    else 0.9 * self._lat_ewma_ms + 0.1 * latency_ms)
                if self.policy is not None:
                    self.policy.note_latency(latency_ms * 1e3)
            self._drain_cond.notify_all()

    def _apply_policy(self, force: bool = False) -> None:
        """Retarget the engine's drainer when the policy's decision
        materially moved (watermark changed, or the wait by > 20%)."""
        if self.policy is None:
            return
        d = self.policy.decide()
        if self._breaker is not None:
            self._breaker.note_load(d.load_level, self.policy.n_levels)
        last = self._last_decision
        if (force or last is None or d.watermark != last.watermark
                or abs(d.max_wait_ms - last.max_wait_ms)
                > 0.2 * max(last.max_wait_ms, 1e-9)):
            self.engine.set_drainer(watermark=d.watermark,
                                    max_wait_ms=d.max_wait_ms)
            self._last_decision = d

    def _persist_policy_rows(self) -> None:
        if (not self.persist_policy or self.policy is None
                or self.engine._schedule_path is None):
            return
        rows = []
        strategy = self.engine._plan_kwargs.get('comm', 'auto')
        for shape, real in self.engine.serving_shapes():
            rows.extend(self.policy.rows(
                dict(self.engine.mesh.shape), shape,
                'real' if real else 'complex', strategy,
                backend=self.engine.mesh.device.type))
        if rows:
            try:
                ccost.persist_schedule_rows(rows,
                                            self.engine._schedule_path)
            except OSError:
                import warnings
                warnings.warn("could not persist adaptive-policy rows",
                              RuntimeWarning)

    # -- the wire loop ------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return                         # listener closed: shut down
            if self._faults is not None:
                pt = self._faults.draw('service.accept')
                if pt is not None:
                    if pt.action == 'drop':
                        kill_socket(sock)      # refuse this connection
                        continue
                    if pt.action in ('delay', 'stall'):
                        time.sleep(pt.delay_s)
            conn = _Conn(sock)
            with self._conn_lock:
                if self._closed:
                    sock.close()
                    return
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name='FFTService-conn', daemon=True).start()

    def _writer_loop(self, conn: _Conn) -> None:
        """The single sender for one connection. Result payload
        conversion (device -> host numpy) happens HERE, not on the
        drainer thread — a slow client costs itself, never the
        pipeline. A FAILED send marks the connection dead and
        hard-closes the socket so the blocked reader wakes and
        releases the connection now, not at the peer's leisure;
        tenant quota and window slots ride each request's
        done-callback (never this socket), so nothing strands."""
        while True:
            item = conn.outq.get()
            if item is None:
                return
            if conn.dead:
                # drain the queue quietly — but a keyed result still
                # comes to the host, so that the dedup window holding it
                # for a resubmit never holds the card's memory
                if item[0] == 'result' and item[2].keyed:
                    item[2].payload()
                continue
            try:
                if item[0] == 'frame':
                    _, msg_type, meta, arrays = item
                    proto.send_frame(conn.sock, msg_type, meta, arrays,
                                     faults=self._faults,
                                     site='service.writer')
                else:                          # ('result', req_id, delivery)
                    _, req_id, delivery = item
                    self._send_result(conn, req_id, delivery)
            except (OSError, proto.ProtocolError, FaultInjected):
                conn.dead = True               # client went away mid-write
                kill_socket(conn.sock)         # wake the blocked reader
                with conn.cond:
                    conn.cond.notify_all()     # unstick DRAIN waiters

    def _send_result(self, conn: _Conn, req_id: int,
                     delivery: _Delivery) -> None:
        form, body = delivery.payload()
        if form == 'error':
            proto.send_frame(conn.sock, proto.ERROR,
                             {'req_id': req_id, 'kind': 'request',
                              'error': body},
                             faults=self._faults, site='service.writer')
            return
        proto.send_frame(conn.sock, proto.RESULT,
                         {'req_id': req_id, 'form': form}, body,
                         faults=self._faults, site='service.writer')

    def _serve_conn(self, conn: _Conn) -> None:
        writer = None
        try:
            try:
                hello = proto.recv_frame(conn.sock, faults=self._faults,
                                         site='service.reader')
            except proto.VersionMismatch as exc:
                proto.send_frame(conn.sock, proto.ERROR,
                                 {'kind': 'version', 'error': str(exc)})
                return
            except proto.ProtocolError as exc:
                try:
                    proto.send_frame(conn.sock, proto.ERROR,
                                     {'kind': 'protocol',
                                      'error': str(exc)})
                except OSError:
                    pass
                return
            if hello is None:
                return
            conn.last_seen = time.monotonic()
            msg_type, meta, _ = hello
            if msg_type != proto.HELLO:
                proto.send_frame(conn.sock, proto.ERROR,
                                 {'kind': 'protocol',
                                  'error': 'expected HELLO first'})
                return
            try:
                tenant = self._tenant(str(meta.get('tenant', 'default')),
                                      meta.get('token'))
            except PermissionError as exc:
                proto.send_frame(conn.sock, proto.ERROR,
                                 {'kind': 'auth', 'error': str(exc)})
                return
            conn.tenant = tenant
            conn.client_id = meta.get('client_id')
            writer = threading.Thread(target=self._writer_loop,
                                      args=(conn,),
                                      name='FFTService-writer', daemon=True)
            writer.start()
            conn.send(proto.HELLO_OK, {
                'tenant': tenant.cfg.name,
                'max_inflight': tenant.cfg.max_inflight,
                'rate_per_s': (None if math.isinf(tenant.cfg.rate_per_s)
                               else tenant.cfg.rate_per_s),
                'slo_classes': {n: {'deadline_ms': c.deadline_ms,
                                    'max_wait_ms': c.wait_ms()}
                                for n, c in self.slo_classes.items()},
                'default_slo': tenant.cfg.slo,
            })
            while True:
                try:
                    frame = proto.recv_frame(conn.sock,
                                             faults=self._faults,
                                             site='service.reader')
                except proto.VersionMismatch as exc:
                    # a v1 HELLO got us here; a mid-stream version
                    # flip is a client bug — answer typed, then close
                    conn.send(proto.ERROR,
                              {'kind': 'version', 'error': str(exc)})
                    return
                except proto.ProtocolError as exc:
                    conn.send(proto.ERROR,
                              {'kind': 'protocol', 'error': str(exc)})
                    return
                if frame is None:
                    return                     # clean client close
                conn.last_seen = time.monotonic()
                msg_type, meta, arrays = frame
                if msg_type == proto.SUBMIT:
                    self._handle_submit(conn, tenant, meta, arrays)
                elif msg_type == proto.HEARTBEAT:
                    conn.send(proto.HEARTBEAT_OK,
                              {'req_id': meta.get('req_id')})
                elif msg_type == proto.RELOAD:
                    self._handle_reload(conn, tenant, meta)
                elif msg_type == proto.METRICS:
                    conn.send(proto.METRICS_OK,
                              {'req_id': meta.get('req_id'),
                               'metrics': self.metrics()})
                elif msg_type == proto.DRAIN:
                    with conn.cond:
                        while conn.inflight > 0:
                            conn.cond.wait(0.1)
                    conn.send(proto.DRAIN_OK,
                              {'req_id': meta.get('req_id')})
                else:
                    conn.send(proto.ERROR,
                              {'kind': 'protocol',
                               'error': f'unexpected message type '
                                        f'{msg_type}'})
        finally:
            if writer is not None:
                conn.stop_writer()
                writer.join(timeout=10.0)
            try:
                conn.sock.close()
            except OSError:
                pass
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _handle_reload(self, conn: _Conn, tenant: _Tenant,
                       meta: dict) -> None:
        req_id = meta.get('req_id')
        if not tenant.cfg.admin:
            conn.send(proto.ERROR,
                      {'req_id': req_id, 'kind': 'auth',
                       'error': f"tenant {tenant.cfg.name!r} is not an "
                                f"admin (RELOAD refused)"})
            return
        try:
            cfgs = [TenantConfig.from_dict(d)
                    for d in meta.get('tenants', ())]
            gen = self.reload_tenants(
                cfgs, retire_missing=bool(meta.get('retire_missing')))
        except (TypeError, ValueError) as exc:
            conn.send(proto.ERROR, {'req_id': req_id, 'kind': 'request',
                                    'error': str(exc)})
            return
        conn.send(proto.RELOAD_OK,
                  {'req_id': req_id, 'generation': gen,
                   'tenants': [c.name for c in cfgs]})

    def _handle_submit(self, conn: _Conn, tenant: _Tenant, meta: dict,
                       arrays: List[np.ndarray]) -> None:
        req_id = meta.get('req_id')
        key = meta.get('key')
        key = None if key is None else str(key)
        try:
            slo = self._resolve_slo(meta.get('slo'), tenant)
        except ValueError as exc:
            conn.send(proto.ERROR, {'req_id': req_id, 'kind': 'request',
                                    'error': str(exc)})
            return
        if tenant.retired:
            conn.send(proto.ERROR,
                      {'req_id': req_id, 'kind': 'auth',
                       'error': f"tenant {tenant.cfg.name!r} was retired "
                                f"by a config reload"})
            return
        if key is not None:
            status, payload = self._dedup.begin(tenant.cfg.name, key,
                                                conn, req_id)
            if status == 'done':
                # completed work: re-deliver from cache, bit-identical,
                # never recomputed — and never re-admitted
                conn.deliver(('result', req_id, payload))
                return
            if status == 'inflight':
                # the work is queued or running: delivery re-attached
                # to THIS connection; transfer the DRAIN tracking
                old_conn, _old_req = payload
                conn.track(+1)
                if old_conn is not None and old_conn is not conn:
                    old_conn.track(-1)
                return
            # 'new': fall through into the normal admission walk
        try:
            self._admit(tenant, slo)
        except RetryAfter as ra:
            if key is not None:
                self._dedup.forget(tenant.cfg.name, key)
            conn.send(proto.RETRY_AFTER,
                      {'req_id': req_id, 'reason': ra.reason,
                       'retry_after_ms': ra.retry_after_ms})
            return
        direction = meta.get('direction', 'fwd')
        real = meta.get('real')
        op = meta.get('op')
        op = None if op is None else str(op)
        form = meta.get('form', 'array')
        shape_key = (f"{'x'.join(map(str, arrays[0].shape))}"
                     f":{f'op:{op}' if op else direction}"
                     if arrays else '?')
        try:
            if form == 'planar':
                if len(arrays) != 2:
                    raise ValueError(
                        f"planar submit needs exactly 2 arrays, "
                        f"got {len(arrays)}")
                x = (arrays[0], arrays[1])
            else:
                if len(arrays) != 1:
                    raise ValueError(
                        f"submit needs exactly 1 array, got {len(arrays)}")
                x = arrays[0]
        except ValueError as exc:
            self._release(tenant, ok=False, slo=slo, shape_key=shape_key,
                          latency_ms=None)
            if key is not None:
                self._dedup.forget(tenant.cfg.name, key)
            conn.send(proto.ERROR, {'req_id': req_id, 'kind': 'request',
                                    'error': f"{type(exc).__name__}: "
                                             f"{exc}"})
            return
        # the class's wait budget, tightened (never extended) by the
        # adaptive policy's current decision
        wait_ms = slo.wait_ms()
        if self._last_decision is not None:
            wait_ms = min(wait_ms, self._last_decision.max_wait_ms)
        p = _Pending(x, direction, real, wait_ms, conn, tenant, slo,
                     shape_key, req_id, key, time.monotonic(), op=op)
        conn.track(+1)
        if self._sched is None:
            self._dispatch_pending(p, scheduled=False)
            return
        with self._sched_lock:
            self._sched.offer(tenant.cfg.name, tenant.cfg.weight, p)
            batch = self._sched.take()
        for _name, item in batch:
            self._dispatch_pending(item)

    def _pump_scheduler(self, *, completed: bool) -> None:
        """One scheduler turn: retire a resolved slot and dispatch
        whatever DRR releases."""
        if self._sched is None:
            return
        with self._sched_lock:
            if completed:
                self._sched.done()
            batch = self._sched.take()
        for _name, item in batch:
            self._dispatch_pending(item)

    def _dispatch_pending(self, p: _Pending, *,
                          scheduled: bool = True) -> None:
        """Hand one admitted request to the engine and wire up
        delivery. ``scheduled`` means this item occupies a fair-
        scheduler slot (retired via :meth:`_pump_scheduler` when it
        resolves)."""
        try:
            if p.op is not None:
                ticket = self.engine.submit(p.x, op=p.op,
                                            max_wait_ms=p.wait_ms)
            else:
                ticket = self.engine.submit(p.x, direction=p.direction,
                                            real=p.real,
                                            max_wait_ms=p.wait_ms)
        except Exception as exc:
            self._release(p.tenant, ok=False, slo=p.slo,
                          shape_key=p.shape_key, latency_ms=None)
            if p.key is not None:
                self._dedup.forget(p.tenant.cfg.name, p.key)
            p.conn.send(proto.ERROR,
                        {'req_id': p.req_id, 'kind': 'request',
                         'error': f"{type(exc).__name__}: {exc}"})
            p.conn.track(-1)
            if scheduled:
                self._pump_scheduler(completed=True)
            return
        with self._lock:
            p.tenant.scheduled += 1

        def on_done(t, p=p, scheduled=scheduled):
            # drainer thread: bookkeeping + handoff only — the numpy
            # conversion and the socket write happen on the writer
            latency_ms = (time.monotonic() - p.t_submit) * 1e3
            self._release(p.tenant, ok=t.done, slo=p.slo,
                          shape_key=p.shape_key,
                          latency_ms=latency_ms if t.done else None)
            if self._breaker is not None:
                if t.done:
                    self._breaker.record_success()
                else:
                    self._breaker.record_failure()
            target_conn, target_req = p.conn, p.req_id
            delivery = _Delivery(t, keyed=p.key is not None)
            if p.key is not None:
                # deliver to the CURRENT attachment — a resubmit may
                # have moved delivery to a fresh connection
                att = self._dedup.settle(p.tenant.cfg.name, p.key,
                                         delivery)
                if att is not None:
                    target_conn, target_req = att
                if not t.done:
                    # only COMPLETED work is cached: a retry under the
                    # same key recomputes instead of replaying a
                    # transient dispatch fault forever
                    self._dedup.forget(p.tenant.cfg.name, p.key)
            if (not target_conn.deliver(('result', target_req, delivery))
                    and delivery.keyed):
                # the connection is gone and its writer with it: the
                # result comes to the host here, so the dedup window
                # keeping it for a resubmit holds no card memory
                delivery.payload()
            target_conn.track(-1)
            if scheduled:
                self._pump_scheduler(completed=True)

        ticket.add_done_callback(on_done)

    # -- metrics ------------------------------------------------------------

    def metrics(self) -> dict:
        """The whole metrics surface as one JSON-serializable dict."""
        with self._lock:
            tenants = {}
            for name, t in self._tenants.items():
                lat = {}
                for slo_name, samples in t.latencies.items():
                    slo = self.slo_classes.get(slo_name)
                    vals = list(samples)
                    lat[slo_name] = {
                        'count': len(vals),
                        'p50_ms': round(_percentile(vals, 50), 3),
                        'p99_ms': round(_percentile(vals, 99), 3),
                        'slo_deadline_ms': (slo.deadline_ms
                                            if slo else None),
                        'violations': (sum(v > slo.deadline_ms
                                           for v in vals)
                                       if slo else None),
                    }
                tenants[name] = {
                    'submitted': t.submitted,
                    'completed': t.completed,
                    'failed': t.failed,
                    'inflight': t.inflight,
                    'scheduled': t.scheduled,
                    'weight': t.cfg.weight,
                    'retired': t.retired,
                    'rejected': dict(t.rejected),
                    'latency_ms': lat,
                }
            shapes = {k: {'count': len(v),
                          'p50_ms': round(_percentile(list(v), 50), 3),
                          'p99_ms': round(_percentile(list(v), 99), 3)}
                      for k, v in self._shape_lat.items() if v}
            inflight = self._inflight_total
            last = self._last_decision
            reload_gen = self._reload_generation
        queues = {self._key_str(k): d
                  for k, d in self.engine.queue_depths().items()}
        if self._sched is not None:
            with self._sched_lock:
                sched = {'window': self._sched.window,
                         'active': self._sched.active,
                         'queued': self._sched.queued()}
            # completed share of engine dispatches per tenant — the
            # fairness observable the chaos harness asserts on
            total_sched = sum(t['scheduled'] for t in tenants.values())
            sched['shares'] = (
                {} if total_sched == 0 else
                {n: round(t['scheduled'] / total_sched, 4)
                 for n, t in tenants.items()})
        else:
            sched = None
        out = {
            'service': {
                'uptime_s': round(time.monotonic() - self._t0, 3),
                'inflight': inflight,
                'max_inflight': self.max_inflight,
                'reload_generation': reload_gen,
                'queue_depths': queues,
                'dispatch': self.engine.dispatch_stats(),
                'policy': None if last is None else {
                    'watermark': last.watermark,
                    'max_wait_ms': round(last.max_wait_ms, 3),
                    'load_level': last.load_level,
                    'rate_per_s': round(last.rate_per_s, 3),
                },
                'scheduler': sched,
                'dedup': self._dedup.info(),
                'breaker': (None if self._breaker is None
                            else self._breaker.info()),
                'faults': (None if self._faults is None
                           else self._faults.stats()),
            },
            'tenants': tenants,
            'shapes': shapes,
        }
        return out

    @staticmethod
    def _key_str(key: tuple) -> str:
        shape, real, direction, dtype, planar = key
        return (f"{'x'.join(map(str, shape))}"
                f"{'/real' if real else ''}:{direction}:{dtype}"
                f"{':planar' if planar else ''}")

    def __repr__(self):
        return (f"FFTService(address={self.address!r}, "
                f"tenants={sorted(self._tenants)}, "
                f"inflight={self._inflight_total}/{self.max_inflight}, "
                f"policy={'on' if self.policy else 'off'})")


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class ClientTicket:
    """Client-side handle for one submitted request: resolves with the
    transform output, or raises the server's typed answer —
    :class:`RetryAfter` on backpressure, ``RuntimeError`` on a request
    error, ``ConnectionError`` when the link died first."""

    __slots__ = ('_event', '_value', '_error', 'done_at')

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        #: monotonic timestamp of the settling frame's arrival (set by
        #: the reader thread) — latency measured at the wire, not at
        #: whenever the caller got around to result()
        self.done_at: Optional[float] = None

    @property
    def done(self) -> bool:
        return self._event.is_set() and self._error is None

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise ResultTimeout(
                f"no server answer within {timeout}s — the request may "
                f"still be queued; call result() again")
        if self._error is not None:
            raise self._error
        return self._value

    def _resolve(self, value) -> None:
        self._value = value
        self.done_at = time.monotonic()
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self.done_at = time.monotonic()
        self._event.set()


class FFTClient:
    """Resilient client for :class:`FFTService`.

    ``submit`` sends one frame and returns a :class:`ClientTicket`; a
    reader thread demultiplexes the (unordered) answers by request id.
    ``transform`` is the synchronous convenience loop: it honors
    ``RETRY_AFTER`` hints with capped exponential backoff (full
    jitter), reconnects and RESUBMITS under per-request idempotency
    keys when the link drops (the server's dedup window guarantees
    exactly-once), and raises :class:`ServiceUnavailable` when the
    attempt or deadline budget runs out. ``heartbeat_s`` arms a
    keepalive thread so a server with ``heartbeat_timeout_s`` never
    reaps a healthy-but-quiet client.
    """

    def __init__(self, address: Address, *, tenant: str = 'default',
                 token: Optional[str] = None,
                 connect_timeout: Optional[float] = 30.0,
                 heartbeat_s: Optional[float] = None,
                 client_id: Optional[str] = None):
        self.tenant = tenant
        self._token = token
        self._address = address
        self._connect_timeout = connect_timeout
        #: stable across reconnects — the idempotency-key namespace
        self.client_id = client_id or uuid.uuid4().hex[:12]
        self.heartbeat_s = heartbeat_s
        self.reconnects = 0
        self._send_lock = threading.Lock()
        self._tickets: Dict[int, ClientTicket] = {}
        self._tickets_lock = threading.Lock()
        self._next_id = 0
        self._seq = 0
        self._closed = False
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[threading.Thread] = None
        self._connect()
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat_s is not None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name='FFTClient-heartbeat',
                daemon=True)
            self._hb_thread.start()

    # -- plumbing -----------------------------------------------------------

    def _connect(self) -> None:
        if isinstance(self._address, str):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self._connect_timeout)
            sock.connect(self._address)
        else:
            sock = socket.create_connection(
                (self._address[0], int(self._address[1])),
                timeout=self._connect_timeout)
        sock.settimeout(None)
        try:
            proto.send_frame(sock, proto.HELLO,
                             {'tenant': self.tenant, 'token': self._token,
                              'client_id': self.client_id})
            first = proto.recv_frame(sock)
        except (OSError, proto.ProtocolError):
            kill_socket(sock)
            raise
        if first is None:
            kill_socket(sock)
            raise ConnectionError("server closed during handshake")
        msg_type, meta, _ = first
        if msg_type == proto.ERROR:
            kill_socket(sock)
            raise PermissionError(
                f"server refused the connection "
                f"({meta.get('kind')}): {meta.get('error')}")
        if msg_type != proto.HELLO_OK:
            kill_socket(sock)
            raise proto.ProtocolError(
                f"expected HELLO_OK, got message type {msg_type}")
        self.server_info = meta
        self._sock = sock
        self._reader = threading.Thread(target=self._reader_loop,
                                        args=(sock,),
                                        name='FFTClient-reader',
                                        daemon=True)
        self._reader.start()

    def _reconnect(self) -> None:
        """Tear down the current link and handshake a fresh one.
        Tickets pending on the old link fail with ``ConnectionError``
        — ``transform`` resubmits them under their idempotency keys,
        so completed work is re-delivered, never redone."""
        with self._send_lock:
            old = self._sock
            self._sock = None
            if old is not None:
                kill_socket(old)
            with self._tickets_lock:
                pending, self._tickets = self._tickets, {}
            for t in pending.values():
                t._fail(ConnectionError("reconnecting"))
            self._connect()
            self.reconnects += 1

    def _register(self) -> Tuple[int, ClientTicket]:
        with self._tickets_lock:
            self._next_id += 1
            t = ClientTicket()
            self._tickets[self._next_id] = t
            return self._next_id, t

    def _take(self, req_id) -> Optional[ClientTicket]:
        with self._tickets_lock:
            return self._tickets.pop(req_id, None)

    def _next_key(self) -> str:
        with self._tickets_lock:
            self._seq += 1
            return f"{self.client_id}/{self._seq}"

    def _reader_loop(self, sock) -> None:
        err: BaseException = ConnectionError("connection closed")
        try:
            while True:
                frame = proto.recv_frame(sock)
                if frame is None:
                    break
                msg_type, meta, arrays = frame
                req_id = meta.get('req_id')
                t = self._take(req_id)
                if msg_type == proto.RESULT:
                    if t is not None:
                        if meta.get('form') == 'planar':
                            t._resolve((arrays[0], arrays[1]))
                        else:
                            t._resolve(arrays[0])
                elif msg_type == proto.RETRY_AFTER:
                    if t is not None:
                        t._fail(RetryAfter(meta.get('reason', '?'),
                                           float(meta.get('retry_after_ms',
                                                          1.0)),
                                           self.tenant))
                elif msg_type == proto.ERROR:
                    exc = RuntimeError(
                        f"server error ({meta.get('kind')}): "
                        f"{meta.get('error')}")
                    if t is not None:
                        t._fail(exc)
                    elif req_id is None:
                        err = exc              # connection-level: fail all
                        break
                elif msg_type == proto.RELOAD_OK:
                    if t is not None:
                        t._resolve(meta)
                elif msg_type in (proto.METRICS_OK, proto.DRAIN_OK,
                                  proto.HEARTBEAT_OK):
                    if t is not None:
                        t._resolve(meta.get('metrics', True))
        except proto.ProtocolError as exc:
            err = exc
        except OSError as exc:
            err = ConnectionError(f"connection lost: {exc}")
        if self._sock is not sock:
            return                             # superseded by a reconnect
        with self._tickets_lock:
            pending, self._tickets = self._tickets, {}
        for t in pending.values():
            t._fail(err)

    def _send(self, msg_type: int, meta: dict, arrays: Sequence = ()):
        if self._closed:
            raise RuntimeError("client is closed")
        with self._send_lock:
            if self._sock is None:
                raise ConnectionError("not connected")
            proto.send_frame(self._sock, msg_type, meta, arrays)

    def _heartbeat_loop(self) -> None:
        while not self._closed:
            time.sleep(self.heartbeat_s)
            if self._closed:
                return
            try:
                self._send(proto.HEARTBEAT, {})
            except Exception:
                pass          # transform's retry loop owns recovery

    # -- API ----------------------------------------------------------------

    def submit(self, x, *, direction: str = 'fwd',
               real: Optional[bool] = None,
               op: Optional[str] = None,
               slo: Optional[str] = None,
               key: Optional[str] = None) -> ClientTicket:
        """Send one transform request; the ticket resolves when the
        server answers (results arrive in the server's order, not
        submission order). ``op=`` names a server-registered operator
        plan (``FFTService(ops={...})``) — the request runs the fused
        rfft -> op -> irfft round trip and returns an array of the
        input's form. ``key`` is an idempotency key: resubmits
        under the same key are served exactly once (the server's
        dedup window re-delivers or re-attaches, never recomputes)."""
        if isinstance(x, (tuple, list)):
            arrays = [np.ascontiguousarray(a) for a in x]
            form = 'planar'
        else:
            arrays = [np.ascontiguousarray(x)]
            form = 'array'
        req_id, t = self._register()
        meta = {'req_id': req_id, 'direction': direction, 'form': form}
        if op is not None:
            meta['op'] = str(op)
        if real is not None:
            meta['real'] = bool(real)
        if slo is not None:
            meta['slo'] = slo
        if key is not None:
            meta['key'] = key
        try:
            self._send(proto.SUBMIT, meta, arrays)
        except BaseException:
            self._take(req_id)
            raise
        return t

    def transform(self, xs: Sequence, *, direction: str = 'fwd',
                  real: Optional[bool] = None, slo: Optional[str] = None,
                  timeout: Optional[float] = 120.0,
                  max_attempts: int = 8,
                  backoff_base_s: float = 0.05,
                  backoff_max_s: float = 2.0,
                  deadline_s: Optional[float] = None,
                  idempotent: bool = True) -> List:
        """Submit every operand and return the results in order — the
        well-behaved-client loop:

        * ``RETRY_AFTER`` hints are honored with capped exponential
          backoff and full jitter, never sleeping shorter than the
          server's hint;
        * a dropped connection reconnects and resubmits under the SAME
          idempotency key (``idempotent=True``, the default), so the
          server re-delivers completed work from its dedup window
          instead of recomputing it;
        * ``deadline_s`` bounds the TOTAL time spent per operand,
          attempts and sleeps included. Exhausting it — or
          ``max_attempts`` — raises :class:`ServiceUnavailable`
          carrying the last underlying error.
        """
        out = []
        rng = random.Random()
        for x in xs:
            key = self._next_key() if idempotent else None
            t0 = time.monotonic()
            last: Optional[BaseException] = None
            served = False
            for attempt in range(max_attempts):
                left = (None if deadline_s is None
                        else deadline_s - (time.monotonic() - t0))
                if left is not None and left <= 0:
                    break
                try:
                    t = self.submit(x, direction=direction, real=real,
                                    slo=slo, key=key)
                    wait = (timeout if left is None else
                            left if timeout is None else min(timeout, left))
                    out.append(t.result(wait))
                    served = True
                    break
                except RetryAfter as ra:
                    last = ra
                    delay = max(ra.retry_after_ms / 1e3,
                                min(backoff_max_s,
                                    backoff_base_s * (2 ** attempt))
                                * rng.random())
                except (ConnectionError, OSError,
                        proto.ProtocolError) as exc:
                    # a torn frame poisons the link exactly like a
                    # reset does: reconnect and resubmit under the key
                    last = exc
                    delay = (min(backoff_max_s,
                                 backoff_base_s * (2 ** attempt))
                             * rng.random())
                    try:
                        self._reconnect()
                    except PermissionError:
                        raise                  # auth refusals never heal
                    except (OSError, proto.ProtocolError) as rexc:
                        last = rexc
                if left is not None:
                    delay = min(delay, max(0.0, left))
                time.sleep(delay)
            if not served:
                budget = (f"{deadline_s:.1f} s deadline"
                          if deadline_s is not None
                          else f"{max_attempts} attempts")
                raise ServiceUnavailable(
                    f"no served result within {budget} "
                    f"(last error: {last})", last)
        return out

    def reload(self, tenants: Sequence, *, retire_missing: bool = False,
               timeout: Optional[float] = 30.0) -> dict:
        """Drive a hot tenant-config reload (this client's tenant must
        be ``admin=True``). ``tenants`` holds :class:`TenantConfig`
        instances or their dict form; returns the server's RELOAD_OK
        meta (``{'generation': n, 'tenants': [...]}``)."""
        specs = [t.to_dict() if isinstance(t, TenantConfig) else dict(t)
                 for t in tenants]
        req_id, t = self._register()
        self._send(proto.RELOAD, {'req_id': req_id, 'tenants': specs,
                                  'retire_missing': retire_missing})
        return t.result(timeout)

    def metrics(self, timeout: Optional[float] = 30.0) -> dict:
        """The server's metrics JSON document."""
        req_id, t = self._register()
        self._send(proto.METRICS, {'req_id': req_id})
        return t.result(timeout)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until the server resolved every request THIS client
        has submitted so far (their result frames are queued/sent)."""
        req_id, t = self._register()
        self._send(proto.DRAIN, {'req_id': req_id})
        t.result(timeout)

    def close(self) -> None:
        """Close the connection; outstanding tickets fail with
        ``ConnectionError``."""
        if self._closed:
            return
        self._closed = True
        if self._sock is not None:
            kill_socket(self._sock)
        if self._reader is not None:
            self._reader.join(timeout=10.0)

    def __enter__(self) -> 'FFTClient':
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
