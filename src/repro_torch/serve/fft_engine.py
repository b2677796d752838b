"""Continuous FFT serving: multi-shape plan cache + background drainer.

Port of ``repro.serve.fft_engine``. A stream of independent transform
requests executed one call at a time pays each call's fixed costs once
a request; :class:`FFTEngine` closes that gap in three layers:

* **coalescing** — queued requests of the same kind (shape, complex/
  real, forward/inverse, dtype, front-end form) are stacked along a
  new leading batch axis and executed as ONE batched plan call; the
  coalesce width comes from the port's persisted autotune table
  (``BENCH_torch_serve_schedule.json``, written by :meth:`autotune`)
  when this host has measured the config, else from the cost model's
  throughput objective (:meth:`repro_torch.comm.cost.PlanCost.pipeline_us`).
* **in-call pipelining** — the batched call runs with
  ``overlap_chunks`` over the request axis, so on a mesh request i+1's
  pencil FFTs are queued while request i's swap is in flight
  (:mod:`repro_torch.comm.overlap`).
* **cross-call double buffering** — groups are dispatched through a
  :class:`repro_torch.comm.overlap.StreamPipeline`, which keeps the next
  group queued on the card while the previous one runs. A group is one
  call: stack the requests (a copy; a group of one is a view), run the
  batched ``plan.forward``, ``inverse`` or ``apply``, and hand out the
  results as views of the batched output (``unbind``: no copy; a result
  kept alive keeps its whole group's output alive).

**Multi-shape serving.** One engine serves a heterogeneous request
stream: plans are cached per (shape, kind) in an LRU
(:mod:`repro_torch.serve.plan_cache`) bounded by ``max_plans`` entries
and a ``plan_cache_bytes`` byte budget over the staged operands of the
group shapes each plan has run, sized via
:meth:`repro_torch.fft.FFT.operand_nbytes`. Each (shape, kind,
direction, dtype, form) has its own request queue; every queue feeds
the same bounded-inflight stream pipeline.

**Continuous operation.** With ``max_wait_ms`` and/or ``watermark``
set (or ``background=True``), a daemon drainer thread dispatches
queued requests when EITHER trigger trips — a kind's queue reaches its
coalesce-width watermark, or the oldest queued request has waited
``max_wait_ms`` — so ``submit(...).result()`` works with no explicit
``flush()``. ``close()`` (or the context manager) drains cleanly and
makes further ``submit()`` calls raise. A group that fails inside the
drainer is re-queued (never silently dropped, never rerun on another
tier) and retried up to ``retries`` times; a persistent failure
surfaces on ``result()``.

Results are bit-identical to per-request ``plan.forward``/``inverse``/
``apply`` — coalescing changes the batch, never the values: the CUDA
kernels compute each pencil on its own, and the plain versions run
their products on fixed-size blocks of pencils.

Differences from the reference, kept on purpose:

* ``donate`` is accepted and passed to the plans, whose
  ``donates_input`` is always False: no operand is consumed, so a
  failed group's requests stay runnable with no snapshot.
* On a mesh of more than one rank every rank runs its own engine on its
  own blocks (``FFT.in_layout``; an inverse takes the forward's output
  block), and the groups of all ranks must pair up in the same order.
  ``flush()`` and ``transform()`` do when every rank submits the same
  stream; a drainer's timing would not, so there the engine refuses
  one. A rank's block does not name its transform, so a shape is
  served there once it is planned (the default shape, ``plan_for``,
  ``register_op``).

    with FFTEngine(mesh=mesh, max_wait_ms=2.0) as eng:
        tickets = [eng.submit(x) for x in requests]   # mixed shapes/kinds
        ys = [t.result() for t in tickets]            # no flush() needed
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import cost as ccost
from repro_torch.comm import overlap as ov
from repro_torch.fft import api as fft_api
from repro_torch.serve.plan_cache import LRUPlanCache
from repro_torch.weights import from_numpy

#: the operand types the port's plans take
_DTYPES = (torch.complex64, torch.float32)


def _stack(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The requests of a group along a new leading axis: a copy, except
    that a group of one is a view of its request."""
    return ts[0].unsqueeze(0) if len(ts) == 1 else torch.stack(list(ts))


class ResultTimeout(TimeoutError):
    """``FFTTicket.result(timeout=...)`` expired before the engine
    served the request. This is NOT a failure path: the request is
    still queued (or in flight) and the ticket is untouched and
    reusable — call ``result()`` again, with a longer timeout or none,
    once the engine gets to it."""


class FFTTicket:
    """Handle for one submitted transform. ``result()`` blocks until
    the background drainer resolves the request (when the engine runs
    one), or triggers a ``flush()`` on a foreground engine."""

    __slots__ = ('_engine', '_value', '_error', '_event', '_done',
                 '_callbacks', '_cb_lock')

    def __init__(self, engine: 'FFTEngine'):
        self._engine = engine
        self._value = None
        self._error = None
        self._done = False
        self._event = threading.Event()
        self._callbacks: List = []
        self._cb_lock = threading.Lock()

    @property
    def done(self) -> bool:
        """True once the request executed successfully."""
        return self._done

    @property
    def failed(self) -> bool:
        """True once the request failed permanently (its error raises
        on :meth:`result`)."""
        return self._error is not None

    def result(self, timeout: Optional[float] = None):
        """The transform output: finished on the card when it returns.
        On a background engine this waits (up to ``timeout`` seconds)
        for the drainer; on a foreground engine it flushes. A request
        whose group failed raises the failure here — never a silent
        None. A wait that expires raises :class:`ResultTimeout` (a
        ``TimeoutError`` subclass) and leaves the ticket reusable."""
        if not self._done and self._error is None:
            if self._engine._background:
                if not self._event.wait(timeout):
                    raise ResultTimeout(
                        f"request not served within {timeout}s — the "
                        f"request is still queued and this ticket stays "
                        f"valid; call result() again (engine "
                        f"{self._engine!r})")
            else:
                self._engine.flush()
        if self._error is not None:
            raise self._error
        if not self._done:
            raise RuntimeError(
                "request was never executed — an earlier flush() must "
                "have failed; it was re-queued, so flushing again retries it")
        return self._value

    def add_done_callback(self, fn) -> None:
        """Run ``fn(ticket)`` as soon as the ticket settles (resolves
        OR fails) — immediately if it already has. Callbacks run on the
        settling thread (the drainer, usually): keep them short. Their
        exceptions are swallowed into a warning so a flaky observer
        cannot kill the drainer."""
        with self._cb_lock:
            if not (self._done or self._error is not None):
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn) -> None:
        try:
            fn(self)
        except Exception as exc:
            warnings.warn(f"FFTTicket done-callback failed: {exc!r}",
                          RuntimeWarning, stacklevel=2)

    def _settle(self) -> None:
        self._event.set()
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_callback(fn)

    def _resolve(self, value) -> None:
        self._value = value
        self._done = True
        self._settle()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._settle()


class _PlanState:
    """One cached (shape, kind): the plan, its serving schedule, and the
    group shapes it has run (the byte budget's unit)."""

    __slots__ = ('plan', 'width', 'chunks', 'group_cache')

    def __init__(self, plan: fft_api.FFT, width: int, chunks: int):
        self.plan = plan
        self.width = width
        self.chunks = chunks
        self.group_cache: Dict[tuple, int] = {}


class _Request:
    """One queued transform request. The port never consumes an operand
    (``donates_input`` is False), so a re-queued request runs on the
    tensor it was submitted with."""

    __slots__ = ('ticket', 'key', 'x', 'seq', 'deadline', 'attempts', 'width')

    def __init__(self, ticket, key, x, seq, deadline, width):
        self.ticket = ticket
        self.key = key          # (shape, real, direction, dtype, planar)
        self.x = x
        self.seq = seq
        self.deadline = deadline
        self.attempts = 0
        self.width = width      # coalesce width of this kind at submit


#: sentinel for "leave this knob unchanged" (None is a real value —
#: it disables the trigger).
_UNSET = object()

#: upper bound on one idle drainer wait — the weakref loop re-checks
#: engine liveness at least this often, so a leaked (never-closed)
#: engine is reclaimed within a tick of becoming unreferenced.
_DRAINER_IDLE_TICK = 0.5


def _drainer_main(engine_ref: 'weakref.ref') -> None:
    """Drainer thread body: dispatch passes while the engine is alive,
    holding a strong reference only *inside* each pass — the idle wait
    holds nothing but the condition object, so an engine dropped without
    ``close()`` is collectible mid-wait. Pending tickets keep the engine
    alive (they reference it), so requests in flight are never
    abandoned; once nothing references the engine the next tick
    observes a dead weakref and the thread exits."""
    pipe = None
    cond = None
    while True:
        eng = engine_ref()
        if eng is None:
            return
        if pipe is None:
            pipe = ov.StreamPipeline(eng.depth)
            cond = eng._cond
        try:
            with eng._on_device():
                final = eng._drain_pass(pipe)
        except BaseException as exc:          # never die silently
            eng._drainer_crashed(exc)
            return
        finally:
            del eng
        if final:
            return
        # idle wait WITHOUT a strong engine reference: re-check the
        # predicate under the lock (a submit's notify between the pass
        # and this wait must not be missed), then sleep at most a tick
        try:
            with cond:
                eng = engine_ref()
                if eng is None:
                    return
                ripe, timeout = eng._ripe_locked(time.monotonic())
                busy = bool(ripe) or len(pipe) or eng._closed
                del eng
                if not busy:
                    cond.wait(_DRAINER_IDLE_TICK if timeout is None
                              else min(max(timeout, 0.001), _DRAINER_IDLE_TICK))
        except BaseException as exc:
            eng = engine_ref()
            if eng is not None:
                eng._drainer_crashed(exc)
            return


class FFTEngine:
    """Continuous, multi-shape FFT serving engine.

    Args:
      plan_like: an optional default transform — a global ``shape``
        tuple, or an existing :class:`repro_torch.fft.FFT` plan whose
        resolved settings (method, strategy, layout, ...) seed its
        (shape, kind) cache entry. May be None: on one rank the engine
        plans lazily per submitted shape.
      mesh: the port's mesh (``make_fft_mesh``; required unless
        ``plan_like`` is a plan). Operands go to its device.
      max_coalesce: upper bound on requests coalesced into one batched
        call; the actual width is table-/cost-picked per kind.
      overlap_chunks: force the in-call pipelining depth over the
        request axis (default: table-/cost-picked, at most the width).
      latency_budget_us: optional cap on the *model-predicted* whole-
        batch latency (:meth:`PlanCost.pipeline_latency_us`) — trims
        the coalesce width so no request waits for an oversized batch.
      donate: passed to the plans; the port never consumes an operand.
      depth: dispatched-but-unforced groups kept in flight
        (:class:`repro_torch.comm.overlap.StreamPipeline`; 2 = the
        classic double buffer).
      max_wait_ms: background drainer deadline — a queued request is
        dispatched at most this many milliseconds after ``submit``,
        even when its kind's queue never fills a batch. Setting it
        enables the drainer (one rank only).
      watermark: background drainer width trigger — a kind's queue is
        dispatched as soon as it holds this many requests (default:
        the kind's coalesce width). Setting it enables the drainer.
      background: force the drainer on/off regardless of the two
        triggers.
      retries: how many times the drainer re-queues a request whose
        group failed before failing its ticket. Foreground ``flush()``
        re-queues unconditionally (the caller decides when to stop).
      max_plans: LRU cap on cached (shape, kind) plans.
      plan_cache_bytes: byte budget over the cached plans' group
        operands (:meth:`repro_torch.fft.FFT.operand_nbytes`);
        least-recently-served shapes are evicted first.
      on_plan_evict: callback ``(key, plan)`` fired when the LRU evicts
        a plan (after its per-rank functions are dropped).
      schedule_table: ``'auto'`` (default) seeds each kind's (width,
        chunks) pick from the port's persisted autotune table
        (``BENCH_torch_serve_schedule.json``, override with the
        ``REPRO_TORCH_SERVE_SCHEDULES`` env var, '' disables); a path
        string uses that file; None disables persisted seeding.
      faults: optional :class:`repro_torch.serve.faults.FaultPlan` — the
        deterministic fault-injection seam. Site ``engine.dispatch``
        fires inside each coalesced group's dispatch (a ``raise`` fire
        exercises the blame/retry path exactly like a real failure);
        site ``engine.drainer`` fires at the top of every drainer pass.
      **plan_kwargs: forwarded to ``fft.plan`` for every plan the
        engine builds (method, comm, kernel, compute_dtype, wire_dtype,
        padded_spectrum, ...). ``batch_spec`` is not allowed — the
        engine owns the batch axis.
    """

    def __init__(self, plan_like=None, mesh=None, *, max_coalesce: int = 16,
                 overlap_chunks: Optional[int] = None,
                 latency_budget_us: Optional[float] = None,
                 donate: Optional[bool] = None, depth: int = 2,
                 max_wait_ms: Optional[float] = None,
                 watermark: Optional[int] = None,
                 background: Optional[bool] = None,
                 retries: int = 1,
                 max_plans: Optional[int] = 8,
                 plan_cache_bytes: Optional[int] = None,
                 on_plan_evict=None,
                 schedule_table: Optional[str] = 'auto',
                 faults=None,
                 **plan_kwargs):
        if 'batch_spec' in plan_kwargs:
            raise ValueError("the engine owns the leading batch axis; "
                             "batch_spec plans cannot be served")
        if max_coalesce < 1:
            raise ValueError(f"max_coalesce must be >= 1, got {max_coalesce}")
        if watermark is not None and watermark < 1:
            raise ValueError(f"watermark must be >= 1, got {watermark}")
        if max_wait_ms is not None and max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.max_coalesce = int(max_coalesce)
        self.forced_chunks = overlap_chunks
        self.latency_budget_us = latency_budget_us
        self.depth = depth
        self.max_wait_ms = max_wait_ms
        self.watermark = watermark
        self.retries = int(retries)
        self.on_plan_evict = on_plan_evict
        self.faults = faults
        self._plan_kwargs = dict(plan_kwargs)
        self._schedule_path = (None if schedule_table is None else
                               ccost.schedule_table_path(
                                   None if schedule_table == 'auto'
                                   else schedule_table))
        self._schedule_table = (ccost.schedule_table(self._schedule_path)
                                if self._schedule_path else None)

        self._seed: Optional[fft_api.FFT] = None
        if isinstance(plan_like, fft_api.FFT):
            seed = plan_like
            if seed.batch_spec is not None:
                raise ValueError("the engine owns the leading batch axis; "
                                 "batch_spec plans cannot be served")
            self.shape: Optional[Tuple[int, ...]] = seed.shape
            self.mesh = seed.mesh
            self.donate = seed.donate if donate is None else donate
            self._seed = seed
        else:
            if mesh is None:
                raise ValueError("FFTEngine(shape, mesh): mesh is required "
                                 "when plan_like is not a plan")
            self.shape = (None if plan_like is None
                          else tuple(int(s) for s in plan_like))
            self.mesh = mesh
            self.donate = True if donate is None else donate
        if self.mesh.device is None:
            raise ValueError(f"{self.mesh} prices plans and cannot serve them; "
                             "use make_fft_mesh")
        enable = (background if background is not None
                  else (max_wait_ms is not None or watermark is not None))
        if enable and self.mesh.size > 1:
            raise ValueError(
                f"the background drainer cannot run on a mesh of {self.mesh.size} "
                "ranks yet: every rank runs its own engine, and the drainer's "
                "timing would pair different groups in the ranks' collectives. "
                "Serve with flush() or transform(); ROADMAP queue 1 'the "
                "multi-rank drainer' (rank 0 decides each pass and broadcasts it "
                "on a CPU side group) brings it")

        # -- plan cache (LRU over the served plans) -----------------------
        self._plan_lock = threading.RLock()
        self._states = LRUPlanCache(max_entries=max_plans,
                                    max_bytes=plan_cache_bytes,
                                    on_evict=self._evict_state)
        # registered operator plans, by name — pinned, never LRU-evicted
        # (they hold user closures and baked spectra a rebuild could
        # not recover)
        self._ops: Dict[str, _PlanState] = {}
        self.plan_builds: Dict[tuple, int] = {}
        if self._seed is not None:
            self._state(self._seed.shape, self._seed.real)

        # -- request queues + drainer -----------------------------------
        self._cond = threading.Condition()
        self._stats_lock = threading.Lock()
        self.dispatched_groups = 0
        self.width_hist: Dict[int, int] = {}
        self._queues: Dict[tuple, 'list[_Request]'] = {}
        self._seq = 0
        self._closed = False
        self._dispatch_lock = threading.Lock()
        self._inflight: List[_Request] = []
        self._blamed = False            # culprit attribution, per pass
        self._drainer: Optional[threading.Thread] = None
        self._drainer_error: Optional[BaseException] = None
        if enable:
            # the thread holds the engine only via a weakref, re-taken
            # per bounded pass: an engine dropped without close() is
            # collectible, and the orphaned thread then exits
            self._drainer = threading.Thread(
                target=_drainer_main, args=(weakref.ref(self),),
                name='FFTEngine-drainer', daemon=True)
            self._drainer.start()

    # -- lifecycle ----------------------------------------------------------

    @property
    def _background(self) -> bool:
        return self._drainer is not None

    @property
    def closed(self) -> bool:
        return self._closed

    def _on_device(self):
        """The mesh's card as the current device (the drainer thread's
        launches go there); a no-op on the CPU."""
        if self.mesh.device.type == 'cuda':
            return torch.cuda.device(self.mesh.device)
        return contextlib.nullcontext()

    def close(self) -> None:
        """Drain everything queued and stop serving: the background
        drainer runs one final pass and exits; further ``submit()``
        calls raise. Idempotent."""
        with self._cond:
            already = self._closed
            self._closed = True
            self._cond.notify_all()
        if self._drainer is not None:
            if not already or self._drainer.is_alive():
                self._drainer.join()
        elif not already:
            self.flush()

    def __enter__(self) -> 'FFTEngine':
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- plans + schedules --------------------------------------------------

    def _evict_state(self, key, state: _PlanState) -> None:
        state.group_cache.clear()
        state.plan.clear_cache()
        if self.on_plan_evict is not None:
            self.on_plan_evict(key, state.plan)

    def _state(self, shape: Tuple[int, ...], real: bool) -> _PlanState:
        """The cached plan state for (shape, kind), building (and
        possibly evicting) under the plan lock."""
        key = (tuple(shape), bool(real))
        with self._plan_lock:
            st = self._states.get(key)
            if st is not None:
                return st
            st = self._build_state(key[0], key[1])
            self.plan_builds[key] = self.plan_builds.get(key, 0) + 1
            self._states.put(key, st)
            return st

    def _build_state(self, shape: Tuple[int, ...], real: bool) -> _PlanState:
        if self._seed is not None and shape == self._seed.shape:
            base = self._seed
            if base.real != real:
                padded = (self._plan_kwargs.get('padded_spectrum', base.padded_spectrum)
                          if real and len(shape) > 1 else False)
                base = base.with_options(real=real, padded_spectrum=padded)
        else:
            sibling = self._states.get((shape, not real))
            if sibling is not None:
                # adopt the sibling's resolved settings (method,
                # strategy, layout); padded_spectrum is real-only
                padded = (self._plan_kwargs.get('padded_spectrum',
                                                sibling.plan.padded_spectrum)
                          if real and len(shape) > 1 else False)
                base = sibling.plan.with_options(real=real, padded_spectrum=padded)
            else:
                kw = dict(self._plan_kwargs)
                if not real or len(shape) == 1:
                    kw.pop('padded_spectrum', None)
                base = fft_api.plan(shape, self.mesh, real=real, donate=self.donate, **kw)
        w, c = self._pick_schedule(base)
        if c != base.overlap_chunks or self.donate != base.donate:
            base = base.with_options(overlap_chunks=c, donate=self.donate)
        return _PlanState(base, w, c)

    def _table_tags(self, p: fft_api.FFT) -> dict:
        """The schedule-table tags of plan ``p`` on this engine: backend
        (the device type), wire format and kernel tier."""
        return dict(backend=self.mesh.device.type,
                    wire=None if p.wire_dtype == 'native' else p.wire_dtype,
                    kernel=None if p.resolved_kernel == 'reference' else p.resolved_kernel)

    def _pick_schedule(self, p: fft_api.FFT, op: Optional[str] = None) -> Tuple[int, int]:
        """(coalesce width, overlap chunks) for one plan: a persisted
        autotune measurement for this (mesh, shape, kind, strategy)
        wins when it fits the engine's knobs; otherwise minimize the
        cost model's steady-state us/request subject to the latency
        budget (ties to the smaller batch). Operator plans carry their
        registered ``op`` name into the table key, so a fused group's
        measured schedule never answers for the bare plan's."""
        pc = None
        row = (self._schedule_table.lookup(
                   dict(self.mesh.shape), p.shape, 'real' if p.real else 'complex',
                   p.comm, op=op, **self._table_tags(p))
               if self._schedule_table is not None else None)
        if row is not None:
            w, c = row['coalesce_width'], row['overlap_chunks']
            ok = (1 <= w <= self.max_coalesce and 1 <= c <= w and w % c == 0
                  and (self.forced_chunks is None or c == min(self.forced_chunks, w)))
            if ok and self.latency_budget_us is not None:
                pc = p.plan_cost()
                ok = pc.pipeline_latency_us(w, c) <= self.latency_budget_us
            if ok:
                return int(w), int(c)
        pc = pc if pc is not None else p.plan_cost()
        widths = [1]
        while widths[-1] * 2 <= self.max_coalesce:
            widths.append(widths[-1] * 2)
        best, best_us = (1, 1), pc.pipeline_us(1)
        for w in widths:
            if self.forced_chunks is not None:
                chunk_opts = [max(1, min(self.forced_chunks, w))]
            else:
                chunk_opts = [c for c in (1, 2, 4, 8, 16) if c <= w and w % c == 0]
            for c in chunk_opts:
                if (self.latency_budget_us is not None
                        and pc.pipeline_latency_us(w, c) > self.latency_budget_us):
                    continue
                us = pc.pipeline_us(w, c)
                if us < best_us - 1e-9:
                    best, best_us = (w, c), us
        return best

    def _default_shape(self, shape) -> Tuple[int, ...]:
        if shape is not None:
            return tuple(int(s) for s in shape)
        if self.shape is None:
            raise ValueError("this engine has no default shape; pass "
                             "shape= (or submit operands, which carry "
                             "their shape)")
        return self.shape

    def plan_for(self, real: bool = False, shape=None,
                 op: Optional[str] = None) -> fft_api.FFT:
        """The engine's plan for this (shape, kind), shared by every
        batch width the engine runs. With ``op=`` the registered
        operator plan of that name."""
        if op is not None:
            return self._op_state(op).plan
        return self._state(self._default_shape(shape), real).plan

    def register_op(self, name: str, op_plan=None, *, shape=None,
                    **plan_op_kwargs) -> 'fft_api.SpectralOp':
        """Register a fused spectral-operator plan under ``name`` so
        requests can run through it (``submit(x, op=name)``): a
        coalesced group runs forward -> op -> inverse as ONE
        ``SpectralOp.apply``, the interior spectra never leaving their
        native distributed layout. Pass a built
        :func:`repro_torch.fft.plan_op` plan, or its kwargs (``shape``
        defaults to the engine's).

        Only fully-baked operator plans are servable (``n_spectra ==
        0``): serving coalesces SINGLE-operand requests. Registered plans
        are pinned — never LRU-evicted — because they hold user closures
        and baked spectra a shape-driven rebuild could not recover."""
        if not name or not isinstance(name, str):
            raise ValueError(f"op name must be a non-empty string, got {name!r}")
        if op_plan is None:
            op_plan = fft_api.plan_op(self._default_shape(shape), self.mesh,
                                      **plan_op_kwargs)
        elif plan_op_kwargs or shape is not None:
            raise ValueError("pass EITHER a built operator plan OR "
                             "plan_op kwargs, not both")
        if not isinstance(op_plan, fft_api.SpectralOp):
            raise TypeError(f"register_op needs a fft.plan_op plan, "
                            f"got {type(op_plan).__name__}")
        if op_plan.n_spectra:
            raise ValueError(
                f"operator plan {name!r} takes {op_plan.n_spectra} "
                f"runtime spectra; only fully-baked operator plans "
                f"(n_spectra=0, spectra=[...]) are servable")
        w, c = self._pick_schedule(op_plan, op=name)
        opts = {}
        if c != op_plan.overlap_chunks:
            opts['overlap_chunks'] = c
        if self.donate != op_plan.donate:
            opts['donate'] = self.donate
        if opts:
            op_plan = op_plan.with_options(**opts)
        with self._plan_lock:
            self._ops[name] = _PlanState(op_plan, w, c)
        return op_plan

    def _op_state(self, name: str) -> _PlanState:
        with self._plan_lock:
            st = self._ops.get(name)
        if st is None:
            raise KeyError(f"no operator plan registered as {name!r}; "
                           f"known: {sorted(self._ops)}")
        return st

    def registered_ops(self) -> List[str]:
        """Names of the registered operator plans."""
        with self._plan_lock:
            return sorted(self._ops)

    def schedule(self, real: bool = False, shape=None,
                 op: Optional[str] = None) -> Tuple[int, int]:
        """The (coalesce width, overlap chunks) serving this kind."""
        if op is not None:
            st = self._op_state(op)
        else:
            st = self._state(self._default_shape(shape), real)
        return st.width, st.chunks

    def set_schedule(self, width: int, chunks: int, *, real: bool = False,
                     shape=None, op: Optional[str] = None) -> None:
        """Override the serving schedule for one (shape, kind) — what
        :meth:`autotune` does with its measured winner. ``op=`` targets
        a registered operator plan instead."""
        if not (1 <= chunks <= width):
            raise ValueError(f"need 1 <= chunks <= width, got ({width}, {chunks})")
        with self._plan_lock:
            key = None
            if op is not None:
                st = self._op_state(op)
            else:
                key = (self._default_shape(shape), bool(real))
                st = self._state(*key)
            if chunks != st.plan.overlap_chunks:
                st.plan = st.plan.with_options(overlap_chunks=chunks)
                st.group_cache.clear()
                if key is not None:
                    # the dropped group shapes' bytes go with them
                    self._states.set_nbytes(key, 0)
            st.width = int(width)
            st.chunks = int(chunks)

    def serving_shapes(self) -> List[Tuple[Tuple[int, ...], bool]]:
        """(shape, real) keys currently cached, LRU first."""
        with self._plan_lock:
            return self._states.keys()

    def set_drainer(self, *, max_wait_ms=_UNSET, watermark=_UNSET) -> None:
        """Retarget the drainer triggers at run time: a caller observing
        arrival rates trades coalesce width (``watermark``) against
        queueing delay (``max_wait_ms``) while the engine keeps serving.
        Either knob may be None (trigger disabled). Affects requests
        submitted after the call; deadlines already queued stand. Does
        not start or stop the drainer thread."""
        with self._cond:
            if max_wait_ms is not _UNSET:
                if max_wait_ms is not None and max_wait_ms < 0:
                    raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
                self.max_wait_ms = max_wait_ms
            if watermark is not _UNSET:
                if watermark is not None and watermark < 1:
                    raise ValueError(f"watermark must be >= 1, got {watermark}")
                self.watermark = watermark
            # wake the drainer: a shrunken watermark may make a queue
            # ripe right now
            self._cond.notify_all()

    def dispatch_stats(self) -> Dict[str, object]:
        """How many coalesced groups ran and a histogram of their widths."""
        with self._stats_lock:
            return {'groups': self.dispatched_groups,
                    'width_hist': dict(sorted(self.width_hist.items()))}

    def queue_depths(self) -> Dict[tuple, int]:
        """Currently queued (not yet dispatched) requests per
        (shape, real, direction, dtype, planar) key."""
        with self._cond:
            return {key: len(q) for key, q in self._queues.items() if q}

    # -- request intake -----------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        """One operand as the port's tensor on the mesh's device: numpy
        through :func:`repro_torch.weights.from_numpy` (complex64 or
        float32, as the reference's x32 canonicalization); a tensor as it
        is, on the mesh's device type and of a type the plans take."""
        if not isinstance(a, torch.Tensor):
            return from_numpy(a, device=self.mesh.device)
        if a.device.type != self.mesh.device.type:
            raise ValueError(f"operand on {a.device}, engine on {self.mesh.device}")
        if a.dtype not in _DTYPES:
            raise TypeError(f"the port's plans take complex64 or float32 operands, "
                            f"got {a.dtype}")
        return a

    def _split_operand(self, x):
        """(operand, its shape, its dtype, planar) with tensors made."""
        if isinstance(x, (tuple, list)):
            re, im = (self._tensor(a) for a in x)
            if re.shape != im.shape or re.is_complex() or im.is_complex():
                raise ValueError(f"a planar operand is two real arrays of one shape, got "
                                 f"{re.dtype}{tuple(re.shape)} and "
                                 f"{im.dtype}{tuple(im.shape)}")
            return (re, im), tuple(re.shape), re.dtype, True
        x = self._tensor(x)
        return x, tuple(x.shape), x.dtype, False

    @staticmethod
    def _core(st: _PlanState, real: bool, direction: str) -> Tuple[int, ...]:
        """The operand shape a request of this kind passes: this rank's
        block (the whole array on one rank) of the forward's input, the
        forward's output (an inverse), or the operator's input."""
        p = st.plan
        if direction == 'inv':
            return tuple(p.spectrum_local_shape() if real else p.local_shape(p.out_layout))
        return tuple(p.local_shape(p.in_layout))

    def _resolve_request(self, x, direction: str, real: Optional[bool]):
        """Normalize one operand: returns (x, transform shape, real,
        dtype, planar, plan state). Kind inference: floating-dtype
        forwards go to the rfft plan, complex forwards to the complex
        plan; inverses resolve their operand shape against the engine's
        default shape and already-served plans (pass ``real=`` for new
        shapes)."""
        if direction not in ('fwd', 'inv'):
            raise ValueError(f"direction must be 'fwd'|'inv', got {direction!r}")
        x, op_shape, dtype, planar = self._split_operand(x)
        if planar:
            if real is None:
                # planar forwards are complex-plan-only; planar
                # inverses may be a real plan's half spectrum
                real = (False if direction == 'fwd'
                        else self._infer_inverse_kind(op_shape))
            if real and direction == 'fwd':
                raise ValueError("real plan forward takes ONE real array, not a planar pair")
        elif real is None:
            real = (not x.is_complex() if direction == 'fwd'
                    else self._infer_inverse_kind(op_shape))
        real = bool(real)
        if not 1 <= len(op_shape) <= 3:
            raise ValueError(
                f"request shape {op_shape} has rank {len(op_shape)}; the "
                f"engine serves rank 1-3 transforms (submit single "
                f"requests — the engine owns batching)")
        if direction == 'inv' and real:
            tshape = self._real_shape_from_spectrum(op_shape)
        else:
            tshape = self._transform_shape(op_shape, real, direction)
        st = self._state(tshape, real)
        core = self._core(st, real, direction)
        if op_shape != core:
            raise ValueError(
                f"request shape {op_shape} != the transform's operand "
                f"shape {core} (submit single requests; the engine "
                f"owns batching)")
        return x, tshape, real, str(dtype).replace('torch.', ''), planar, st

    def _transform_shape(self, op_shape: tuple, real: bool, direction: str):
        """The transform shape of a forward or complex-inverse operand: on
        one rank its own shape; on a mesh the planned shape (default or
        cached) whose block it is."""
        if self.mesh.size == 1:
            return op_shape
        with self._plan_lock:
            cands = [shape for shape, r in self._states.keys() if r == real]
        if self.shape is not None and self.shape not in cands:
            cands.insert(0, self.shape)
        for shape in cands:
            if self._core(self._state(shape, real), real, direction) == op_shape:
                return shape
        raise ValueError(
            f"request block {op_shape} is no planned shape's block on this "
            f"{self.mesh.size}-rank mesh; plan the shape first (FFTEngine(shape, mesh) "
            f"or plan_for(shape=...)) — the engine owns batching")

    def _infer_inverse_kind(self, op_shape: tuple) -> bool:
        """Side-effect free: inference must never build or LRU-touch a
        plan — a cache insert here could evict the very served plan the
        scan below needs."""
        one = self.mesh.size == 1
        if one and self.shape is not None and op_shape == tuple(self.shape):
            return False               # the default shape wins outright
        with self._plan_lock:
            kinds = {real for (_, real), st in self._states.items()
                     if self._core(st, real, 'inv') == op_shape}
        if (one and not kinds and self.shape is not None
                and not self._plan_kwargs.get('padded_spectrum')
                and op_shape == (tuple(self.shape[:-1]) + (self.shape[-1] // 2 + 1,))):
            # the default real plan's np-layout spectrum, computed
            # arithmetically (padded_spectrum engines cache their real
            # plan the first time it serves, covered by the scan)
            kinds.add(True)
        if len(kinds) == 1:
            return kinds.pop()
        raise ValueError(
            f"inverse operand shape {op_shape} matches neither the "
            f"engine's complex shapes nor a served real plan's spectrum "
            f"unambiguously; pass real= explicitly")

    def _real_shape_from_spectrum(self, op_shape: tuple) -> Tuple[int, ...]:
        """Transform shape of a real inverse from its spectrum operand:
        a served real plan whose spectrum matches wins (covers
        ``padded_spectrum`` and a mesh's blocks); otherwise, on one rank,
        the np.rfftn layout inverts as n = 2 * (ns - 1)."""
        with self._plan_lock:
            for (shape, real), st in self._states.items():
                if real and self._core(st, True, 'inv') == op_shape:
                    return shape
        if self.mesh.size > 1:
            raise ValueError(
                f"spectrum block {op_shape} is no served real plan's on this "
                f"{self.mesh.size}-rank mesh; serve the forward first or "
                f"plan_for(real=True, shape=...)")
        if self._plan_kwargs.get('padded_spectrum'):
            raise ValueError(
                f"cannot infer the transform shape of a padded_spectrum "
                f"real inverse from operand shape {op_shape}; serve the "
                f"forward first or submit the matching forward shape")
        return op_shape[:-1] + (2 * (op_shape[-1] - 1),)

    def _check_serving(self) -> None:
        """Raise when this engine cannot make progress on a new
        request. A dead drainer thread must surface HERE, immediately:
        enqueueing into a queue nobody drains turns ``result()`` into a
        hang."""
        if self._closed:
            raise RuntimeError("submit() after close(): the engine has "
                               "been drained and stopped")
        if self._drainer_error is not None:
            raise RuntimeError("the background drainer died; the engine "
                               "cannot serve") from self._drainer_error
        if self._drainer is not None and not self._drainer.is_alive():
            raise RuntimeError(
                "the background drainer thread is not running (it died "
                "without reporting an error); the engine cannot serve — "
                "construct a new engine")

    def _resolve_op_request(self, x, name: str):
        """Normalize one operator-plan operand: returns the same tuple
        shape as :meth:`_resolve_request`, with the op's name folded
        into the kind slot of the queue key (an op group must never
        coalesce with a plain transform, or with another op on the
        same shape)."""
        st = self._op_state(name)
        p = st.plan
        x, op_shape, dtype, planar = self._split_operand(x)
        if planar and p.real:
            raise ValueError(f"operator plan {name!r} is real and takes ONE real "
                             f"array, not a planar pair")
        if not planar and p.real and x.is_complex():
            raise ValueError(f"operator plan {name!r} is real; got a complex operand")
        core = self._core(st, p.real, 'op')
        if op_shape != core:
            raise ValueError(
                f"request shape {op_shape} != operator plan {name!r} "
                f"operand shape {core} (submit single requests — the engine "
                f"owns batching)")
        return x, p.shape, f'op:{name}', str(dtype).replace('torch.', ''), planar, st

    def submit(self, x, *, direction: str = 'fwd',
               real: Optional[bool] = None,
               op: Optional[str] = None,
               max_wait_ms: Optional[float] = _UNSET) -> FFTTicket:
        """Queue one transform request (exactly its transform shape, or
        on a mesh this rank's block of it — the engine owns batching).
        ``real=None`` infers the plan kind as documented on
        :meth:`_resolve_request`. ``op=`` routes the request through a
        registered operator plan (:meth:`register_op`). ``max_wait_ms``
        overrides the engine-wide drainer deadline for THIS request
        (None disables the deadline trigger for it; ignored on
        foreground engines, which only dispatch on ``flush()``).
        Thread-safe; raises after :meth:`close` and raises immediately
        when the drainer thread has died."""
        self._check_serving()
        if op is not None:
            if direction != 'fwd' or real is not None:
                raise ValueError("op= requests take no direction/real: "
                                 "the operator plan rounds back to its "
                                 "input form")
            x, tshape, kind, dtype, planar, st = self._resolve_op_request(x, op)
            key = (tshape, kind, 'op', dtype, planar)
        else:
            x, tshape, real, dtype, planar, st = self._resolve_request(x, direction, real)
            key = (tshape, real, direction, dtype, planar)
        t = FFTTicket(self)
        with self._cond:
            # re-checked under the lock: a drainer that died between
            # the entry check and here already failed every queued
            # ticket — an enqueue now would strand this request
            self._check_serving()
            wait_ms = self.max_wait_ms if max_wait_ms is _UNSET else max_wait_ms
            deadline = (time.monotonic() + wait_ms / 1e3
                        if self._background and wait_ms is not None else None)
            self._queues.setdefault(key, []).append(
                _Request(t, key, x, self._seq, deadline, st.width))
            self._seq += 1
            self._cond.notify_all()
        return t

    # -- execution ----------------------------------------------------------

    def _group_nbytes(self, plan: fft_api.FFT, w: int, dtype) -> int:
        """Byte estimate of one group shape: its staged inputs + outputs
        at the REQUEST dtype (the plan-cache budget's unit)."""
        dt = np.dtype(dtype)
        if np.issubdtype(dt, np.complexfloating):
            flt = np.dtype('float64' if dt.itemsize == 16 else 'float32')
            cplx = dt
        else:
            flt = dt
            cplx = np.dtype('complex128' if dt.itemsize == 8 else 'complex64')
        return int(w) * (plan.operand_nbytes(flt if plan.real else cplx)
                         + plan.operand_nbytes(cplx, spectrum=True))

    def _run_group(self, plan: fft_api.FFT, direction: str, planar: bool,
                   ops: Sequence, cache: dict, state_key: Optional[tuple] = None):
        """Execute one coalesced group: stack the w requests along a new
        leading axis, run the batched plan call (the in-call overlap
        pipeline lives inside it), and hand back the per-request outputs
        as views of the batched one, a tuple (planar results as a
        (re..., im...) flat tuple). A group shape seen for the first
        time grows the plan's cache entry by its operand bytes."""
        if self.faults is not None:
            # injected dispatch failures ride the SAME path a real
            # failure would: the pipeline's on_error blames this group,
            # bystanders re-queue for free
            self.faults.perhaps_raise('engine.dispatch')
        w = len(ops)
        dtype = str((ops[0][0] if planar else ops[0]).dtype).replace('torch.', '')
        key = (direction, planar, w, dtype)
        if key not in cache:
            cache[key] = self._group_nbytes(plan, w, dtype)
            if state_key is not None:
                with self._plan_lock:
                    self._states.grow(state_key, cache[key])
        if direction == 'op':
            apply_fn = plan.apply       # fused forward -> op -> inverse
        else:
            apply_fn = plan.forward if direction == 'fwd' else plan.inverse
        if planar:
            out = apply_fn((_stack([o[0] for o in ops]), _stack([o[1] for o in ops])))
        else:
            out = apply_fn(_stack(ops))
        if isinstance(out, tuple):          # planar out
            return tuple(out[0].unbind(0)) + tuple(out[1].unbind(0))
        return tuple(out.unbind(0))

    def _push_bucket(self, pipe: ov.StreamPipeline, key: tuple,
                     entries: List[_Request]) -> None:
        """Coalesce one kind's entries into width-sized groups and
        dispatch them into the stream pipeline."""
        tshape, real, direction, _, planar = key
        if direction == 'op':
            # the kind slot carries 'op:<name>'; op states are pinned
            # outside the LRU, so no byte accounting (state_key=None)
            state = self._op_state(real[len('op:'):])
            state_key = None
        else:
            state = self._state(tshape, real)
            state_key = (tshape, real)
        plan = state.plan
        w = state.width
        for i in range(0, len(entries), w):
            group = entries[i:i + w]
            ops = [e.x for e in group]
            with self._stats_lock:
                self.dispatched_groups += 1
                self.width_hist[len(group)] = self.width_hist.get(len(group), 0) + 1

            def resolve(yb, group=group):
                # runs when the group's result is FORCED, in stream
                # order: a later group's failure leaves exactly the
                # completed prefix resolved
                gw = len(group)
                for j, e in enumerate(group):
                    e.ticket._resolve((yb[j], yb[gw + j]) if len(yb) == 2 * gw else yb[j])

            def blame(exc, group=group):
                # the pipeline tears down EVERY in-flight group when one
                # fails; only the culprit's requests burn a retry —
                # innocent bystanders re-queue for free
                self._blamed = True
                for e in group:
                    e.attempts += 1

            pipe.push(
                lambda plan=plan, ops=ops: self._run_group(
                    plan, direction, planar, ops, state.group_cache, state_key),
                resolve, blame)

    def _take_locked(self, keys=None) -> Dict[tuple, List[_Request]]:
        """Pop every queued entry (of ``keys``, or all); caller holds
        the condition lock."""
        taken = {}
        for key in list(keys if keys is not None else self._queues):
            q = self._queues.pop(key, None)
            if q:
                taken[key] = q
        return taken

    def _recover(self, entries: List[_Request], exc: BaseException, *,
                 bounded: bool) -> None:
        """A dispatch pass failed: put every unresolved entry back on
        its queue so nothing is silently dropped. Only the CULPRIT
        group's entries had their ``attempts`` charged (the pipeline's
        ``on_error`` attribution); bystander groups torn down by the
        abort retry for free. With ``bounded`` (the drainer), entries
        that already exhausted ``retries`` — or arrive after close —
        fail their tickets with the error instead, so it surfaces on
        ``result()``."""
        unresolved = [e for e in entries if not e.ticket._done and e.ticket._error is None]
        unresolved.sort(key=lambda e: e.seq)
        now = time.monotonic()
        with self._cond:
            if not self._blamed:
                # no attribution (a failure outside any group's
                # dispatch/force): charge everyone rather than retry a
                # deterministic crash forever
                for e in unresolved:
                    e.attempts += 1
            self._blamed = False
            for e in reversed(unresolved):
                if bounded and (e.attempts > self.retries or self._closed):
                    e.ticket._fail(exc)
                    continue
                e.deadline = now        # ripe immediately: retry next pass
                self._queues.setdefault(e.key, []).insert(0, e)
            self._cond.notify_all()

    def flush(self) -> List:
        """Execute everything queued, synchronously: coalesce per kind,
        dispatch the groups double-buffered, resolve tickets. Returns
        the executed requests' results in submission order. On failure
        the unresolved requests are re-queued and the error propagates —
        flushing again retries them."""
        with self._dispatch_lock, self._on_device():
            with self._cond:
                buckets = self._take_locked()
            if not buckets:
                return []
            entries = [e for es in buckets.values() for e in es]
            pipe = ov.StreamPipeline(self.depth)
            try:
                for key in sorted(buckets, key=lambda k: buckets[k][0].seq):
                    self._push_bucket(pipe, key, buckets[key])
                pipe.drain()
            except BaseException as exc:
                pipe.abort()
                self._recover(entries, exc, bounded=False)
                raise
        entries.sort(key=lambda e: e.seq)
        return [e.ticket._value for e in entries]

    def transform(self, xs: Sequence, *, direction: str = 'fwd',
                  real: Optional[bool] = None,
                  timeout: Optional[float] = None) -> List:
        """Convenience: submit every operand, flush once, and return
        the results in order. A synchronous call must make its own
        progress, so this flushes on background engines too."""
        tickets = [self.submit(x, direction=direction, real=real) for x in xs]
        self.flush()
        return [t.result(timeout) for t in tickets]

    # -- the background drainer ---------------------------------------------

    def _ripe_locked(self, now: float):
        """(ripe keys, wait timeout): a queue is ripe when it holds a
        full coalesce-width watermark OR any queued entry's deadline
        passed; the timeout is the next deadline. The deadline scan
        covers the WHOLE queue, not just the head: a later,
        tighter-deadline request can ripen a queue whose head is a
        patient one. Caller holds the condition lock."""
        ripe, next_deadline = [], None
        for key, q in self._queues.items():
            if not q:
                continue
            mark = self.watermark if self.watermark is not None else q[0].width
            dl = min((e.deadline for e in q if e.deadline is not None), default=None)
            if len(q) >= mark or (dl is not None and now >= dl):
                ripe.append(key)
            elif dl is not None and (next_deadline is None or dl < next_deadline):
                next_deadline = dl
        timeout = None if next_deadline is None else max(next_deadline - now, 0.0)
        return ripe, timeout

    def _drain_pass(self, pipe: ov.StreamPipeline) -> bool:
        """ONE drainer dispatch pass: take whatever is ripe, dispatch
        it, and force in-flight results when nothing else is ready.
        Returns True when the engine is closed and fully drained.
        Never blocks idle — the weakref loop in :func:`_drainer_main`
        owns the waiting."""
        if self.faults is not None:
            # injected drainer stall: the serving loop goes dark for
            # delay_s while queues grow
            self.faults.perhaps_stall('engine.drainer')
        with self._cond:
            final = self._closed
        with self._dispatch_lock:
            with self._cond:
                if final:
                    buckets = self._take_locked()
                else:
                    ripe, _ = self._ripe_locked(time.monotonic())
                    buckets = self._take_locked(ripe)
            self._inflight.extend(e for es in buckets.values() for e in es)
            try:
                for key in sorted(buckets, key=lambda k: buckets[k][0].seq):
                    self._push_bucket(pipe, key, buckets[key])
                # force in-flight groups whenever nothing else is ripe
                # — waiters must resolve without depending on future
                # submissions; under sustained load the window stays
                # full across passes instead
                with self._cond:
                    more, _ = self._ripe_locked(time.monotonic())
                if final or not more:
                    pipe.drain()
            except BaseException as exc:
                pipe.abort()
                # every tracked entry is now either resolved,
                # re-queued, or failed — nothing stays in flight
                self._recover(self._inflight, exc, bounded=True)
                self._inflight = []
            else:
                self._inflight = [e for e in self._inflight if not e.ticket._done]
        return final

    def _drainer_crashed(self, exc: BaseException) -> None:
        """The drainer must never die silently: record the error and
        fail everything queued or in flight so waiters wake up."""
        self._drainer_error = exc
        with self._cond:
            lost = [e for es in self._take_locked().values() for e in es] + self._inflight
            self._inflight = []
        for e in lost:
            if not e.ticket._done:
                e.ticket._fail(exc)

    # -- autotune -----------------------------------------------------------

    def autotune(self, sample: Sequence, *, direction: str = 'fwd',
                 real: Optional[bool] = None, op: Optional[str] = None,
                 repeats: int = 3,
                 widths: Optional[Sequence[int]] = None,
                 chunks: Optional[Sequence[int]] = None,
                 persist: bool = False) -> Tuple[int, int]:
        """FFTW_MEASURE-style schedule pick: time candidate (coalesce
        width, overlap_chunks) schedules on REAL sample operands (wall
        time to finished results on the card) and adopt the fastest for
        this (shape, kind). ``op=`` tunes a registered operator plan
        instead; its persisted rows carry the op name.

        The cost model's pick (:meth:`_pick_schedule`) prices the WSE in
        cycles; a measurement on this host's device beats it. With
        ``persist=True`` the winner is merged into the port's schedule
        table on disk (``BENCH_torch_serve_schedule.json`` unless
        overridden), seeding every later engine's pick for this config.
        Returns the adopted (width, chunks)."""
        if not sample:
            raise ValueError("autotune needs at least one sample operand")
        if op is not None:
            _, tshape, _, dtype, planar, st = self._resolve_op_request(sample[0], op)
            real, direction = st.plan.real, 'op'
        else:
            _, tshape, real, dtype, planar, st = self._resolve_request(
                sample[0], direction, real)
        if persist and self._schedule_path is None:
            raise ValueError(
                "autotune(persist=True) on an engine constructed with "
                "schedule_table=None — persisted seeding is disabled; "
                "pass a table path (or 'auto') to the engine")
        base = st.plan
        if widths is None:
            widths = [1]
            while widths[-1] * 2 <= self.max_coalesce and widths[-1] < len(sample):
                widths.append(widths[-1] * 2)
        if chunks is None:
            chunks = (1, 2, 4, 8)
        plans = {c: base.with_options(overlap_chunks=c, donate=False)
                 for c in {c for w in widths for c in chunks if c <= w and w % c == 0}}
        ops = [self._split_operand(x)[0] for x in sample]
        cuda = self.mesh.device.type == 'cuda'

        def make_run(w, c):
            groups = [ops[i:i + w] for i in range(0, len(ops), w)]
            p, cache = plans[c], {}

            def run():
                t0 = time.perf_counter()
                ov.pipelined_stream(
                    lambda g: self._run_group(p, direction, planar, g, cache),
                    groups, depth=self.depth)
                if cuda:
                    torch.cuda.synchronize(self.mesh.device)
                return (time.perf_counter() - t0) / len(ops) * 1e6
            return run

        runs = {(w, c): make_run(w, c) for w in widths for c in chunks
                if c <= w and w % c == 0}
        # the dispatch lock serializes against the drainer: concurrent
        # serving traffic would pollute the timings
        with self._dispatch_lock, self._on_device():
            for run in runs.values():          # build + warm everything
                run()
            # interleaved rounds with min aggregation: round-robin
            # spreads every phase of the host's drift over every
            # candidate, and the min is the closest thing to the
            # uncontended floor
            timings = {k: [] for k in runs}
            for _ in range(max(repeats, 1)):
                for k, run in runs.items():
                    timings[k].append(run())
        best = min(runs, key=lambda k: min(timings[k]))
        w, c = best
        if op is not None:
            self.set_schedule(w, c, op=op)
        else:
            self.set_schedule(w, c, real=real, shape=tshape)
        if persist:
            row = dict(zip(('mesh', 'shape', 'kind', 'strategy'),
                           ccost.ScheduleTable.make_key(
                               dict(self.mesh.shape), tshape,
                               'real' if real else 'complex', base.comm)))
            tags = self._table_tags(base)
            row.update(dtype=dtype, coalesce_width=w, overlap_chunks=c,
                       us_per_request=min(timings[best]), backend=tags['backend'])
            if op is not None:
                row['op'] = op
            for tag in ('wire', 'kernel'):
                if tags[tag] is not None:
                    row[tag] = tags[tag]
            try:
                ccost.persist_schedule_rows([row], self._schedule_path)
                self._schedule_table = ccost.schedule_table(self._schedule_path)
            except OSError as exc:
                # the winner is already adopted in memory; losing the
                # measurement to an unwritable table would be worse
                # than a warning
                warnings.warn(f"autotune could not persist the schedule to "
                              f"{self._schedule_path}: {exc}", RuntimeWarning,
                              stacklevel=2)
        return best

    def __repr__(self):
        with self._plan_lock:
            kinds = {f"{'x'.join(map(str, shape))}"
                     f"{'/real' if real else ''}": f"w={st.width},c={st.chunks}"
                     for (shape, real), st in self._states.items()}
        return (f"FFTEngine(shape={self.shape}, mesh={dict(self.mesh.shape)}, "
                f"max_coalesce={self.max_coalesce}, donate={self.donate}, "
                f"background={self._background}, schedules={kinds})")
