"""Continuous-batching projection engine: async submit/poll with latency SLOs
(port of ``repro/serving/engine.py``).

The engine serves projections through the planner. A background dispatcher
pops *every* request pending for one plan key the moment that key's plan is
ready, so a request joins the next dispatch for its key instead of waiting
for a bucket to fill.

* **continuous batching** — one dispatch serves everything that arrived for
  a key since its last dispatch (capped at ``max_batch``), padded to the next
  power of two with zero items of radius 0;
* **in-place buckets** — a dispatch copies its requests into one bucket
  tensor on the engine's device (``torch.stack(..., out=bucket)``), the
  projection writes its result into that bucket in place (``out=bucket``;
  the ``codegen_batch`` kernels read and write the same buffer), and every
  ticket gets a view of its row. This replaces the JAX engine's jitted
  stack-and-donate dispatch. A bucket is allocated per dispatch from
  PyTorch's caching allocator rather than reused per ``(key, b)``: the
  returned views keep their bucket alive until claimed, and reusing one
  bucket would overwrite results not yet read. The engine never writes
  into a caller's tensor;
* **plan-cache warm pool** — plans build on a thread pool and the
  dispatcher skips keys whose plan is still building; ``prewarm()`` builds
  ahead of traffic;
* **admission control** — the queue is bounded (``max_pending``); overload
  is shed at ``submit()`` with :class:`QueueFullError`, and per-request
  deadlines steer the dispatcher (earliest deadline first); requests past
  their deadline complete with :class:`DeadlineExceededError`.

Typical use::

    with ProjectionEngine() as eng:                 # on the card
        t1 = eng.submit(w1, [("inf", 1), ("1", 1)], radius=1.0)
        t2 = eng.submit(w2, [("inf", 1), ("1", 1)], radius=2.0)
        x1 = eng.result(t1, timeout=5.0)

Failure semantics: a dispatch that raises re-queues its group (at the front,
order preserved) up to ``max_attempts`` times; after that every ticket in
the group completes exceptionally. ``result()`` re-raises the stored error;
an unknown, already claimed or discarded ticket raises
:class:`UnknownTicketError`.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import _device
from repro_torch.core import plan as planmod, schedule
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import timed

# the one clock for deadlines, queue ages and latencies: monotonic, so a
# wall-clock step can never expire a deadline or corrupt a histogram
_now = time.monotonic

# (shape, dtype name, canonical levels, canonical method): requests share a
# dispatch iff they share a plan
GroupKey = Tuple[Tuple[int, ...], str, Tuple[Tuple[str, int], ...], str]

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _key_label(key: GroupKey) -> str:
    """Compact per-key metric label: ``6x10/float32/inf1-11/bisect``."""
    shape, dtype, levels, method = key
    lv = "-".join(f"{q}{k}" for q, k in levels)
    return f"{'x'.join(map(str, shape))}/{dtype}/{lv}/{method}"


class ServingError(RuntimeError):
    """Base class for engine failures surfaced through tickets."""


class QueueFullError(ServingError):
    """Admission control: the bounded queue is full — shed load upstream."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed before its dispatch executed."""


class UnknownTicketError(ServingError, KeyError):
    """The ticket is not pending here: foreign, already claimed, or
    discarded."""


def _bucket(n: int) -> int:
    """Next power of two >= n."""
    return 1 << (n - 1).bit_length()


class Ticket:
    """Handle for one submitted projection; hand it back to
    :meth:`ProjectionEngine.poll` / :meth:`ProjectionEngine.result`."""

    __slots__ = ("id", "key", "_engine", "_event", "_state", "_value",
                 "_error")

    def __init__(self, tid: int, key: GroupKey, engine: "ProjectionEngine"):
        self.id = tid
        self.key = key
        self._engine = engine
        self._event = threading.Event()
        self._state = "pending"          # -> done | failed -> claimed
        self._value: Optional[torch.Tensor] = None
        self._error: Optional[BaseException] = None

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Ticket(id={self.id}, state={self._state})"


class _Request:
    __slots__ = ("ticket", "y", "radius", "deadline", "attempts", "enqueued")

    def __init__(self, ticket: Ticket, y: torch.Tensor, radius: torch.Tensor,
                 deadline: Optional[float]):
        self.ticket = ticket
        self.y = y
        self.radius = radius
        self.deadline = deadline          # absolute _now() time, or None
        self.attempts = 0
        self.enqueued = _now()


class EngineStats(dict):
    """The engine's operational counters: a plain dict
    (``eng.stats["dispatches"]``) that can also be called: ``eng.stats()``
    returns :meth:`ProjectionEngine.stats_snapshot`, the full structured
    snapshot (counters, queue state, per-key latency summaries, the
    planner's cache counters)."""

    def __init__(self, engine: "ProjectionEngine", *args, **kw):
        super().__init__(*args, **kw)
        self._engine = engine

    def __call__(self) -> dict:
        return self._engine.stats_snapshot()


class _EngineMetrics:
    """The engine's handles in the process-global obs registry, built once
    per engine; ``instrument=False`` engines skip it entirely."""

    def __init__(self):
        reg = obs_metrics.get_registry()
        self.queue_depth = reg.gauge(
            "serving_queue_depth", "queued (undispatched) requests")
        self.inflight = reg.gauge(
            "serving_inflight_requests", "popped but not yet completed")
        self.events = reg.counter(
            "serving_events_total", "engine lifecycle events",
            labels=("event",))
        self.queue_s = reg.histogram(
            "serving_queue_seconds", "submit -> dispatch-pop wait",
            labels=("key",))
        self.e2e_s = reg.histogram(
            "serving_e2e_seconds", "submit -> completion latency",
            labels=("key",))
        self.dispatch_s = reg.histogram(
            "serving_dispatch_seconds", "one group's execute time",
            labels=("key",))
        self.batch_size = reg.histogram(
            "serving_batch_size", "requests per dispatch",
            buckets=_BATCH_BUCKETS)
        self.plan_build_s = reg.histogram(
            "serving_plan_build_seconds", "plan build on the warm pool")
        self._by_key: Dict[GroupKey, tuple] = {}
        self.ev = {name: self.events.labels(event=name)
                   for name in ("submitted", "rejected", "expired",
                                "requeue", "failure", "dispatch",
                                "completed", "failed", "discarded")}

    def for_key(self, key: GroupKey) -> tuple:
        """(queue_s, e2e_s, dispatch_s) histogram children for one key."""
        h = self._by_key.get(key)
        if h is None:
            lbl = _key_label(key)
            h = (self.queue_s.labels(key=lbl), self.e2e_s.labels(key=lbl),
                 self.dispatch_s.labels(key=lbl))
            self._by_key[key] = h
        return h


class ProjectionEngine:
    """Async continuous-batching projection server over the planner.

    Parameters
    ----------
    device:       where requests are projected: ``"cuda"`` (the default;
                  raises without a CUDA device) or ``"cpu"``.
    method:       default backend for every submit (``"auto"`` autotunes per
                  workload); per-submit ``method=`` overrides.
    max_batch:    cap on one dispatch's group size.
    max_pending:  admission bound on queued requests; ``submit()`` past it
                  raises :class:`QueueFullError`.
    max_attempts: dispatch attempts per request before its group's failure
                  is surfaced through the tickets.
    warm_workers: threads in the plan warm pool.
    instrument:   record queue/latency/batch metrics into the obs registry.
    start:        launch the background dispatcher thread; with
                  ``start=False`` nothing runs until :meth:`drain` dispatches
                  inline (deterministic mode for tests).
    """

    def __init__(self, *, device=None, method: str = planmod.AUTO,
                 max_batch: int = 64, max_pending: int = 1024,
                 max_attempts: int = 2, warm_workers: int = 2,
                 instrument: bool = True, start: bool = True):
        if max_batch < 1 or max_pending < 1 or max_attempts < 1:
            raise ValueError(
                "max_batch, max_pending, max_attempts must be >= 1")
        self.device = _device.resolve(device)
        self.default_method = method
        self.max_batch = int(max_batch)
        self.max_pending = int(max_pending)
        self.max_attempts = int(max_attempts)
        self._cv = threading.Condition()
        self._queues: Dict[GroupKey, List[_Request]] = {}
        self._plans: Dict[GroupKey, Future] = {}
        self._pending_count = 0
        self._inflight = 0
        self._inflight_reqs = 0
        self._next_ticket = 0
        self._stopping = False
        self.stats = EngineStats(
            self, submitted=0, dispatches=0, batched_requests=0, rejected=0,
            expired=0, requeues=0, failures=0, max_group=0, completed=0,
            failed=0, discarded=0)
        self._metrics = _EngineMetrics() if instrument else None
        self._warm = ThreadPoolExecutor(max_workers=int(warm_workers),
                                        thread_name_prefix="plan-warm")
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._loop,
                                            name="projection-dispatch",
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- submit

    def _key(self, shape, dtype, levels, method) -> GroupKey:
        levels = planmod.canonical_levels(levels)
        schedule.check_levels(shape, levels)
        requested = self.default_method if method is None else method
        # groups execute as stacked buckets, so validate as a batch key
        requested = planmod.validate_backend(
            shape, dtype, levels, requested, device=self.device.type,
            radius_kind="batch")
        return (tuple(shape), planmod.dtype_name(dtype), levels, requested)

    def submit(self, y, levels, radius=1.0, *, method: Optional[str] = None,
               deadline: Optional[float] = None) -> Ticket:
        """Queue one projection; returns a :class:`Ticket`.

        ``y`` (a tensor or array) is copied to the engine's device when it
        lies elsewhere. ``deadline`` is seconds from now: a request still
        queued past it completes with :class:`DeadlineExceededError`.
        Raises :class:`QueueFullError` when ``max_pending`` requests are
        queued, and ``ValueError`` for an invalid design or backend.
        """
        with self._cv:
            if self._stopping:
                raise ServingError("engine is stopped")
        y = torch.as_tensor(y, device=self.device)
        if not y.is_floating_point():
            raise ValueError(f"projections take floating tensors, got {y.dtype}")
        key = self._key(tuple(y.shape), y.dtype, levels, method)
        radius = torch.as_tensor(radius, dtype=y.dtype, device=self.device)
        if radius.ndim != 0:
            raise ValueError(
                f"radius must be a scalar (one per request), got shape "
                f"{tuple(radius.shape)}")
        abs_deadline = None if deadline is None else _now() + float(deadline)
        m = self._metrics
        with self._cv:
            if self._stopping:
                raise ServingError("engine is stopped")
            if self._pending_count >= self.max_pending:
                self.stats["rejected"] += 1
                if m:
                    m.ev["rejected"].inc()
                raise QueueFullError(
                    f"{self._pending_count} requests queued "
                    f"(max_pending={self.max_pending})")
            ticket = Ticket(self._next_ticket, key, self)
            self._next_ticket += 1
            self._queues.setdefault(key, []).append(
                _Request(ticket, y, radius, abs_deadline))
            self._pending_count += 1
            self.stats["submitted"] += 1
            if m:
                m.ev["submitted"].inc()
                m.queue_depth.set(self._pending_count)
            self._ensure_plan_locked(key)
            self._cv.notify_all()
        return ticket

    def prewarm(self, shape, dtype, levels, *,
                method: Optional[str] = None) -> None:
        """Schedule the plan build for a workload ahead of traffic, on the
        warm pool; returns immediately."""
        key = self._key(tuple(int(s) for s in shape), dtype, levels, method)
        with self._cv:
            self._ensure_plan_locked(key)

    def wait_warm(self, timeout: Optional[float] = None) -> None:
        """Block until every scheduled plan build has finished; re-raises the
        first build failure."""
        with self._cv:
            futs = list(self._plans.values())
        for fut in futs:
            fut.result(timeout)

    # --------------------------------------------------------- plan cache

    def _ensure_plan_locked(self, key: GroupKey) -> None:
        if key not in self._plans:
            fut = self._warm.submit(self._build_plans, key)
            fut.add_done_callback(self._on_plan_ready)
            self._plans[key] = fut

    def _on_plan_ready(self, _fut: Future) -> None:
        with self._cv:
            self._cv.notify_all()

    def _build_plans(self, key: GroupKey) -> Dict[str, planmod.ProjectionPlan]:
        if self._metrics:
            with timed(self._metrics.plan_build_s):
                return self._build_plans_inner(key)
        return self._build_plans_inner(key)

    def _build_plans_inner(self, key: GroupKey
                           ) -> Dict[str, planmod.ProjectionPlan]:
        shape, dtype, levels, method = key
        dev = self.device.type
        plans = {"batch": planmod.make_plan(
            shape, dtype, levels, radius_kind="batch", method=method,
            device=dev)}
        if not planmod.is_batch_native(plans["batch"].method):
            # singletons skip the bucket; batch-native backends take stacked
            # buckets only, so their size-1 groups use the batch plan
            plans["scalar"] = planmod.make_plan(shape, dtype, levels,
                                                method=method, device=dev)
        return plans

    # --------------------------------------------------------- dispatcher

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._stopping and self._pending_count == 0:
                    break
            self._dispatch_once()

    def _dispatch_once(self, wait_s: float = 0.02) -> bool:
        """Pop and execute one group; returns whether anything ran."""
        m = self._metrics
        with self._cv:
            key = self._select_key_locked()
            if key is None:
                self._cv.wait(wait_s)
                return False
            reqs = self._queues.pop(key)
            take, rest = reqs[:self.max_batch], reqs[self.max_batch:]
            if rest:
                self._queues[key] = rest
            self._pending_count -= len(take)
            self._inflight += 1
            self._inflight_reqs += len(take)
            if m:
                m.queue_depth.set(self._pending_count)
                m.inflight.set(self._inflight_reqs)
        if m:
            popped, (queue_h, _, _) = _now(), m.for_key(key)
            for r in take:
                queue_h.observe(popped - r.enqueued)
        try:
            self._execute(key, take)
        finally:
            with self._cv:
                self._inflight -= 1
                self._inflight_reqs -= len(take)
                if m:
                    m.inflight.set(self._inflight_reqs)
                self._cv.notify_all()
        return True

    def _select_key_locked(self) -> Optional[GroupKey]:
        """Earliest-deadline dispatchable key, FIFO on the longest-waiting
        head request among deadline-free keys; keys whose plan is still
        building are skipped."""
        best, best_pri = None, (float("inf"), float("inf"))
        for key, q in self._queues.items():
            if not q:
                continue
            fut = self._plans.get(key)
            if fut is None:
                self._ensure_plan_locked(key)
                continue
            if not fut.done():
                continue
            dl = min((r.deadline for r in q if r.deadline is not None),
                     default=float("inf"))
            pri = (dl, q[0].enqueued)
            if best is None or pri < best_pri:
                best, best_pri = key, pri
        return best

    def _execute(self, key: GroupKey, reqs: List[_Request]) -> None:
        m = self._metrics
        e2e_h = dispatch_h = None
        if m:
            _, e2e_h, dispatch_h = m.for_key(key)
        try:
            plans = self._plans[key].result()
        except Exception as exc:  # the build's error goes to every ticket
            with self._cv:
                # drop the failed build so a later submit retries it
                self._plans.pop(key, None)
            err = ServingError(f"plan build failed for {key}: {exc!r}")
            err.__cause__ = exc
            for r in reqs:
                self._fail(r.ticket, err)
            return
        now = _now()
        live = []
        for r in reqs:
            if r.ticket._state != "pending":      # discarded before dispatch
                continue
            if r.deadline is not None and now > r.deadline:
                self.stats["expired"] += 1
                if m:
                    m.ev["expired"].inc()
                self._fail(r.ticket, DeadlineExceededError(
                    f"ticket {r.ticket.id} expired "
                    f"{now - r.deadline:.3f}s before dispatch"))
                continue
            live.append(r)
        if not live:
            return
        try:
            t0 = _now()
            outs = self._run_group(key, plans, live)
            if m:
                dispatch_h.observe(_now() - t0)
        except Exception as exc:  # retry boundary: the tickets carry the error
            for r in live:
                r.attempts += 1
            retry = [r for r in live if r.attempts < self.max_attempts]
            spent = [r for r in live if r.attempts >= self.max_attempts]
            for r in spent:
                self.stats["failures"] += 1
                if m:
                    m.ev["failure"].inc()
                err = ServingError(
                    f"dispatch failed after {r.attempts} attempt(s): {exc!r}")
                err.__cause__ = exc
                self._fail(r.ticket, err)
            if retry:
                self.stats["requeues"] += 1
                if m:
                    m.ev["requeue"].inc()
                with self._cv:
                    self._queues.setdefault(key, [])[0:0] = retry
                    self._pending_count += len(retry)
                    self._cv.notify_all()
            return
        self.stats["dispatches"] += 1
        self.stats["max_group"] = max(self.stats["max_group"], len(live))
        if len(live) > 1:
            self.stats["batched_requests"] += len(live)
        if m:
            m.ev["dispatch"].inc()
            m.batch_size.observe(len(live))
        done = _now()
        for r, out in zip(live, outs):
            self._complete(r.ticket, out)
            if m:
                e2e_h.observe(done - r.enqueued)

    def _run_group(self, key: GroupKey, plans, live) -> List[torch.Tensor]:
        """The compute for one popped group (the retry boundary)."""
        if len(live) == 1 and "scalar" in plans:
            r = live[0]
            return [plans["scalar"](r.y, r.radius)]
        shape, _, _, _ = key
        n = len(live)
        b = min(_bucket(n), self.max_batch)
        y0 = live[0].y
        bucket = torch.empty((b,) + shape, dtype=y0.dtype, device=y0.device)
        radii = torch.zeros((b,), dtype=y0.dtype, device=y0.device)
        torch.stack([r.y for r in live], out=bucket[:n])
        torch.stack([r.radius for r in live], out=radii[:n])
        bucket[n:].zero_()                 # pad items: zeros, radius 0
        plans["batch"](bucket, radii, out=bucket)
        return list(bucket[:n].unbind(0))

    # --------------------------------------------------------- completion

    def _complete(self, ticket: Ticket, value) -> None:
        with self._cv:
            if ticket._state != "pending":        # discarded mid-dispatch
                return
            ticket._state = "done"
            ticket._value = value
            self.stats["completed"] += 1
        if self._metrics:
            self._metrics.ev["completed"].inc()
        ticket._event.set()

    def _fail(self, ticket: Ticket, error: BaseException) -> None:
        with self._cv:
            if ticket._state != "pending":
                return
            ticket._state = "failed"
            ticket._error = error
            self.stats["failed"] += 1
        if self._metrics:
            self._metrics.ev["failed"].inc()
        ticket._event.set()

    # ------------------------------------------------------------ results

    def poll(self, ticket: Ticket) -> bool:
        """True once the ticket completed (result ready or failed)."""
        self._check_ticket(ticket)
        return ticket._event.is_set()

    def result(self, ticket: Ticket, timeout: Optional[float] = None):
        """Projected tensor for a completed ticket — single read. Blocks up
        to ``timeout`` seconds (``TimeoutError`` past it); re-raises the
        dispatch error of a failed ticket; :class:`UnknownTicketError` for a
        foreign, claimed or discarded ticket."""
        self._check_ticket(ticket)
        if self._thread is None and not ticket._event.is_set():
            self.drain()                   # synchronous mode: dispatch inline
        if not ticket._event.wait(timeout):
            raise TimeoutError(
                f"ticket {ticket.id} incomplete after {timeout}s")
        with self._cv:
            state = ticket._state
            if state == "done":
                ticket._state = "claimed"
                value, ticket._value = ticket._value, None
                return value
            if state == "failed":
                ticket._state = "claimed"
                error, ticket._error = ticket._error, None
            else:
                error = UnknownTicketError(
                    f"ticket {ticket.id} already {state}")
        raise error

    def discard(self, ticket: Ticket) -> None:
        """Drop a ticket that will never be claimed (no-op if claimed). A
        queued request leaves the queue now; a popped one is skipped at
        completion; a completed result is released."""
        self._check_ticket(ticket)
        with self._cv:
            if ticket._state == "claimed":
                return
            if ticket._state == "pending":
                q = self._queues.get(ticket.key)
                if q is not None:
                    for i, r in enumerate(q):
                        if r.ticket is ticket:
                            del q[i]
                            if not q:
                                del self._queues[ticket.key]
                            self._pending_count -= 1
                            break
                self.stats["discarded"] += 1
                if self._metrics:
                    self._metrics.ev["discarded"].inc()
                    self._metrics.queue_depth.set(self._pending_count)
            ticket._state = "discarded"
            ticket._value = None
            ticket._error = None
        ticket._event.set()

    def _check_ticket(self, ticket) -> None:
        if not isinstance(ticket, Ticket) or ticket._engine is not self:
            raise UnknownTicketError(
                f"not a ticket of this engine: {ticket!r}")

    # ---------------------------------------------------------- lifecycle

    def stats_snapshot(self) -> dict:
        """Counters, live queue state, per-key latency summaries (on
        instrumented engines) and the planner's cache counters. Accounting
        invariant::

            completed + failed + discarded + queued + inflight == submitted
        """
        with self._cv:
            snap: dict = dict(self.stats)
            snap["queued"] = self._pending_count
            snap["inflight"] = self._inflight_reqs
        m = self._metrics
        if m is not None:
            lat = {}
            for fam, field in ((m.queue_s, "queue"), (m.e2e_s, "e2e")):
                for child in fam.children():
                    key = child.labelvalues[0]
                    d = lat.setdefault(key, {})
                    d[f"{field}_count"] = child.count
                    d[f"{field}_p50_s"] = child.quantile(0.5)
                    d[f"{field}_p99_s"] = child.quantile(0.99)
            snap["latency"] = lat
            snap["batch_p50"] = m.batch_size.quantile(0.5)
        snap["plan_cache"] = planmod.cache_info()
        return snap

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has completed. With
        ``start=False`` this is the dispatcher: groups run inline."""
        deadline = None if timeout is None else _now() + timeout
        if self._thread is None:
            while True:
                with self._cv:
                    if not self._pending_count and not self._inflight:
                        return
                if deadline is not None and _now() > deadline:
                    raise TimeoutError("drain timed out")
                self._dispatch_once(wait_s=0.005)
        with self._cv:
            while self._pending_count or self._inflight:
                left = None if deadline is None else deadline - _now()
                if left is not None and left <= 0:
                    raise TimeoutError("drain timed out")
                self._cv.wait(left if left is not None else 0.1)

    def stop(self, drain: bool = True) -> None:
        """Shut the engine down. ``drain=True`` finishes queued work first;
        ``drain=False`` fails still-queued tickets with
        :class:`ServingError`. Idempotent; ``submit()`` raises afterwards."""
        with self._cv:
            self._stopping = True
            if not drain:
                for q in self._queues.values():
                    for r in q:
                        self._fail(r.ticket, ServingError("engine stopped"))
                self._queues.clear()
                self._pending_count = 0
            self._cv.notify_all()
        if self._thread is not None:
            if drain:
                self.drain()
            self._thread.join(timeout=10.0)
            self._thread = None
        elif drain:
            self.drain()
        self._warm.shutdown(wait=True)

    def __enter__(self) -> "ProjectionEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc[0] is None)

    def project(self, y, levels, radius=1.0, *,
                method: Optional[str] = None):
        """submit + result in one call."""
        return self.result(self.submit(y, levels, radius, method=method))
