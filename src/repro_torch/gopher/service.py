"""GopherService: warm analytic query serving with source-axis batching
(counterpart of ``repro.gopher.service``).

The paper's GoFFish platform is a long-lived cluster service: collections
stay deployed, analytics arrive as *queries*.  ``GopherService`` is that
serving layer for this package — one warm :class:`~repro_torch.gopher
.session.GopherSession` held over a collection, answering "SSSP from vertex v" /
"N-hop around u" / "rank at instance t" requests at interactive latency
under concurrent load.  Three mechanisms make it cheap:

* **Warm staging** — the session is built with a session-lifetime staging
  cache (``staging_cache_bytes``, LRU by byte budget), so an analytic's
  tile batch is materialized and uploaded once; every later query over
  the same (graph, attr, transform, zero, layout) re-stages **zero
  bytes** (``session.last_run_report`` proves it per batch).
* **Source-axis query batching** — concurrent requests to the same
  analytic that differ only in their seed vertex (the registry's
  ``source_axis`` parameter: SSSP's/N-hop's ``source``) coalesce into ONE
  plan whose seed is the list of Q sources; the engine runs them as one
  vectorized (Q, P, Vp) semiring state pass and the service splits the
  leading axis back per request.  Results are bitwise identical to Q
  independent runs (the engine's lane-wise BSP loop stops each
  source at its own fixpoint).
* **Continuous batching** — requests enqueue at any time; the serve loop
  admits everything queued into the next batch at *run boundaries*
  (admission points are between engine passes, not inside a superstep).
  Requests arriving while a batch executes accumulate and ride the next
  one — under load the batch width grows toward ``max_batch_queries``
  with no idle waiting.

Streaming: the service is append-aware.  The serve loop refreshes the
session at BATCH BOUNDARIES only (``GopherSession.refresh`` — the
manifest poll), so every executed batch sees one consistent collection
version — a query racing an append observes pre- or post-append state,
never a mix.  :meth:`GopherService.subscribe` registers a standing
tailing query: each observed append delivers one warm incremental
:class:`~repro_torch.gopher.session.TailUpdate` (``GopherSession.tail``).

Request lifecycle::

      submit("sssp", source=v) ──> queue ──┐  (continuous admission)
                                           v
       serve loop:  drain queue -> group by (analytic, non-source params)
                    -> merge sources -> session.run_many(plans)   (shared
                    staging + one engine pass per group) -> split query
                    axis -> resolve tickets
                                           │
      ticket.wait() <──────────────────────┘  per-request AnalyticResult

Single-threaded execution model: ONE serve-loop thread owns the session
(and therefore the engine and staging cache); arbitrary caller threads
only touch the queue and their own tickets, so no session state is ever
accessed concurrently.  On a CUDA session the loop thread runs on the
session's device and on the CUDA stream that was current on the thread
that started the service (the current device and stream are per thread
in CUDA); the engines' side streams, pinned ring and events are the
session's, whatever thread drives them.  An exception raised on the loop
thread is delivered to the tickets of the batch it hit (``wait()``
re-raises it) and to live subscriptions; the loop goes on serving.

>>> import numpy as np
>>> from repro_torch.core.blocked import build_blocked
>>> from repro_torch.core.graph import GraphTemplate
>>> from repro_torch.gopher import GopherService, GopherSession
>>> tmpl = GraphTemplate(num_vertices=4,
...     src=np.array([0, 1, 2, 0]), dst=np.array([1, 2, 3, 2]))
>>> bg = build_blocked(tmpl, np.array([0, 0, 1, 1]), block_size=2)
>>> sess = GopherSession.from_blocked(
...     bg, weights={"latency": np.ones((2, 4), np.float32)}, device="cpu")
>>> with GopherService(session=sess) as svc:
...     one = svc.query("sssp", source=0)           # single query
...     many = svc.query_many([("sssp", {"source": 0}),
...                            ("sssp", {"source": 1})])  # batched pair
>>> one.output["final"]
array([0., 1., 1., 2.], dtype=float32)
>>> many[1].output["final"]           # row 1 of the (Q, V) batched pass
array([inf,  0.,  1.,  2.], dtype=float32)
>>> bool(np.array_equal(many[0].output["final"], one.output["final"]))
True
>>> svc.report()["served"]
3
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.gopher.registry import get_analytic
from repro_torch.gopher.session import (
    AnalyticResult, GopherSession, TailUpdate, _StagingCache)

# default session-lifetime staging budget for a serving process: enough
# for every stock analytic's staged batch over the bench-scale
# collections while bounding residency on shared hosts
DEFAULT_CACHE_BYTES = 256 << 20

# session.plan() knobs a request may override (everything else in a
# request's kwargs is an analytic parameter)
_PLAN_KNOBS = ("pattern", "merge", "layout", "comm", "staging", "delta",
               "warm")


@dataclass
class QueryTicket:
    """One in-flight request: resolves to an :class:`AnalyticResult`.

    ``wait()`` blocks until the serve loop delivers (re-raising the
    batch's exception if execution failed); ``latency_s`` is
    submit-to-delivery wall time once done."""

    analytic: str
    params: Dict[str, Any]
    plan_kw: Dict[str, Any] = field(default_factory=dict)
    t_submit: float = 0.0
    t_done: Optional[float] = None
    result: Optional[AnalyticResult] = None
    error: Optional[BaseException] = None
    _event: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: Optional[float] = None) -> AnalyticResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query {self.analytic!r} not served within {timeout}s")
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit


@dataclass
class Subscription:
    """One tailing subscription: a standing ``session.tail`` driven by the
    serve loop.

    The serve loop delivers one
    :class:`~repro_torch.gopher.session.TailUpdate` when the subscription
    is registered (the initial full run) and one per observed append (a warm incremental step).  ``callback`` (if
    given) runs ON THE SERVE THREAD — keep it cheap; a raised exception
    is captured into ``error`` and stops further deliveries.  Waiters
    can also poll: ``wait_update(n)`` blocks until ``delivered >= n``."""

    analytic: str
    params: Dict[str, Any]
    plan_kw: Dict[str, Any] = field(default_factory=dict)
    callback: Optional[Any] = None
    delivered: int = 0
    last: Optional[TailUpdate] = None
    error: Optional[BaseException] = None
    _cv: threading.Condition = field(default_factory=threading.Condition)
    _cancelled: bool = False
    _pending_initial: bool = True

    def cancel(self) -> None:
        """Stop future deliveries (the held ``last`` update stays)."""
        with self._cv:
            self._cancelled = True
            self._cv.notify_all()

    def wait_update(self, count: int = 1,
                    timeout: Optional[float] = None) -> TailUpdate:
        """Block until at least ``count`` updates were delivered; returns
        the latest (re-raising a captured callback/execution error)."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self.delivered >= count or self.error is not None,
                timeout)
            if self.error is not None:
                raise self.error
            if not ok:
                raise TimeoutError(
                    f"subscription {self.analytic!r}: update {count} not "
                    f"delivered within {timeout}s")
            assert self.last is not None
            return self.last


class GopherService:
    """Warm analytic query service over one collection (module docstring).

    ``source`` is anything :class:`GopherSession` accepts (a
    ``GoFSStore``, a ``TimeSeriesGraph``), or pass a pre-built
    ``session=``; a session without a session-lifetime staging cache is
    promoted to one (``staging_cache_bytes``).  ``max_batch_queries``
    caps how many requests one admission drains into a single
    ``run_many`` batch (source-merged groups are chunked to it as well).
    ``auto_refresh=False`` pins the service to the collection version it
    opened on: the loop never polls the store, so no append is observed
    and no subscription takes a tail step.
    """

    def __init__(
        self,
        source=None,
        *,
        session: Optional[GopherSession] = None,
        staging_cache_bytes: float = DEFAULT_CACHE_BYTES,
        max_batch_queries: int = 32,
        poll_interval: float = 0.05,
        auto_refresh: bool = True,
        **session_kw,
    ):
        if session is None:
            assert source is not None, \
                "GopherService needs a data source or a session"
            session = GopherSession(
                source, staging_cache_bytes=staging_cache_bytes,
                **session_kw)
        else:
            assert source is None and not session_kw, \
                "pass either session= or a source (+ session kwargs)"
            if session._staging_cache is None:
                # serving without residency would re-stage every query
                session._staging_cache = _StagingCache(
                    byte_budget=staging_cache_bytes)
        self.session = session
        self.max_batch_queries = int(max_batch_queries)
        # streaming: the serve loop polls the collection manifest when
        # idle (subscriptions registered) and refreshes the session at
        # BATCH BOUNDARIES only — the loop owns the session, so every
        # executed batch sees one consistent collection version (queries
        # racing an append observe pre- or post-append state, never a mix)
        self.poll_interval = float(poll_interval)
        self.auto_refresh = bool(auto_refresh)
        self._queue: "deque[QueryTicket]" = deque()
        self._cond = threading.Condition()
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._subs: List[Subscription] = []
        self._appends_observed = 0
        self._latencies: "deque[float]" = deque(maxlen=4096)
        self._served = 0
        self._batches = 0
        self._widest_batch = 0
        self._t_started: Optional[float] = None
        self._stream = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "GopherService":
        """Spawn the serve loop (idempotent).  The loop thread owns the
        session; it exits after draining the queue once ``stop()`` is
        called."""
        if self._thread is None or not self._thread.is_alive():
            self._stopping = False
            self._t_started = time.perf_counter()
            dev = self.session.device
            # the caller's current stream on the session's device: the
            # loop thread computes on it (streams are per thread in CUDA)
            self._stream = (torch.cuda.current_stream(dev)
                            if dev.type == "cuda" else None)
            self._thread = threading.Thread(
                target=self._serve_loop, name="gopher-serve", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Graceful shutdown: serve everything already queued, then stop."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "GopherService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- requests
    def _make_ticket(self, analytic: str, plan_kw: Optional[Dict[str, Any]],
                     params: Dict[str, Any]) -> QueryTicket:
        """Validate eagerly — unknown analytic / bad parameters raise on
        the CALLER's thread, not in the serve loop."""
        a = get_analytic(analytic)  # raises on unknown name
        a.resolve_params(params)  # raises on unknown/missing params
        plan_kw = dict(plan_kw or {})
        unknown = sorted(set(plan_kw) - set(_PLAN_KNOBS))
        if unknown:
            raise TypeError(f"unknown plan knob(s) {unknown}; "
                            f"valid: {list(_PLAN_KNOBS)}")
        return QueryTicket(analytic=analytic, params=dict(params),
                           plan_kw=plan_kw, t_submit=time.perf_counter())

    def _enqueue(self, tickets: List[QueryTicket]) -> None:
        if self._thread is None or not self._thread.is_alive():
            self.start()
        with self._cond:
            assert not self._stopping, "service is stopping"
            self._queue.extend(tickets)
            self._cond.notify_all()

    def submit(self, analytic: str, *, plan_kw: Optional[Dict[str, Any]]
               = None, **params) -> QueryTicket:
        """Enqueue one query; returns immediately with a ticket.

        ``params`` are the analytic's parameters (``source=...``);
        ``plan_kw`` optionally overrides plan knobs (``layout=...``)."""
        t = self._make_ticket(analytic, plan_kw, params)
        self._enqueue([t])
        return t

    def submit_many(
        self, requests: Sequence[Tuple[str, Dict[str, Any]]],
    ) -> List[QueryTicket]:
        """Enqueue ``[(analytic, params), ...]`` atomically — one lock
        acquisition, one serve-loop wakeup — so an idle service admits
        them as ONE batch (stable source-axis width; per-ticket submits
        can land across two admissions)."""
        tickets = [self._make_ticket(name, None, params)
                   for name, params in requests]
        self._enqueue(tickets)
        return tickets

    def query(self, analytic: str, *, timeout: Optional[float] = None,
              plan_kw: Optional[Dict[str, Any]] = None,
              **params) -> AnalyticResult:
        """Submit one query and wait for its result."""
        return self.submit(analytic, plan_kw=plan_kw, **params).wait(timeout)

    def query_many(
        self, requests: Sequence[Tuple[str, Dict[str, Any]]],
        *, timeout: Optional[float] = None,
    ) -> List[AnalyticResult]:
        """Submit ``[(analytic, params), ...]`` concurrently and wait for
        all — the natural shape for source-axis batching: N same-analytic
        requests land in one admission and run as one engine pass."""
        return [t.wait(timeout) for t in self.submit_many(requests)]

    def prestage(self, analytic: str, **params) -> None:
        """Materialize an analytic's main staged batch into the warm cache
        ahead of traffic (first-query latency moves here)."""
        plan = self.session.plan(analytic, **params)
        a = get_analytic(analytic)
        cache = self.session._staging_cache
        assert cache is not None
        self.session._staged(cache, a, plan.layout.value,
                             delta=bool(plan.delta.value))

    def subscribe(self, analytic: str, *, callback=None,
                  plan_kw: Optional[Dict[str, Any]] = None,
                  **params) -> Subscription:
        """Register a tailing subscription (live query over a growing
        collection).

        The serve loop delivers an initial full result, then one warm
        incremental :class:`~repro_torch.gopher.session.TailUpdate` per
        observed append (``GopherSession.tail`` semantics — exact; see
        its docstring for the seeding rules).  ``callback(update)`` runs
        on the serve thread; omit it and poll
        :meth:`Subscription.wait_update` instead."""
        a = get_analytic(analytic)  # raises on unknown name
        a.resolve_params(params)
        plan_kw = dict(plan_kw or {})
        unknown = sorted(set(plan_kw) - set(_PLAN_KNOBS))
        if unknown:
            raise TypeError(f"unknown plan knob(s) {unknown}; "
                            f"valid: {list(_PLAN_KNOBS)}")
        sub = Subscription(analytic=analytic, params=dict(params),
                           plan_kw=plan_kw, callback=callback)
        if self._thread is None or not self._thread.is_alive():
            self.start()
        with self._cond:
            assert not self._stopping, "service is stopping"
            self._subs.append(sub)
            self._cond.notify_all()
        return sub

    # -------------------------------------------------------------- serving
    def _serve_loop(self) -> None:
        with self._on_device():
            while True:
                batch = self._admit()
                if batch is None:
                    return
                try:
                    self._refresh_and_notify()
                except BaseException as e:  # a failed refresh: deliver it
                    self._fail(batch, e)
                    continue
                if batch:
                    self._execute(batch)

    def _on_device(self):
        """The session's device and the starting thread's stream, entered
        on the loop thread (a CPU session needs neither)."""
        if self._stream is None:
            return contextlib.nullcontext()
        scope = contextlib.ExitStack()
        scope.enter_context(torch.cuda.device(self.session.device))
        scope.enter_context(torch.cuda.stream(self._stream))
        return scope

    def _fail(self, batch: List[QueryTicket], e: BaseException) -> None:
        """Deliver a loop-thread failure to the batch's tickets and to every
        live subscription."""
        now = time.perf_counter()
        for t in batch:
            t.error, t.t_done = e, now
            t._event.set()
        with self._cond:
            subs = [s for s in self._subs if not s._cancelled]
        for sub in subs:
            with sub._cv:
                sub.error = e
                sub._cv.notify_all()

    def _admit(self) -> Optional[List[QueryTicket]]:
        """Block until work, a poll tick, or shutdown; drain up to
        ``max_batch_queries`` tickets.  Everything queued while the
        previous batch executed is admitted together — continuous
        batching without a timed window.  With subscriptions registered
        the wait times out every ``poll_interval`` seconds so an idle
        service still observes appends; a tick returns an empty batch
        (refresh + notify only).  ``None`` means stopping and drained."""
        with self._cond:
            while not self._queue and not self._stopping:
                if any(s._pending_initial and not s._cancelled
                       for s in self._subs):
                    break  # run the initial tail without waiting
                timeout = self.poll_interval if self._subs else None
                if not self._cond.wait(timeout=timeout):
                    break  # poll tick
            if self._stopping and not self._queue:
                return None
            batch = []
            while self._queue and len(batch) < self.max_batch_queries:
                batch.append(self._queue.popleft())
            return batch

    def _refresh_and_notify(self) -> None:
        """Batch-boundary streaming hook (serve thread only): observe an
        append, then drive every live subscription one tail step.  Runs
        between batches — never inside one — so each batch executes
        against a single collection version."""
        if not self.auto_refresh:
            return
        changed = self.session.refresh()
        if changed:
            self._appends_observed += 1
        with self._cond:
            subs = [s for s in self._subs if not s._cancelled]
            self._subs = subs
        for sub in subs:
            if sub.error is not None:
                continue
            if not (changed or sub._pending_initial):
                continue
            try:
                update = self.session.tail(
                    sub.analytic, refresh=False,
                    **sub.plan_kw, **sub.params)
            except BaseException as e:
                with sub._cv:
                    sub.error = e
                    sub._cv.notify_all()
                continue
            if update.mode == "noop" and not sub._pending_initial:
                continue
            sub._pending_initial = False
            with sub._cv:
                sub.delivered += 1
                sub.last = update
                sub._cv.notify_all()
            if sub.callback is not None:
                try:
                    sub.callback(update)
                except BaseException as e:
                    with sub._cv:
                        sub.error = e
                        sub._cv.notify_all()

    def _group_key(self, t: QueryTicket, axis: str) -> Tuple:
        rest = tuple(sorted(
            (k, _freeze(v)) for k, v in t.params.items() if k != axis))
        return (t.analytic, rest, tuple(sorted(t.plan_kw.items())))

    def _execute(self, batch: List[QueryTicket]) -> None:
        """Group the admitted tickets, run them as one ``run_many`` pass
        (shared staging across groups), split the query axis, deliver."""
        # ---- coalesce: same analytic + same non-source params -> one plan
        merged: Dict[Tuple, List[QueryTicket]] = {}
        solo: List[QueryTicket] = []
        for t in batch:
            a = get_analytic(t.analytic)
            axis = a.source_axis
            if axis is not None and np.isscalar(t.params.get(axis)):
                merged.setdefault(self._group_key(t, axis), []).append(t)
            else:
                solo.append(t)
        plans = []
        deliveries: List[Tuple[List[QueryTicket], Optional[str]]] = []
        try:
            for key, group in merged.items():
                axis = get_analytic(group[0].analytic).source_axis
                for i in range(0, len(group), self.max_batch_queries):
                    chunk = group[i:i + self.max_batch_queries]
                    if len(chunk) == 1:
                        t = chunk[0]
                        plans.append(self.session.plan(
                            t.analytic, **t.plan_kw, **t.params))
                        deliveries.append((chunk, None))
                        continue
                    params = dict(chunk[0].params)
                    params[axis] = [t.params[axis] for t in chunk]
                    plans.append(self.session.plan(
                        chunk[0].analytic, **chunk[0].plan_kw, **params))
                    deliveries.append((chunk, axis))
            for t in solo:
                plans.append(self.session.plan(
                    t.analytic, **t.plan_kw, **t.params))
                deliveries.append(([t], None))
            results = self.session.run_many(plans)
        except BaseException as e:  # deliver the failure to every waiter
            now = time.perf_counter()
            for t in batch:
                t.error, t.t_done = e, now
                t._event.set()
            return
        now = time.perf_counter()
        self._batches += 1
        self._widest_batch = max(self._widest_batch, len(batch))
        for res, (tickets, axis) in zip(results, deliveries):
            if axis is None:
                outs = [res]
            else:
                outs = [_slice_query(res, q, len(tickets))
                        for q in range(len(tickets))]
            for t, r in zip(tickets, outs):
                t.result, t.t_done = r, now
                self._latencies.append(now - t.t_submit)
                self._served += 1
                t._event.set()

    # ------------------------------------------------------------ reporting
    def report(self) -> Dict[str, Any]:
        """Serving stats: latency percentiles over the last requests,
        batch shape, and the warm cache's staging economy."""
        lats = np.asarray(self._latencies, np.float64)
        elapsed = (time.perf_counter() - self._t_started) \
            if self._t_started is not None else 0.0
        return {
            "served": self._served,
            "batches": self._batches,
            "widest_batch": self._widest_batch,
            "p50_ms": float(np.percentile(lats, 50) * 1e3) if lats.size
            else None,
            "p95_ms": float(np.percentile(lats, 95) * 1e3) if lats.size
            else None,
            "throughput_qps": self._served / elapsed if elapsed > 0
            else 0.0,
            "staging_cache": self.session.staging_cache_stats(),
            "subscriptions": len(self._subs),
            "appends_observed": self._appends_observed,
        }


def _freeze(v: Any) -> Any:
    """Hashable view of a request parameter (group keys): an array by its
    values and shape, NumPy scalars as Python numbers, so requests whose
    parameters hold equal values merge whatever their dtypes.

    >>> _freeze(np.array([0., 10.])) == _freeze(np.array([0, 10]))
    True
    >>> _freeze((np.int64(3), [np.float32(0.5)]))
    (3, (0.5,))
    """
    if isinstance(v, np.ndarray):
        return ("ndarray",) + tuple(v.reshape(-1).tolist()) + (v.shape,)
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def _slice_query(res: AnalyticResult, q: int, n: int) -> AnalyticResult:
    """Per-request view of a source-batched result: output arrays whose
    leading axis is the query axis are sliced at ``q``; the plan and the
    (shared) engine result ride along for provenance."""
    out: Dict[str, Any] = {}
    for k, v in res.output.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
            out[k] = v[q]
        else:
            out[k] = v
    return AnalyticResult(plan=res.plan, engine=res.engine, output=out)
