"""Pipelined asynchronous serving — overlapped launch and finish with
deadline flushing: the counterpart of ``bibfs_tpu/serve/pipeline.py``.

:class:`~bibfs_tpu_torch.serve.engine.QueryEngine` is synchronous: every
``flush()`` runs the device search, the copy to the host, result
materialization and forest banking before the next batch can start.
:class:`PipelinedQueryEngine` keeps both stages busy at once:

- **background flusher** — ``submit()`` never blocks on solving: it
  appends to a lock-guarded queue and returns a :class:`QueryTicket` (a
  future; ``wait()`` blocks, ``result`` lands asynchronously). A
  dedicated flusher thread pops batches and launches them.
- **double-buffered device flushes** — the flusher runs the device
  route's ``launch`` (the batched search on the card, its finish hook and
  the one copy of the real queries' rows to the host) and hands the
  batch to a single finish worker, which materializes the results, banks
  the forests and resolves the tickets from those host arrays. While
  batch k finishes there, batch k+1 runs on the card; a bounded
  in-flight window (``max_inflight``, default 2) keeps the flusher from
  running unboundedly ahead. The finish worker never touches a tensor
  on the card: every CUDA call of a batch happens on the flusher thread,
  on the engine device's current stream, so no copy queues behind the
  next batch's kernels on a stream another thread shares. The blocked
  tile rung (``blocked=``) rides the same seam ahead of the device rung.
- **deadline-based flushing** — ``max_wait_ms`` is a latency SLO: a
  sub-crossover queue flushes when its OLDEST query has waited that
  long, instead of waiting for depth (the synchronous engine's
  behavior).
- **two-stage host route** — below the crossover (and on the CPU,
  unless ``device_batches=True``) the flusher solves the whole batch
  through the threaded native C batch and the finish worker banks and
  resolves, so batch k+1's solve overlaps batch k's resolution.
- **instrumentation** — a latency histogram (p50/p95/p99), queue-depth
  and flush-cause counters, per-route stage sums (``stats()["stages"]``)
  and a stage-concurrency clock whose ``overlap`` block reports how much
  of the busy time two or more stages ran at once.

**No fallback hides the card.** On a CUDA engine a launch or finish
failure degrades to the host only when it is an injected fault
(:class:`~bibfs_tpu_torch.serve.faults.InjectedFault`, the chaos seam):
any other failure fails the batch's tickets with a ``kind='internal'``
:class:`~bibfs_tpu_torch.serve.resilience.QueryError`, is not retried,
does not feed the breaker, and frees a half-open probe claim. An engine
on the CPU keeps the JAX package's ladder (retry, then degrade at launch;
re-solve on the host at finish).

**Graph store and oracle.** On a store-backed engine a popped batch is
grouped per graph, each group bound to the snapshot it resolves at launch
(the finish job decodes and banks on that snapshot); a graph with pending
updates answers its group exactly through the overlay route on the
flusher. The oracle is consulted at submit time, before the cache; a
consult that yields bounds arms the serial host rung's cutoff.

Trace contexts and the flight recorder come with a later slice of the
port (ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor

from bibfs_tpu_torch.obs.metrics import REGISTRY, LogHistogram, MetricBank
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.serve.engine import QueryEngine, _Pending
from bibfs_tpu_torch.serve.resilience import (
    HealthMonitor,
    QueryError,
    to_query_error,
)
from bibfs_tpu_torch.solvers.api import BFSResult
from bibfs_tpu_torch.utils.annotations import guarded_by

# the latency histogram is the general observability type; the name stays
# importable from here as in the JAX package
LatencyHistogram = LogHistogram


def _pipe_counter_bank(label: str) -> MetricBank:
    """The pipelined engine's registry cells under the JAX package's
    family names: flush causes as one labeled counter family, watermarks
    as gauges."""
    flushes = REGISTRY.counter(
        "bibfs_flushes_total", "Background flusher batches popped",
        ("engine",),
    )
    cause = REGISTRY.counter(
        "bibfs_flush_cause_total",
        "Flushes by trigger (depth/deadline/drain)",
        ("engine", "cause"),
    )
    blocked = REGISTRY.counter(
        "bibfs_submit_blocked_total",
        "Admissions throttled by the max_queue bound",
        ("engine",),
    )
    depth_max = REGISTRY.gauge(
        "bibfs_serve_queue_depth_max", "Deepest queue seen", ("engine",)
    )
    wait_max = REGISTRY.gauge(
        "bibfs_queue_wait_max_ms",
        "Worst submit->pop queue wait (the deadline-compliance witness)",
        ("engine",),
    )
    service_max = REGISTRY.gauge(
        "bibfs_batch_service_max_ms",
        "Worst launch->resolved batch service time",
        ("engine",),
    )
    return MetricBank({
        "flushes": flushes.labels(engine=label),
        "depth_flushes": cause.labels(engine=label, cause="depth"),
        "deadline_flushes": cause.labels(engine=label, cause="deadline"),
        "drain_flushes": cause.labels(engine=label, cause="drain"),
        "max_queue_depth": depth_max.labels(engine=label),
        "queue_wait_max_ms": wait_max.labels(engine=label),
        "batch_service_max_ms": service_max.labels(engine=label),
        "submit_blocked": blocked.labels(engine=label),
    })


class _StageClock:
    """Time-weighted pipeline-stage concurrency accounting: every stage
    (a launch on the flusher, a finish job) brackets itself with
    ``enter()``/``exit()``, and the clock sums wall time at each
    concurrency level. ``overlap_s`` (time at level >= 2) over ``busy_s``
    says whether launch and finish really overlapped."""

    def __init__(self):
        self._lock = threading.Lock()
        self._level = 0
        self._t_mark = None
        self._at_level: dict[int, float] = {}
        self._t_first = None
        self._t_last = None

    def _shift(self, delta: int) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            if self._level > 0 and self._t_mark is not None:
                self._at_level[self._level] = (
                    self._at_level.get(self._level, 0.0) + now - self._t_mark
                )
            self._t_mark = now
            self._t_last = now
            self._level += delta

    def enter(self) -> None:
        self._shift(+1)

    def exit(self) -> None:
        self._shift(-1)

    def stats(self) -> dict:
        with self._lock:
            busy = sum(self._at_level.values())
            overlap = sum(
                v for lvl, v in self._at_level.items() if lvl >= 2
            )
            wall = (
                (self._t_last - self._t_first)
                if self._t_first is not None else 0.0
            )
            return {
                "busy_s": round(busy, 4),
                "overlap_s": round(overlap, 4),
                "wall_s": round(wall, 4),
                "occupancy": round(overlap / busy, 4) if busy > 0 else 0.0,
                "max_concurrency": max(self._at_level, default=0),
            }


class QueryTicket(_Pending):
    """A submitted query's future: ``result`` lands when the background
    pipeline resolves it; ``wait()`` blocks for it. Waiters park on the
    engine's single condition variable, which resolution broadcasts once
    per batch (no per-ticket event)."""

    __slots__ = ("t_submit", "t_launch", "t_done", "_engine")

    def __init__(self, src: int, dst: int, engine=None,
                 graph: str | None = None):
        super().__init__(src, dst, graph)
        self.t_submit = time.perf_counter()
        self.t_launch: float | None = None  # stamped at batch pop
        self.t_done: float | None = None
        self._engine = engine

    def done(self) -> bool:
        return self.result is not None or self.error is not None

    def cancel(self) -> bool:
        """Abandon this ticket: if it is still QUEUED it leaves the
        engine's queue and batch accounting (a later ``flush()`` or
        ``close()`` never waits on it) and fails with a
        ``kind='timeout'`` :class:`QueryError`. Returns True if this call
        cancelled it; False if it already resolved or failed, or was
        popped into a launched batch (which resolves normally)."""
        eng = self._engine
        if eng is None or self.done():
            return False
        with eng._cv:
            if self.done():
                return False
            try:
                eng._queue.remove(self)
            except ValueError:
                return False  # already launched; it will resolve
            eng._outstanding -= 1
            eng._g_queue_depth.set(len(eng._queue))
            self.t_done = time.perf_counter()
            self.error = QueryError(
                "cancelled while queued", kind="timeout",
                query=(self.src, self.dst),
            )
            eng._count_error(self.error)
            eng._cv.notify_all()
        return True

    def wait(self, timeout: float | None = None, *,
             cancel_on_timeout: bool = False) -> BFSResult:
        """Block until the pipeline resolves this query and return its
        :class:`BFSResult`; re-raises a pipeline-side failure, raises
        ``TimeoutError`` once ``timeout`` seconds pass
        (``cancel_on_timeout=True`` also :meth:`cancel` s the ticket)."""
        if self.result is None and self.error is None:
            eng = self._engine
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
            with eng._cv:
                while self.result is None and self.error is None:
                    remaining = 0.5
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            if (cancel_on_timeout and not self.cancel()
                                    and self.done()):
                                # resolved between the deadline and the
                                # cancel: deliver it
                                break
                            raise TimeoutError(
                                f"query ({self.src}, {self.dst}) "
                                f"unresolved after {timeout}s"
                            )
                    eng._cv.wait(remaining)
        if self.error is not None:
            raise self.error
        return self.result


# _lock and _cv alias ONE RLock (the Condition wraps it): every queue and
# accounting mutation holds it, whichever name the call site uses
@guarded_by(("_lock", "_cv"), "_queue", "_outstanding", "_flush_req",
            "_closed", "_errors")
class PipelinedQueryEngine(QueryEngine):
    """Asynchronous, deadline-flushing :class:`QueryEngine` (module
    docstring). Parameters on top of the base engine's:

    max_wait_ms : latency SLO — the longest a queued query waits for
        batch-mates before the flusher flushes the queue (default 5.0;
        None restores depth-only flushing).
    max_inflight : launched-but-unfinished batch window (default 2:
        one batch finishing while the next runs on the card).
    max_queue : admission control — ``submit()`` blocks once this many
        queries are queued. Default ``max(max_batch, 4 *
        flush_threshold)``.

    Submissions are thread-safe; :meth:`close` (or the context manager)
    drains and joins the flusher and the finish worker.
    """

    _OBS_PREFIX = "pipe"

    def __init__(
        self,
        n: int | None = None,
        edges=None,
        *,
        max_wait_ms: float | None = 5.0,
        max_inflight: int = 2,
        max_queue: int | None = None,
        **kwargs,
    ):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        super().__init__(n, edges, **kwargs)
        self.max_wait_ms = max_wait_ms
        self._wait_s = (
            None if max_wait_ms is None else max(float(max_wait_ms), 0.0) / 1e3
        )
        if max_queue is None:
            max_queue = max(self.max_batch, 4 * self.flush_threshold)
        self.max_queue = int(max_queue)
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque[QueryTicket] = deque()
        self._outstanding = 0  # queued + launched-but-unresolved tickets
        self._flush_req = False
        self._closed = False
        self._inflight = threading.BoundedSemaphore(int(max_inflight))
        self.latency = REGISTRY.histogram(
            "bibfs_query_latency_seconds",
            "Per-query submit-to-resolve latency",
            ("engine",),
        ).labels(engine=self.obs_label)
        self._g_queue_depth = REGISTRY.gauge(
            "bibfs_serve_queue_depth", "Queries currently queued",
            ("engine",),
        ).labels(engine=self.obs_label)
        self.stages = _StageClock()
        self.pipe_counters = _pipe_counter_bank(self.obs_label)
        self._errors: list[str] = []
        # the health monitor again, with the queue-pressure input the base
        # constructor could not have: a queue at >= 90% of the admission
        # bound reads as degraded
        self.health = HealthMonitor(
            breaker=self._breaker,
            window_s=self._health_window_s,
            queue_depth=lambda: len(self._queue),
            max_queue=self.max_queue,
            gauge=self._res_cells.health_gauge,
        )
        self.health.set_ready()
        # host solves share the per-query native solver's scratch, which
        # is not thread-safe: the flusher's host batches and the finish
        # worker's recovery take turns (uncontended without failures)
        self._host_solve_lock = threading.RLock()
        self._finish_pool = ThreadPoolExecutor(
            1, thread_name_prefix="bibfs-finish"
        )
        self._flusher = threading.Thread(
            target=self._flusher_main, name="bibfs-flusher", daemon=True
        )
        self._flusher.start()

    # ---- submission --------------------------------------------------
    def submit(self, src: int, dst: int, graph: str | None = None
               ) -> QueryTicket:
        """Queue one query WITHOUT blocking on any solve (``graph`` names a
        store graph on a store-backed engine). Trivial queries, oracle
        answers and cache hits (on an idle engine) resolve before
        returning; everything else resolves when the flusher's batch lands
        (depth, deadline or drain, whichever comes first)."""
        self._check_open((int(src), int(dst)))
        src, dst = int(src), int(dst)
        name, rt = self._resolve_graph(graph)
        if not (0 <= src < rt.n and 0 <= dst < rt.n):
            raise ValueError(f"src/dst out of range for n={rt.n}")
        t = QueryTicket(src, dst, self, name)
        if src == dst:
            with self._lock:
                if self._closed:
                    raise RuntimeError("engine is closed")
                self._c_queries.inc()
                self._c_trivial.inc()
            self._finish_ticket(t, BFSResult(True, 0, [src], src, 0.0, 0, 0))
            self.latency.record(t.t_done - t.t_submit)
            return t
        # the oracle answers at submit time, before the cache and the
        # overlay (a store's oracle describes the current live graph)
        if self._consult_oracle(t, name):
            with self._lock:
                if self._closed:
                    raise RuntimeError("engine is closed")
                self._c_queries.inc()
                self._c_oracle.inc()
            self._finish_ticket(t, t.result)
            self.latency.record(t.t_done - t.t_submit)
            return t
        if not self._queue and self._overlay_pending(name) is None:
            # idle fast path: a cache hit answers inline. Under load the
            # lookup moves to the flusher (_serve_cached, one pass per
            # batch), which also sees results that land after the submit.
            # A graph with pending updates skips the cache; the runtime is
            # re-resolved after the overlay read (the sync submit's order)
            rt = self._graph_rt(name)
            hit = self.dist_cache.lookup(rt.graph_id, src, dst)
            if hit is not None:
                found, hops, path = hit
                with self._lock:
                    if self._closed:
                        raise RuntimeError("engine is closed")
                    self._c_queries.inc()
                    self._c_cache_served.inc()
                self._finish_ticket(t, BFSResult(
                    found, hops if found else None, path if found else None,
                    None, 0.0, 0, 0,
                ))
                self.latency.record(t.t_done - t.t_submit)
                return t
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed")
            if len(self._queue) >= self.max_queue:
                # admission control: block the producer until the flusher
                # makes room
                self.pipe_counters["submit_blocked"] += 1
                while len(self._queue) >= self.max_queue:
                    if not self._flusher.is_alive():
                        raise RuntimeError(
                            "pipeline flusher died: "
                            + "; ".join(self._errors)
                        )
                    self._cv.wait(timeout=0.1)
                    if self._closed:
                        raise RuntimeError("engine is closed")
            self._c_queries.inc()
            self._queue.append(t)
            self._outstanding += 1
            depth = len(self._queue)
            self._g_queue_depth.set(depth)
            self.pipe_counters.cell("max_queue_depth").set_max(depth)
            # wake the flusher only when this submit can change its
            # decision: arming the deadline (empty -> 1), reaching the
            # depth trigger, or filling the admission queue
            if (depth == 1 or depth == self.flush_threshold
                    or depth >= self.max_queue):
                self._cv.notify_all()
        return t

    def query(self, src: int, dst: int, graph: str | None = None
              ) -> BFSResult:
        """Submit one query and block for its result (the deadline or the
        queue depth decides when it flushes)."""
        return self.submit(src, dst, graph).wait()

    def _check_open(self, query) -> None:
        if self._draining:
            if self._closed:
                raise RuntimeError("engine is closed")
            raise QueryError(
                "engine is draining", kind="capacity", query=query,
            )

    def _kind_ticket(self, src: int, dst: int, name) -> QueryTicket:
        t = QueryTicket(src, dst, self, name)
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._c_queries.inc()
        return t

    def _take_kind(self, t: QueryTicket, overlay, hit) -> QueryTicket:
        """The typed submit (:meth:`QueryEngine.submit_query`), pipelined:
        a point-to-point query rides the background flusher; the other
        kinds resolve ON THE SUBMITTING THREAD through the same kind-route
        machinery (breakers, retries, fallbacks, the kind cache), under the
        host-solve lock, and return a ticket that is already done — the
        pipeline stays for the batch-shaped work it overlaps."""
        if hit is None:
            rt = self._pin_rt(t.graph)
            # the host-solve lock also covers the kind solves: their
            # fallbacks share the runtime's serial machinery with the
            # flusher's host rung
            with self._host_solve_lock, self._bound(rt):
                self._flush_taxonomy(t.graph, [t], overlay)
            t.t_done = time.perf_counter()
        else:
            self._finish_ticket(t, hit)
        self.latency.record(t.t_done - t.t_submit)
        with self._cv:
            self._cv.notify_all()  # wake any wait() already parked
        return t

    def query_one(self, q, graph: str | None = None):
        """Submit one typed query and block for its result."""
        return self.submit_query(q, graph).wait()

    def query_many(self, pairs, *, graph: str | None = None,
                   return_errors: bool = False) -> list:
        """Submit a whole query list, drain, and return the results
        (``return_errors=True``: the synchronous engine's partial-failure
        mode)."""
        tickets = self._submit_collect(pairs, return_errors, graph)
        if not tickets:
            return []
        if any(isinstance(t, QueryTicket) for t in tickets):
            self.flush()
        out = []
        for t in tickets:
            if isinstance(t, QueryError):
                out.append(t)
                continue
            try:
                out.append(t.wait(timeout=60.0))
            except Exception as e:
                if not return_errors:
                    raise
                out.append(to_query_error(e, (t.src, t.dst)))
        return out

    # ---- flushing ----------------------------------------------------
    def flush(self, timeout: float | None = None) -> None:
        """Make the flusher drain the queue NOW, then block until every
        query submitted before resolves. ``timeout`` bounds the wait: on
        expiry a ``TimeoutError`` reports how many tickets are still
        outstanding."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        with self._cv:
            self._flush_req = True
            self._cv.notify_all()
            while self._outstanding > 0:
                if not self._flusher.is_alive():
                    raise RuntimeError(
                        "pipeline flusher died: " + "; ".join(self._errors)
                    )
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    raise TimeoutError(
                        f"flush timed out after {timeout}s with "
                        f"{self._outstanding} tickets outstanding"
                    )
                self._cv.wait(timeout=0.1)

    def kill(self) -> None:
        """Crash-semantics teardown: tickets still QUEUED fail NOW with a
        ``kind='internal'`` :class:`QueryError`; batches already launched
        still resolve through their finish jobs. Then the workers are
        joined and the snapshot pin drops. :meth:`close` drains the whole
        queue first."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._draining = True
            self.health.set_draining()
            leftovers = [t for t in self._queue if not t.done()]
            self._queue.clear()
            for t in leftovers:
                self._fail_ticket(t, QueryError(
                    "replica killed: engine torn down with queries "
                    "queued", kind="internal", query=(t.src, t.dst),
                ))
            self._outstanding -= len(leftovers)
            self._g_queue_depth.set(0)
            self._cv.notify_all()
        self._flusher.join(timeout=60.0)
        self._finish_pool.shutdown(wait=True)
        self._release_runtimes()

    def close(self) -> None:
        """Drain the queue, stop the flusher and join every worker.
        Idempotent; the engine refuses submissions afterwards (and health
        reads ``draining`` from the first moment). Anything left queued
        after the workers stop (a dead flusher) fails with ``engine is
        closed`` rather than stranding its waiters."""
        with self._cv:
            if self._closed:
                already = True
            else:
                already = False
                self._closed = True
                self.health.set_draining()
                self._cv.notify_all()
        self._flusher.join(timeout=60.0)
        if not already:
            self._finish_pool.shutdown(wait=True)
            with self._cv:
                leftovers = [t for t in self._queue if not t.done()]
                self._queue.clear()
                for t in leftovers:
                    # kind=capacity: a routine shutdown is not an internal
                    # failure
                    self._fail_ticket(t, QueryError(
                        "engine is closed", kind="capacity",
                        query=(t.src, t.dst),
                    ))
                self._outstanding -= len(leftovers)
                self._g_queue_depth.set(0)
                self._cv.notify_all()
            self._release_runtimes()

    # ---- the background flusher --------------------------------------
    def _flush_reason_locked(self):
        if not self._queue:
            self._flush_req = False  # nothing left to force
            return "exit" if self._closed else None
        if len(self._queue) >= self.flush_threshold:
            return "depth"
        if len(self._queue) >= self.max_queue:
            # a full admission queue is itself pressure: with depth-only
            # flushing and max_queue < flush_threshold a producer blocked
            # in submit() would otherwise wait forever
            return "depth"
        if self._flush_req or self._closed:
            return "drain"
        if self._wait_s is not None:
            age = time.perf_counter() - self._queue[0].t_submit
            if age >= self._wait_s:
                return "deadline"
        return None

    def _wait_timeout_locked(self):
        if not self._queue or self._wait_s is None:
            return None
        # sleep exactly until the oldest query's deadline
        age = time.perf_counter() - self._queue[0].t_submit
        return max(self._wait_s - age, 0.0)

    def _flusher_main(self):
        while True:
            with self._cv:
                while True:
                    reason = self._flush_reason_locked()
                    if reason is not None:
                        break
                    self._cv.wait(self._wait_timeout_locked())
                if reason == "exit":
                    return
                batch = [
                    self._queue.popleft()
                    for _ in range(min(len(self._queue), self.max_batch))
                ]
                self._g_queue_depth.set(len(self._queue))
                self._cv.notify_all()  # wake producers blocked on max_queue
                now = time.perf_counter()
                for t in batch:
                    t.t_launch = now  # the queue stage ends at the pop
                wait_ms = (now - batch[0].t_submit) * 1e3
                self.pipe_counters.cell("queue_wait_max_ms").set_max(
                    wait_ms)
                self.pipe_counters["flushes"] += 1
                self.pipe_counters[f"{reason}_flushes"] += 1
            try:
                with span("flush", queued=len(batch), cause=reason):
                    self._launch(batch)
            except Exception as e:  # never strand a waiter
                self._record_error(e)
                self._fail_batch(batch, e)

    def _launch(self, batch: list[QueryTicket]) -> None:
        """Launch one popped batch: on a store-backed engine, one group per
        graph, each failing alone (a raise from group k fails only group
        k's tickets; earlier groups are already with the finish worker)."""
        if self._store is None:
            self._launch_group(None, batch)
            return
        groups: OrderedDict[str, list[QueryTicket]] = OrderedDict()
        for t in batch:
            groups.setdefault(t.graph, []).append(t)
        for name, group in groups.items():
            try:
                self._launch_group(name, group)
            except Exception as e:
                self._record_error(e)
                self._fail_batch(group, e)

    def _launch_group(self, name, batch: list[QueryTicket]) -> None:
        """Dedupe exact repeats, read the overlay, pin the snapshot (the
        sync engine's order, ``QueryEngine._flush_graph``), answer an
        overlaid graph exactly or cache hits, then walk the ladder (in the
        adaptive policy's order when the engine runs adaptive): each
        eligible dispatch rung whose breaker admits the batch launches here
        and finishes on the worker; the terminal host rung solves here
        behind the bisection isolator."""
        unique: OrderedDict[tuple[int, int], list[QueryTicket]] = (
            OrderedDict()
        )
        for t in batch:
            unique.setdefault((t.src, t.dst), []).append(t)
        overlay = self._overlay_pending(name)
        rt = self._pin_rt(name)
        with self._bound(rt):
            if overlay is not None:
                self._launch_overlay(overlay, unique)
                return
            pairs = self._serve_cached(unique)
            if not pairs:
                return
            ladder = self._ladder_for(rt, pairs)
            for i, rung in enumerate(ladder):
                if rung == "host":
                    break
                route = self.routes[rung]
                if not route.eligible(rt, pairs):
                    if rung == "mesh":
                        self._note_crossover()
                    continue
                if route.breaker is None or route.breaker.allow():
                    if self._launch_dispatch(route, rt, pairs, unique):
                        return
                self._note_fallback(rung,
                                    self._next_rung(i, rt, pairs, ladder))
            self._launch_host(rt, pairs, unique)

    def _launch_overlay(self, overlay, unique) -> None:
        """Exact answering while the graph has pending live updates: base +
        delta host solves on the flusher (the route is host-bound), tickets
        resolved here, nothing banked (the overlaid graph is no
        snapshot)."""
        t_launch = time.perf_counter()
        self.stages.enter()
        try:
            with span("overlay_batch", batch=len(unique)):
                lats = []
                qlist = []
                served = 0
                for key, res in self.routes["overlay"].solve_iter(
                    overlay, list(unique)
                ):
                    tickets = unique[key]
                    if isinstance(res, QueryError):
                        for t in tickets:
                            if not t.done():
                                self._fail_ticket(t, res)
                        continue
                    served += 1
                    for t in tickets:
                        if self._finish_ticket(t, res):
                            lats.append(t.t_done - t.t_submit)
                            if t.t_launch is not None:
                                qlist.append(t.t_launch - t.t_submit)
                self.latency.record_many(lats)
                with self._lock:
                    self._c_overlay.inc(served)
                self._note_batch_stages(
                    "overlay", len(lats), qlist,
                    resolve_s=time.perf_counter() - t_launch,
                )
        finally:
            self.stages.exit()
            self._note_batch_done(
                t_launch, sum(len(ts) for ts in unique.values())
            )

    def _serve_cached(self, unique) -> list[tuple[int, int]]:
        """One cache pass over the deduped batch (submit skips the lookup
        under load): hits resolve here with no solver work; the misses it
        returns are what launches."""
        pairs = []
        hits = 0
        lats = []
        for key, tickets in unique.items():
            hit = self.dist_cache.lookup(self.graph_id, *key)
            if hit is None:
                pairs.append(key)
                continue
            found, hops, path = hit
            res = BFSResult(
                found, hops if found else None, path if found else None,
                None, 0.0, 0, 0,
            )
            for t in tickets:
                if self._finish_ticket(t, res):
                    lats.append(t.t_done - t.t_submit)
            hits += len(tickets)
        if hits:
            self.latency.record_many(lats)
            with self._cv:
                self._c_cache_served.inc(hits)
                self._outstanding -= hits
                self._cv.notify_all()
        return pairs

    # -- the device rung: launch on the flusher, finish on the worker --
    def _launch_dispatch(self, route, rt, pairs, unique) -> bool:
        """Launch one batch on a dispatch rung (its breaker already
        admitted it), with bounded retries and backoff on the flusher for
        a failure the engine may degrade (:meth:`_may_degrade`); when the
        launch stays dead, free the in-flight slot and return False: the
        ladder degrades the batch to the next rung. Any other failure
        frees the slot and the breaker's claim uncounted and raises, which
        fails the batch's tickets. The breaker's success is recorded at
        finish. The finish job takes its own snapshot pin."""
        breaker = route.breaker
        retry = route.retry
        self._inflight.acquire()  # double-buffer backpressure
        # "one batch time" starts after the in-flight window opens
        t_launch = time.perf_counter()
        attempt = 0
        held = True  # our in-flight slot, until handed to the finish job
        job_pin = False
        claimed = True  # the breaker's allow(), until recorded or released
        try:
            while True:
                try:
                    t_try = time.perf_counter()
                    self.stages.enter()
                    try:
                        out, finish, t0 = route.launch(rt, pairs)
                    finally:
                        self.stages.exit()
                    launch_s = time.perf_counter() - t_try
                    break
                except Exception as e:
                    if not self._may_degrade(e):
                        # the kernel's or the card's failure: answered on
                        # no other rung (the flusher fails the batch)
                        route.hard_failure(e)
                        claimed = False
                        raise
                    self._record_error(e)
                    breaker.record_failure()
                    claimed = False
                    attempt += 1
                    # gate BEFORE counting or sleeping: when this failure
                    # opened the breaker there is no retry to count
                    if (retry is not None and attempt < retry.attempts
                            and breaker.allow()):
                        claimed = True
                        self._res_cells.retry_cell(route.name).inc()
                        time.sleep(retry.delay_s(attempt - 1))
                        continue
                    held = False
                    self._inflight.release()
                    return False
            rt.snapshot.retain()
            job_pin = True
            self._finish_pool.submit(
                self._dispatch_finish_job, route, rt, out, finish, t0,
                pairs, unique, t_launch, launch_s,
            )
            return True
        except BaseException:
            # an escape (a card failure above, KeyboardInterrupt, a dead
            # finish pool) leaks neither the in-flight slot nor the
            # breaker's half-open probe claim
            if claimed:
                breaker.record_failure()
            if job_pin:
                rt.snapshot.release()
            if held:
                self._inflight.release()
            raise

    def _dispatch_finish_job(self, route, rt, out, finish, t0, pairs,
                             unique, t_launch, launch_s=0.0):
        self.stages.enter()
        try:
            # materialize and bank on the launch's snapshot (consumes the
            # job's pin)
            with self._bound(rt):
                self._finish_bound(route, rt, out, finish, t0, pairs, unique,
                                   launch_s)
        except Exception as e:
            self._record_error(e)
            for key in pairs:
                for t in unique[key]:
                    if not t.done():  # never clobber a delivered result
                        self._fail_ticket(t, e)
        finally:
            self.stages.exit()
            self._inflight.release()
            self._note_batch_done(
                t_launch, sum(len(unique[p]) for p in pairs)
            )

    def _finish_bound(self, route, rt, out, finish, t0, pairs, unique,
                      launch_s) -> None:
        """The finish stage of one dispatched batch, on the finish worker
        with the launch's runtime bound."""
        try:
            # route.finish mutates engine counters unlocked: this pool has
            # exactly ONE worker, the only dispatch-side mutator
            t_fin = time.perf_counter()
            results = route.finish(out, finish, t0, pairs)
        except Exception as e:
            if not self._may_degrade(e):
                # the caller fails the batch's tickets
                route.hard_failure(e)
                raise
            # a degradable failure after the launch: the batch is off the
            # flusher, so recover it here through the host ladder
            self._record_error(e)
            route.breaker.record_failure()
            self._note_fallback(route.name, "host")
            with span("recover_host", batch=len(pairs)):
                self._deliver_host(
                    pairs, unique, self._solve_host_isolated(
                        pairs, self._cutoffs_for(pairs, unique)
                    )
                )
            return
        route.breaker.record_success()
        # the adaptive sample: launch_s + the finish wall excludes the
        # finish pool's queue wait, the batch's own clock excludes the
        # untimed epilogue; the lesser is the tighter bound on the solve
        self._note_route_time(
            rt, route.name, pairs,
            min(launch_s + time.perf_counter() - t_fin,
                results[0].time_s if results else 0.0),
        )
        t_resv = time.perf_counter()
        lats = []
        qlist = []
        for (src, dst), res in zip(pairs, results):
            self.dist_cache.put_result(
                self.graph_id, src, dst, res.found, res.hops, res.path,
            )
            for t in unique[(src, dst)]:
                if self._finish_ticket(t, res):
                    lats.append(t.t_done - t.t_submit)
                    qlist.append(t.t_launch - t.t_submit)
        self.latency.record_many(lats)
        self._note_batch_stages(
            route.name, len(lats), qlist, launch_s,
            finish_s=t_resv - t_fin,
            resolve_s=time.perf_counter() - t_resv,
        )

    # -- the host route: solve on the flusher, resolve on the worker ---
    def _launch_host(self, rt, pairs, unique) -> None:
        """The host SOLVE stage, here on the flusher: on the native route
        one GIL-free threaded C call for the whole batch, behind the
        bisection isolator, so a poison batch yields per-query
        ``QueryError`` s. The resolution runs on the finish worker: batch
        k+1 solves here while batch k banks and resolves there."""
        self._inflight.acquire()
        t_launch = time.perf_counter()
        job_pin = False
        try:
            self.stages.enter()
            try:
                results = self._solve_host_isolated(
                    pairs, self._cutoffs_for(pairs, unique)
                )
                launch_s = time.perf_counter() - t_launch
                self._note_route_time(rt, "host", pairs, launch_s)
            finally:
                self.stages.exit()
            rt.snapshot.retain()  # the resolve job banks on THIS snapshot
            job_pin = True
            self._finish_pool.submit(
                self._host_resolve_job, rt, pairs, unique, t_launch,
                results, launch_s,
            )
        except BaseException:
            if job_pin:
                rt.snapshot.release()
            self._inflight.release()  # never leak the in-flight slot
            raise

    def _host_resolve_job(self, rt, pairs, unique, t_launch, results,
                          launch_s=None) -> None:
        self.stages.enter()
        try:
            # bank on the solve's snapshot (consumes the job's pin)
            with self._bound(rt), span("host_resolve", batch=len(pairs)):
                try:
                    self._deliver_host(pairs, unique, results, launch_s)
                except Exception as e:
                    self._record_error(e)
                    for key in pairs:
                        for t in unique[key]:
                            if not t.done():
                                self._fail_ticket(t, e)
        finally:
            self.stages.exit()
            self._inflight.release()
            self._note_batch_done(
                t_launch, sum(len(unique[p]) for p in pairs)
            )

    def _solve_host_isolated(self, pairs, cutoffs=None):
        # host solves take turns (see _host_solve_lock)
        with self._host_solve_lock:
            return super()._solve_host_isolated(pairs, cutoffs)

    # the resilience cells are lock-free counters whose mutators hold
    # the component's lock: here the flusher AND the finish worker reach
    # the fallback and error cells (cold paths only)
    def _note_fallback(self, frm: str, to: str) -> None:
        with self._lock:
            super()._note_fallback(frm, to)

    def _count_error(self, err: BaseException, n: int = 1) -> None:
        with self._lock:
            super()._count_error(err, n)

    def _deliver_host(self, pairs, unique, results, launch_s=None) -> None:
        """Resolve one host-solved batch on the finish worker through the
        shared delivery skeleton: bank and finish the successes, fail
        exactly the tickets the isolator gave up on. The host route passes
        its solve time as ``launch_s``; the device route's recovery does
        not."""
        t_resv = time.perf_counter()
        lats = []
        qlist = []

        def resolve_ok(key, res):
            self.dist_cache.put_result(
                self.graph_id, key[0], key[1], res.found, res.hops, res.path,
            )
            for t in unique[key]:
                if self._finish_ticket(t, res):
                    lats.append(t.t_done - t.t_submit)
                    if t.t_launch is not None:
                        qlist.append(t.t_launch - t.t_submit)

        def resolve_err(key, err):
            for t in unique[key]:
                if not t.done():
                    self._fail_ticket(t, err)

        n_ok = self._deliver_host_results(
            pairs, results, resolve_ok, resolve_err
        )
        self.latency.record_many(lats)
        with self._lock:
            self._c_host_queries.inc(n_ok)
        self._note_batch_stages(
            "host", len(lats), qlist, launch_s,
            resolve_s=time.perf_counter() - t_resv,
        )

    # ---- resolution --------------------------------------------------
    def _finish_ticket(self, t: QueryTicket, res: BFSResult) -> bool:
        """Deliver ``res`` unless the ticket was cancelled; waiters are
        woken once per batch (:meth:`_note_batch_done`)."""
        if t.error is not None:
            return False
        t.t_done = time.perf_counter()
        t.result = res
        return True

    def _fail_ticket(self, t: QueryTicket, err: BaseException) -> None:
        """Fail one ticket with a structured, counted
        :class:`QueryError` (never a raw backend exception)."""
        qerr = (
            err if isinstance(err, QueryError)
            else to_query_error(err, (t.src, t.dst))
        )
        self._count_error(qerr)
        t.t_done = time.perf_counter()
        t.error = qerr

    def _fail_batch(self, batch, err) -> None:
        failed = 0
        for t in batch:
            if not t.done():
                self._fail_ticket(t, err)
                failed += 1
        self._note_batch_done(time.perf_counter(), failed)

    def _note_batch_stages(self, route: str, n: int, queue_list: list,
                           launch_s: float | None = None, *,
                           finish_s: float | None = None,
                           resolve_s: float | None = None) -> None:
        """One resolved batch's cost attribution (under the engine lock:
        the flusher and the finish worker both land here). Launch, finish
        and resolve take one histogram sample each; the queue stage is
        per query, histogrammed in one ``record_many``."""
        queue_sum = 0.0
        if queue_list:
            self._stage_cells["queue"].record_many(queue_list)
            queue_sum = sum(queue_list)
        with self._lock:
            if n:
                self._note_stage(route, "queue", queue_sum, n=n,
                                 record=False)
            if launch_s is not None:
                self._note_stage(route, "launch", launch_s)
            if finish_s is not None:
                self._note_stage(route, "finish", finish_s)
            if resolve_s is not None:
                self._note_stage(route, "resolve", resolve_s)

    def _note_batch_done(self, t_launch: float, tickets: int) -> None:
        service_ms = (time.perf_counter() - t_launch) * 1e3
        with self._cv:
            self.pipe_counters.cell("batch_service_max_ms").set_max(
                service_ms)
            self._outstanding -= tickets
            self._cv.notify_all()

    def _record_error(self, e: BaseException) -> None:
        with self._lock:
            self._errors.append(f"{type(e).__name__}: {e}"[:300])
            del self._errors[:-20]  # keep the newest few

    # ---- introspection ----------------------------------------------
    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats(self) -> dict:
        base = super().stats()
        with self._lock:
            pipe = dict(self.pipe_counters)
            pipe.update(
                outstanding=self._outstanding,
                max_wait_ms=self.max_wait_ms,
                max_queue=self.max_queue,
                errors=list(self._errors),
            )
        base.update(
            pipeline=pipe,
            latency_ms=self.latency.summary_ms(),
            overlap=self.stages.stats(),
        )
        return base
