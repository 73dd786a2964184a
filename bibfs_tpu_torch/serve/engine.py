"""Adaptive micro-batching query engine — the serving path: the
counterpart of ``bibfs_tpu/serve/engine.py`` (its synchronous engine,
over one inline graph).

:class:`QueryEngine` turns a stream of ``(src, dst)`` queries into
batches for the card:

- **micro-batcher** — ``submit()`` accumulates queries; ``flush()``
  routes the queue through ONE batched device search
  (``dense._batch_dispatch``; under the default ``mode="auto"`` the
  batch-minor layout, whose level is a hand-written CUDA kernel) once it
  reaches the batch crossover
  (``batch_minor.small_batch_threshold`` for the engine's device), and
  dispatches per query through the native host runtime below it.
  Batching amortizes the card's per-dispatch cost; an engine on the CPU
  (``device="cpu"``) has nothing to amortize and sends every flush to
  the host route unless ``device_batches=True`` forces the device one.
- **shape buckets + program accounting** — the graph is padded up to the
  geometric buckets of :mod:`bibfs_tpu_torch.serve.buckets` and every
  flush to a batch rung, so graph sizes and queue depths reuse a handful
  of batch geometries; hits and misses show in :meth:`QueryEngine.stats`.
- **distance/result cache** — solved parent forests land in the
  :class:`~bibfs_tpu_torch.serve.cache.DistanceCache`; repeated sources
  (and their reverse twins) answer later queries on the host with no
  dispatch.
- **resilience** — the ladder ``device -> host`` with bounded retries
  and a circuit breaker on the device rung, and per-query isolation on
  the host rung (``serial`` as each singleton's last chance). Every
  degrade is counted in ``bibfs_route_fallbacks_total`` and
  ``bibfs_retries_total`` and shows in ``stats()["resilience"]``. No
  degrade hides a kernel: on a CUDA device the constructor builds the
  kernels its ``mode`` launches (a build failure raises from it), and a
  device flush that fails for any reason but an injected fault
  (:class:`~bibfs_tpu_torch.serve.faults.InjectedFault`, the chaos seam)
  fails its tickets with a ``kind='internal'`` :class:`QueryError`
  instead of being re-solved on the host. An engine on the CPU keeps the
  JAX package's ladder, which degrades on any failure.

Every result is a :class:`~bibfs_tpu_torch.solvers.api.BFSResult` whose
fields equal the JAX package's engine on the same queries; device
results carry the whole batch's wall clock in ``time_s`` (the
``solve_batch_graph`` convention), the batch mode that ran in ``mode``
and the batch's host reads in ``host_syncs``; cache hits carry ~0.

The graph store, the distance oracle, the mesh and blocked routes,
adaptive routing, the query kinds other than point-to-point and the
pipelined engine come with later slices of the port (ROADMAP Queue 1);
their constructor options raise ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np

from bibfs_tpu_torch.obs.dtrace import stage_histogram
from bibfs_tpu_torch.obs.metrics import REGISTRY, MetricBank, next_instance_label
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.query.types import PointToPoint, Query, coerce_query
from bibfs_tpu_torch.serve.buckets import (
    DEFAULT_EXEC_CACHE,
    ExecutableCache,
    bucket_batch,
    ell_bucket_key,
)
from bibfs_tpu_torch.serve.cache import DistanceCache
from bibfs_tpu_torch.serve.faults import FaultPlan, InjectedFault
from bibfs_tpu_torch.serve.resilience import (
    BREAKER_STATE_CODES,
    ERROR_KINDS,
    HEALTH_ERROR_KINDS,
    CircuitBreaker,
    HealthMonitor,
    QueryError,
    RetryPolicy,
    to_query_error,
)
from bibfs_tpu_torch.solvers.api import BFSResult
from bibfs_tpu_torch.store.snapshot import GraphSnapshot
from bibfs_tpu_torch.utils.annotations import guarded_by
from bibfs_tpu_torch.utils.platform import resolve_device

#: the batch layouts a flush can take besides the dense modes
BATCH_LAYOUT_MODES = ("auto", "minor", "minor8")

#: constructor options of later slices -> the ROADMAP Queue 1 item
_UNPORTED = {"store": 6, "graph": 6, "oracle_k": 6, "blocked": 5,
             "adaptive": 5, "mesh": 8}


def _mode_sources(mode: str) -> tuple:
    """The CUDA sources (``ops/_cuda.SOURCES``) a flush in ``mode``
    launches kernels from: the batch-minor level for the minor layouts
    (``auto`` included), the pull kernels for the kernel modes (a batch
    runs ``fused``/``fused_alt`` as ``pallas``/``pallas_alt``), none for
    the torch-composed modes."""
    from bibfs_tpu_torch.solvers.dense import DENSE_MODES

    if mode in BATCH_LAYOUT_MODES:
        return ("batch_minor",)
    return ("pull_expand",) if DENSE_MODES[mode][2] else ()


def _engine_counter_bank(label: str) -> MetricBank:
    """The engine's query-accounting cells under the JAX package's family
    names. One bank per engine instance (``engine="sync-3"``), so
    per-engine ``stats()`` stays exact while a scrape sees every engine.
    The routes of later slices (oracle, overlay, mesh, blocked) are
    minted too and stay at zero."""
    queries = REGISTRY.counter(
        "bibfs_queries_total", "Queries submitted to a serving engine",
        ("engine",),
    )
    routed = REGISTRY.counter(
        "bibfs_queries_routed_total",
        "Queries by resolution route "
        "(trivial/oracle/cache/mesh/blocked/device/host/overlay)",
        ("engine", "route"),
    )
    batches = REGISTRY.counter(
        "bibfs_device_batches_total", "Batched device flush dispatches",
        ("engine",),
    )
    skipped = REGISTRY.counter(
        "bibfs_cache_inserts_skipped_total",
        "Forest-bank inserts skipped by flush-time hygiene",
        ("engine",),
    )
    return MetricBank({
        "queries": queries.labels(engine=label),
        "trivial": routed.labels(engine=label, route="trivial"),
        "oracle_served": routed.labels(engine=label, route="oracle"),
        "cache_served": routed.labels(engine=label, route="cache"),
        "device_batches": batches.labels(engine=label),
        "device_queries": routed.labels(engine=label, route="device"),
        "host_queries": routed.labels(engine=label, route="host"),
        "overlay_queries": routed.labels(engine=label, route="overlay"),
        "mesh_queries": routed.labels(engine=label, route="mesh"),
        "blocked_queries": routed.labels(engine=label, route="blocked"),
        "inserts_skipped": skipped.labels(engine=label),
    })


class _ResilienceCells:
    """The per-engine resilience registry cells, every one minted at
    construction so a scrape shows the families at zero from the start."""

    def __init__(self, label: str):
        errors = REGISTRY.counter(
            "bibfs_errors_total",
            "Per-ticket query failures by taxonomy kind",
            ("engine", "kind"),
        )
        fallbacks = REGISTRY.counter(
            "bibfs_route_fallbacks_total",
            "Batches re-routed down the fallback ladder",
            ("engine", "from", "to"),
        )
        retries = REGISTRY.counter(
            "bibfs_retries_total", "Route retries before fallback",
            ("engine", "route"),
        )
        bisections = REGISTRY.counter(
            "bibfs_batch_bisections_total",
            "Poison-batch bisection splits during failure isolation",
            ("engine",),
        )
        self.breaker_gauge = REGISTRY.gauge(
            "bibfs_breaker_state",
            "Device-route circuit breaker (0=closed 1=half_open 2=open)",
            ("engine",),
        ).labels(engine=label)
        self._breaker_trans = REGISTRY.counter(
            "bibfs_breaker_transitions_total",
            "Circuit breaker state transitions",
            ("engine", "to"),
        )
        self.health_gauge = REGISTRY.gauge(
            "bibfs_health_state",
            "Serving health (0=live 1=ready 2=degraded 3=draining)",
            ("engine",),
        ).labels(engine=label)
        self.errors = {
            k: errors.labels(engine=label, kind=k) for k in ERROR_KINDS
        }
        self._fallback_family = fallbacks
        self.fallbacks = {
            (a, b): fallbacks.labels(**{"engine": label, "from": a, "to": b})
            for a, b in (("device", "host"), ("host", "serial"))
        }
        self._retry_family = retries
        self._retry_cells = {
            "device": retries.labels(engine=label, route="device"),
        }
        self.bisections = bisections.labels(engine=label)
        self._label = label

    def retry_cell(self, route: str):
        """The ``bibfs_retries_total{route=...}`` cell of one route."""
        cell = self._retry_cells.get(route)
        if cell is None:
            cell = self._retry_family.labels(engine=self._label, route=route)
            self._retry_cells[route] = cell
        return cell

    def fallback_cell(self, frm: str, to: str):
        cell = self.fallbacks.get((frm, to))
        if cell is None:
            cell = self._fallback_family.labels(
                **{"engine": self._label, "from": frm, "to": to}
            )
            self.fallbacks[(frm, to)] = cell
        return cell

    def on_breaker_transition(self, state: str) -> None:
        self.breaker_gauge.set(BREAKER_STATE_CODES[state])
        self._breaker_trans.labels(to=state, engine=self._label).inc()

    def snapshot(self) -> dict:
        return {
            "errors": {k: c.value for k, c in self.errors.items()},
            "fallbacks": {
                f"{a}->{b}": c.value for (a, b), c in self.fallbacks.items()
            },
            "retries": sum(c.value for c in self._retry_cells.values()),
            "bisections": self.bisections.value,
        }


class _Pending:
    """A submitted query's handle; exactly one of ``result`` / ``error``
    lands at flush time (a poisoned query gets a structured
    :class:`~bibfs_tpu_torch.serve.resilience.QueryError` instead of
    sinking its batch)."""

    __slots__ = ("src", "dst", "result", "error")

    def __init__(self, src: int, dst: int):
        self.src = src
        self.dst = dst
        self.result: BFSResult | None = None
        self.error: BaseException | None = None


@guarded_by("_lock", "_graph", "bucket_key", "_host_solver",
            "host_native_graph", "_serial_solver", "host_backend_resolved")
class _GraphRuntime:
    """Everything an engine knows about solving one immutable graph
    snapshot: the lazily built and uploaded device graph and its bucket
    key, the host solvers (native / serial), and the distance-cache
    namespace ``graph_id`` (the snapshot's content digest unless the
    caller overrides it)."""

    def __init__(self, snapshot: GraphSnapshot, *, layout: str, device,
                 host_backend: str | None = None, graph_id=None):
        self.snapshot = snapshot
        self.n = snapshot.n
        self.layout = layout
        self.graph_id = snapshot.digest if graph_id is None else graph_id
        self._device = device
        self._host_backend = host_backend
        self._lock = threading.Lock()
        self._graph = None
        self.bucket_key = None
        self._host_solver = None
        self.host_native_graph = None
        self._serial_solver = None
        self.host_backend_resolved: str | None = None

    @property
    def graph(self):
        """The bucketed device-resident graph, built and uploaded on first
        use (a host-routed runtime never pays the padded table build)."""
        if self._graph is None:
            from bibfs_tpu_torch.solvers.dense import DeviceGraph

            with self._lock:
                if self._graph is None:
                    if self.layout == "ell":
                        ell = self.snapshot.ell()
                        self.bucket_key = ell_bucket_key(ell)
                        self._graph = DeviceGraph.from_ell(
                            ell, device=self._device
                        )
                    else:
                        g = DeviceGraph.from_tiered(
                            self.snapshot.tiered(), device=self._device
                        )
                        self.bucket_key = (
                            "tiered", g.n_pad, g.width, g.tier_meta,
                        )
                        self._graph = g
        return self._graph

    def get_host_solver(self):
        """The per-query host solver: the native C++ runtime when it
        builds and loads, else the NumPy serial oracle over the snapshot's
        CSR (``host_backend="native"`` makes a native failure raise)."""
        if self._host_solver is not None:
            return self._host_solver
        with self._lock:
            if self._host_solver is not None:
                return self._host_solver
            backend = self._host_backend
            if backend in (None, "native"):
                try:
                    from bibfs_tpu_torch.solvers.native import (
                        NativeGraph,
                        solve_native_graph,
                    )

                    mapped = self.snapshot.native_csr()
                    ng = (
                        NativeGraph(n=self.n, row_ptr=mapped[0],
                                    col_ind=mapped[1])
                        if mapped is not None
                        else NativeGraph.build(
                            self.n, self.snapshot.undirected_edges()
                        )
                    )
                    # kept for the threaded C batch (_solve_host), which
                    # shares only the read-only CSR
                    self.host_native_graph = ng
                    self.host_backend_resolved = "native"
                    self._host_solver = (
                        lambda s, d: solve_native_graph(ng, s, d)
                    )
                    return self._host_solver
                except OSError:
                    if backend == "native":
                        raise
            self._host_solver = self._serial_csr_solver()
            self.host_backend_resolved = "serial"
            return self._host_solver

    def _serial_csr_solver(self):
        from bibfs_tpu_torch.solvers.serial import solve_serial_csr

        row_ptr, col_ind = self.snapshot.csr()
        return lambda s, d: solve_serial_csr(self.n, row_ptr, col_ind, s, d)

    def solve_serial_one(self, src: int, dst: int) -> BFSResult:
        """The bottom of the fallback ladder: the NumPy serial oracle over
        the snapshot's CSR."""
        if self._serial_solver is None:
            with self._lock:
                if self._serial_solver is None:
                    if (self.host_backend_resolved == "serial"
                            and self._host_solver is not None):
                        # the host route already IS the serial oracle
                        self._serial_solver = self._host_solver
                    else:
                        self._serial_solver = self._serial_csr_solver()
        return self._serial_solver(int(src), int(dst))


@guarded_by("_rt_lock", "_rts_released")
class QueryEngine:
    """Serve ``(src, dst)`` shortest-path queries over one graph.

    Parameters
    ----------
    n, edges : the graph (same contract as ``api.solve``); ``pairs``
        optionally passes a precomputed ``canonical_pairs`` result.
        Internally the graph becomes an immutable
        :class:`~bibfs_tpu_torch.store.snapshot.GraphSnapshot`.
    mode : batch mode of device flushes (default ``"auto"``: ``minor8``
        where the graph and batch fit, else ``minor``, else per-query
        ``sync``); any mode of :func:`~bibfs_tpu_torch.solvers.dense.
        solve_batch_graph`. Unknown modes raise ``ValueError`` here, and
        so does ``minor8`` with ``layout="tiered"`` on a CUDA engine.
    layout : ``"ell"`` (shape-bucketed; the serving default) or
        ``"tiered"`` (power-law graphs; exact shapes, no bucketing).
    flush_threshold : queue depth at which a flush goes to the device;
        below it queries dispatch per query through the host runtime.
        Default: ``small_batch_threshold`` of the engine's device type
        (on the card, with no ``cuda`` calibration block, 32; below it
        ``python -m bibfs_tpu_torch.cli.crossover`` measures the host
        route ahead of a device flush of the same pairs, PERF.md §6).
    max_batch : largest single device flush (rounded up to a batch rung);
        longer queues solve in chunks.
    cache_entries : distance-cache forest capacity (2 forests bank per
        solved query; each costs one int32[n] row).
    host_backend : ``"native"``, ``"serial"`` or None (native when its
        runtime builds and loads, else serial).
    device_batches : route above-crossover flushes to the device. None
        (default): only when the engine's device is ``cuda``.
    exec_cache : an :class:`ExecutableCache` shared across engines
        (default: the process-wide one).
    dist_cache : a :class:`DistanceCache` to share across engines
        (default: a private one); entries are namespaced by ``graph_id``.
    graph_id : distance-cache namespace override (default: the
        snapshot's content digest, which equals the JAX package's).
    device : the device of the batched search (default ``cuda``; a CUDA
        engine without a card raises, ``"cpu"`` runs the plain torch
        versions of the kernels).
    obs_label : the ``engine=`` label of this engine's registry cells
        (default: a process-unique ``sync-N``).
    faults : a :class:`~bibfs_tpu_torch.serve.faults.FaultPlan` injecting
        failures at the engine seams. Default: parsed from
        ``BIBFS_FAULTS`` when set, else None.
    retry, breaker : the device route's
        :class:`~bibfs_tpu_torch.serve.resilience.RetryPolicy` (default 2
        attempts) and :class:`~bibfs_tpu_torch.serve.resilience.
        CircuitBreaker` (default: opens after 3 consecutive failures,
        half-open probe after 5 s).
    health_window_s : sliding window of the health monitor's recent-error
        input.
    store, graph, oracle_k, mesh, blocked, adaptive : options of later
        slices of the port; passing any raises ``NotImplementedError``.
    """

    _OBS_PREFIX = "sync"
    # below this many queries one threaded-batch call costs more in thread
    # spin-up and ctypes marshalling than it saves
    HOST_BATCH_MIN = 4

    def __init__(
        self,
        n: int | None = None,
        edges: np.ndarray | None = None,
        *,
        store=None,
        graph: str | None = None,
        pairs: np.ndarray | None = None,
        mode: str = "auto",
        layout: str = "ell",
        flush_threshold: int | None = None,
        max_batch: int = 1024,
        cache_entries: int = 64,
        host_backend: str | None = None,
        device_batches: bool | None = None,
        exec_cache: ExecutableCache | None = None,
        dist_cache: DistanceCache | None = None,
        oracle_k: int | None = None,
        graph_id=None,
        device=None,
        obs_label: str | None = None,
        faults: FaultPlan | None = None,
        retry: RetryPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        health_window_s: float = 5.0,
        mesh=None,
        blocked=None,
        adaptive=None,
    ):
        from bibfs_tpu_torch.solvers.batch_minor import small_batch_threshold
        from bibfs_tpu_torch.solvers.dense import DENSE_MODES

        given = {"store": store, "graph": graph, "oracle_k": oracle_k,
                 "mesh": mesh, "blocked": blocked, "adaptive": adaptive}
        for opt, item in _UNPORTED.items():
            if given[opt] is not None and given[opt] is not False:
                raise NotImplementedError(
                    f"QueryEngine({opt}=...) is not ported yet "
                    f"(ROADMAP Queue 1, item {item})"
                )
        if layout not in ("ell", "tiered"):
            raise ValueError(
                f"unknown layout {layout!r} (expected 'ell' or 'tiered')"
            )
        if mode not in BATCH_LAYOUT_MODES and mode not in DENSE_MODES:
            raise ValueError(
                f"unknown batch mode {mode!r}; have "
                f"{sorted(BATCH_LAYOUT_MODES + tuple(DENSE_MODES))}"
            )
        if host_backend not in (None, "native", "serial"):
            raise ValueError(
                f"unknown host_backend {host_backend!r} (expected "
                "'native', 'serial' or None)"
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if n is None:
            raise ValueError("n (and edges/pairs) required")
        self._device = resolve_device(device)
        if self._device.type == "cuda" and mode == "minor8" and (
                layout == "tiered"):
            # every flush would fail on the card (minor8 refuses hub
            # tiers) and a CUDA engine does not degrade such a failure
            raise ValueError(
                "mode='minor8' takes the plain ELL layout only; use "
                "layout='ell' or mode='minor'/'auto' with layout='tiered'"
            )
        if self._device.type == "cuda":
            # build (or load) the kernels this mode launches now: a kernel
            # that does not build must fail the engine, not degrade its
            # flushes to the host route
            from bibfs_tpu_torch.ops import _cuda

            for source in _mode_sources(mode):
                _cuda.lib(source)
        snap = GraphSnapshot.build(n, edges, pairs=pairs)
        self.mode = mode
        self.layout = layout
        self.flush_threshold = (
            small_batch_threshold(self._device.type)
            if flush_threshold is None else int(flush_threshold)
        )
        self.max_batch = bucket_batch(max_batch)
        self._rt_lock = threading.RLock()
        self._rts_released = False
        self._rt = _GraphRuntime(
            snap, layout=layout, device=self._device,
            host_backend=host_backend, graph_id=graph_id,
        )
        self.obs_label = (
            next_instance_label(self._OBS_PREFIX) if obs_label is None
            else obs_label
        )
        self.dist_cache = (
            DistanceCache(entries=cache_entries, metrics_label=self.obs_label)
            if dist_cache is None else dist_cache
        )
        self.exec_cache = (
            DEFAULT_EXEC_CACHE if exec_cache is None else exec_cache
        )
        self._device_batches = device_batches
        # resilience: fault plan (None = zero-cost), device retry policy,
        # device-route circuit breaker, health state machine
        self._faults = FaultPlan.from_env() if faults is None else faults
        self._retry = RetryPolicy() if retry is None else retry
        self._res_cells = _ResilienceCells(self.obs_label)
        self._breaker = CircuitBreaker() if breaker is None else breaker
        # a weakly bound listener: a breaker shared across engines keeps
        # every live engine's gauge exact without pinning dead engines
        # (returning False unsubscribes)
        cells_ref = weakref.ref(self._res_cells)

        def _on_breaker_transition(state):
            cells = cells_ref()
            if cells is None:
                return False
            cells.on_breaker_transition(state)
            return True

        self._breaker.add_listener(_on_breaker_transition)
        self._res_cells.breaker_gauge.set(
            BREAKER_STATE_CODES[self._breaker.state]
        )
        self.health = HealthMonitor(
            breaker=self._breaker,
            window_s=health_window_s,
            gauge=self._res_cells.health_gauge,
        )
        # drain gate (begin_drain/end_drain): while set, NEW submits are
        # refused with a kind='capacity' QueryError but everything
        # already queued still resolves
        self._draining = False
        self.health.set_ready()
        # render-time health refresh (breaker windows elapse and error
        # windows age out with no event), weakly bound like the listener
        self_ref = weakref.ref(self)

        def _collect_health():
            eng = self_ref()
            if eng is None:
                return False
            eng.health.state()
            eng._res_cells.breaker_gauge.set(
                BREAKER_STATE_CODES[eng._breaker.state]
            )
            return True

        REGISTRY.add_collector(_collect_health)
        self._pending: list[_Pending] = []
        self.counters = _engine_counter_bank(self.obs_label)
        from bibfs_tpu_torch.serve.routes import build_routes

        self.routes, self._ladder = build_routes(self)
        # direct cell handles for the per-query submit path
        self._c_queries = self.counters.cell("queries")
        self._c_trivial = self.counters.cell("trivial")
        self._c_cache_served = self.counters.cell("cache_served")
        self._c_host_queries = self.counters.cell("host_queries")
        # the per-query stage histogram, minted so it renders at zero as
        # in the JAX package (whose pipelined engine records into it; the
        # synchronous engine has no stages of its own)
        self._stage_cells = stage_histogram()

    # ---- the graph ---------------------------------------------------
    def _resolve_graph(self, graph) -> _GraphRuntime:
        """The runtime a submit-time graph argument names: only the
        engine's own graph (None) — per-query graph names need a store."""
        if graph is not None:
            raise ValueError(
                "per-query graph names need an attached store (store=), "
                "which is not ported yet"
            )
        return self._rt

    def _pin_rt(self) -> _GraphRuntime:
        """Pin the runtime's snapshot for one flush (the caller owes one
        ``snapshot.release()``)."""
        with self._rt_lock:
            self._rt.snapshot.retain()
        return self._rt

    @property
    def n(self) -> int:
        return self._rt.n

    @property
    def graph(self):
        """The bucketed device-resident graph (built on first use)."""
        return self._rt.graph

    @property
    def graph_id(self):
        return self._rt.graph_id

    @property
    def _bucket_key(self):
        return self._rt.bucket_key

    @property
    def _host_native_graph(self):
        return self._rt.host_native_graph

    @property
    def host_backend_resolved(self):
        return self._rt.host_backend_resolved

    # ---- submission --------------------------------------------------
    def submit(self, src: int, dst: int, graph: str | None = None) -> _Pending:
        """Queue one query. Cache hits and trivial queries resolve
        immediately; everything else resolves at the next flush (an
        overfull queue flushes itself at ``max_batch``)."""
        if self._rts_released:
            raise ValueError("engine is closed")
        if self._draining:
            # refused with a structured capacity error (retryable on a
            # peer); not counted as an engine error
            raise QueryError(
                "engine is draining", kind="capacity",
                query=(int(src), int(dst)),
            )
        src, dst = int(src), int(dst)
        rt = self._resolve_graph(graph)
        if not (0 <= src < rt.n and 0 <= dst < rt.n):
            raise ValueError(f"src/dst out of range for n={rt.n}")
        t = _Pending(src, dst)
        self._c_queries.inc()
        if src == dst:
            self._c_trivial.inc()
            t.result = BFSResult(True, 0, [src], src, 0.0, 0, 0)
            return t
        hit = self.dist_cache.lookup(rt.graph_id, src, dst)
        if hit is not None:
            found, hops, path = hit
            self._c_cache_served.inc()
            t.result = BFSResult(
                found, hops if found else None, path if found else None,
                None, 0.0, 0, 0,
            )
            return t
        self._pending.append(t)
        if len(self._pending) >= self.max_batch:
            self.flush()
        return t

    def query(self, src: int, dst: int, graph: str | None = None
              ) -> BFSResult:
        """Submit and flush one query. Raises the ticket's
        :class:`QueryError` if every fallback rung failed it."""
        t = self.submit(src, dst, graph)
        if t.result is None and t.error is None:
            self.flush()
        if t.error is not None:
            raise t.error
        return t.result

    def submit_query(self, q, graph: str | None = None) -> _Pending:
        """Queue one typed query (:mod:`bibfs_tpu_torch.query.types`): a
        :class:`PointToPoint` (or a bare pair) takes :meth:`submit`; the
        other kinds are not ported yet and raise
        ``NotImplementedError``."""
        q = coerce_query(q)
        if isinstance(q, PointToPoint):
            return self.submit(q.src, q.dst, graph)
        raise NotImplementedError(
            f"query kind {q.kind!r} is not ported yet (ROADMAP Queue 1, "
            "item 7)"
        )

    def query_one(self, q, graph: str | None = None):
        """Submit and flush one typed query (:meth:`submit_query`)."""
        t = self.submit_query(q, graph)
        if t.result is None and t.error is None:
            self.flush()
        if t.error is not None:
            raise t.error
        return t.result

    def query_many(self, pairs, *, graph: str | None = None,
                   return_errors: bool = False) -> list:
        """Serve a whole query list through one (chunked) flush.

        ``return_errors=True`` switches to partial-failure mode: one entry
        per pair — a :class:`BFSResult` where the query resolved, a
        :class:`QueryError` where it alone failed, including queries
        rejected at submit time (``kind='invalid'``). The default
        re-raises the first failure."""
        tickets = self._submit_collect(pairs, return_errors, graph)
        if not tickets:
            return []  # nothing queued: skip the flush entirely
        if any(isinstance(t, _Pending) for t in tickets):
            self.flush()
        out = []
        for t in tickets:
            if isinstance(t, QueryError):
                out.append(t)
            elif t.error is not None:
                if not return_errors:
                    raise t.error
                out.append(to_query_error(t.error, (t.src, t.dst)))
            else:
                out.append(t.result)
        return out

    def _submit_collect(self, pairs, return_errors: bool,
                        graph: str | None = None) -> list:
        """Submit every pair; in ``return_errors`` mode a rejected submit
        becomes a ``kind='invalid'`` :class:`QueryError` slot instead of
        aborting the whole list."""
        tickets: list = []
        for item in pairs:
            try:
                if isinstance(item, Query):
                    tickets.append(self.submit_query(item, graph))
                else:
                    s, d = item
                    tickets.append(self.submit(int(s), int(d), graph))
            except (ValueError, TypeError) as e:
                if not return_errors:
                    raise
                try:
                    if isinstance(item, PointToPoint):
                        q = (item.src, item.dst)
                    else:
                        s, d = item
                        q = (int(s), int(d))
                except (ValueError, TypeError, IndexError):
                    q = None
                err = to_query_error(e, q, kind="invalid")
                self._count_error(err)
                tickets.append(err)
        return tickets

    # ---- flushing ----------------------------------------------------
    def flush(self) -> None:
        """Resolve every pending query: batched device dispatch at or
        above the crossover, per-query host dispatch below."""
        pend, self._pending = self._pending, []
        if not pend:
            return
        rt = self._pin_rt()
        try:
            with span("flush", queued=len(pend)):
                # dedupe exact repeats within one flush: a batch slot per
                # duplicate would be pure waste
                unique: dict[tuple[int, int], list[_Pending]] = {}
                for t in pend:
                    unique.setdefault((t.src, t.dst), []).append(t)
                pairs = list(unique)
                for i in range(0, len(pairs), self.max_batch):
                    self._flush_ladder(pairs[i: i + self.max_batch], unique)
        finally:
            rt.snapshot.release()

    def _next_rung(self, i: int, rt, pairs) -> str:
        """The rung a failed ladder step actually degrades TO (the ``to``
        label of the fallback counter)."""
        for name in self._ladder[i + 1:]:
            if name == "host" or self.routes[name].eligible(rt, pairs):
                return name
        return "host"

    def _flush_ladder(self, pairs, unique) -> None:
        """Walk the fallback ladder for one chunk: each eligible rung gets
        a resilient :meth:`~bibfs_tpu_torch.serve.routes.base.Route.
        attempt` (bounded retries behind its breaker); an unavailable rung
        degrades to the next, counted in ``bibfs_route_fallbacks_total``,
        and the terminal host rung absorbs whatever is left behind its
        bisection isolator. A sub-crossover chunk skips the device rung
        (a routing decision, not a degrade). A rung failure the engine may
        not degrade (:meth:`_may_degrade`) fails the chunk's tickets
        instead."""
        rt = self._rt
        for i, name in enumerate(self._ladder):
            if name == "host":
                break
            route = self.routes[name]
            if not route.eligible(rt, pairs):
                continue
            try:
                results = route.attempt(rt, pairs)
            except Exception as exc:
                # a failure the engine may not degrade (_may_degrade): the
                # chunk's tickets fail, none is re-solved on the host
                for key in pairs:
                    self._resolve_error(unique[key], to_query_error(exc, key))
                return
            if results is not None:
                for j, (src, dst) in enumerate(pairs):
                    self._resolve(unique[(src, dst)], src, dst, results[j])
                return
            self._note_fallback(name, self._next_rung(i, rt, pairs))
        self._flush_host(pairs, unique)

    def _device_solve(self, pairs) -> list[BFSResult]:
        """One device flush: pad the flush to its batch rung with inert
        ``(0, 0)`` queries, resolve the batch mode, note the program
        identity and run the batch (``device_launch``); then run the
        finish hook (minor8 slot decode, capped-query refill), copy the
        outputs of the real queries to the host ONCE, materialize the
        results and bank the parent forests from those same host copies
        (``device_finish``)."""
        from bibfs_tpu_torch.solvers.batch_minor import auto_batch_mode
        from bibfs_tpu_torch.solvers.dense import (
            _batch_dispatch,
            _host,
            _materialize_batch,
        )
        from bibfs_tpu_torch.solvers.timing import force_scalar

        b = len(pairs)
        with span("device_launch", batch=b):
            if self._faults is not None:
                self._faults.fire("device", pairs)
            graph = self.graph  # lazy build; also sets the bucket key
            rung = min(bucket_batch(b), self.max_batch)
            padded = np.zeros((rung, 2), dtype=np.int64)
            padded[:b] = pairs
            mode = self.mode
            if mode == "auto":
                mode = auto_batch_mode(graph, rung)
            self.exec_cache.note((self._bucket_key, mode, rung))
            stats = {"host_syncs": 0}
            _p, dispatch, finish = _batch_dispatch(graph, padded, mode, stats)
            t0 = time.perf_counter()
            out = dispatch()
        with span("device_finish", batch=b):
            if self._faults is not None:
                self._faults.fire("device_finish", pairs)
            force_scalar(out)
            elapsed = time.perf_counter() - t0
            outs = [_host(o[:b]) for o in finish(out)]
            results = _materialize_batch(outs, b, elapsed, mode=stats["mode"],
                                         host_syncs=stats["host_syncs"])
            self.counters["device_batches"] += 1
            self.counters["device_queries"] += b
            self._bank_forests(pairs, outs[2], outs[3])
            return results

    def _bank_forests(self, pairs, par_s, par_t) -> None:
        """Bank both sides' parent forests: level-synchronous searches
        stamp true distances, so each forest answers later queries about
        its root (and reverse twins) without a dispatch. Repeated roots
        within the flush are deduped (the newest plane wins) and only the
        newest ``dist_cache.entries`` roots are banked; the rest count in
        ``inserts_skipped``."""
        with span("bank_forests", batch=len(pairs)):
            planes: dict[int, tuple[np.ndarray, int]] = {}
            rank: dict[int, int] = {}
            k = 0
            for i, (src, dst) in enumerate(pairs):
                for root, plane in ((src, par_s), (dst, par_t)):
                    planes[root] = (plane, i)
                    rank[root] = k  # later occurrence = newer
                    k += 1
            cap = max(self.dist_cache.entries, 0)
            newest = sorted(planes, key=rank.__getitem__)
            keep = newest[-cap:] if cap else []
            self.counters["inserts_skipped"] += 2 * len(pairs) - len(keep)
            for root in keep:
                plane, i = planes[root]
                self.dist_cache.put_forest(self.graph_id, root, plane[i],
                                           self.n)

    def _may_degrade(self, exc: BaseException) -> bool:
        """Whether a device-route failure may degrade down the ladder. On
        the CPU, any (the JAX package's ladder); on a CUDA engine only an
        :class:`InjectedFault`, the chaos seam: any other failure is the
        kernel's or the card's (a launch that failed, memory that ran
        out), and answering it on the host would hide it."""
        return self._device.type != "cuda" or isinstance(exc, InjectedFault)

    def _use_device(self) -> bool:
        """Whether above-crossover flushes go to the device route: by the
        engine's device type (``cuda`` yes, ``cpu`` no), unless
        ``device_batches`` was given."""
        if self._device_batches is not None:
            return self._device_batches
        return self._device.type == "cuda"

    def _flush_host(self, pairs, unique) -> None:
        """Solve and deliver one host batch. No parent planes exist on the
        host route, but each found shortest path is a valid forest
        fragment for both endpoints, so the newest ``dist_cache.entries``
        found paths are banked."""
        results = self._solve_host_isolated(pairs)
        ok_idx = [i for i, r in enumerate(results)
                  if not isinstance(r, QueryError)]
        bank = self._paths_to_bank([results[i] for i in ok_idx])
        bank_idx = {ok_idx[j] for j in bank}
        for i, ((src, dst), res) in enumerate(zip(pairs, results)):
            if isinstance(res, QueryError):
                self._resolve_error(unique[(src, dst)], res)
                continue
            if i in bank_idx:
                self.dist_cache.put_path(self.graph_id, res.path, self.n)
            self._resolve(unique[(src, dst)], src, dst, res)
        self._c_host_queries.inc(len(ok_idx))

    def _solve_host_isolated(self, pairs):
        """The host route with failure isolation: the whole batch first;
        on failure, BISECT — halves re-solve independently, so a poison
        batch converges in O(log B) extra solves to exactly the queries
        that are bad. A failing singleton gets one last rung (the serial
        oracle) and only then a structured :class:`QueryError`. Returns one
        ``BFSResult | QueryError`` per pair; never raises."""
        try:
            return self._solve_host(pairs)
        except Exception as exc:
            if len(pairs) == 1:
                self._note_fallback("host", "serial")
                try:
                    src, dst = pairs[0]
                    return [self._solve_serial_one(src, dst)]
                except Exception as exc2:
                    return [to_query_error(exc2, pairs[0])]
            self._res_cells.bisections.inc()
            mid = len(pairs) // 2
            del exc  # halves re-derive their own failure (or succeed)
            return (self._solve_host_isolated(pairs[:mid])
                    + self._solve_host_isolated(pairs[mid:]))

    def _solve_serial_one(self, src: int, dst: int) -> BFSResult:
        """The bottom of the fallback ladder
        (:class:`~bibfs_tpu_torch.serve.routes.SerialRoute`); a thin seam
        so chaos tests can break this rung per engine."""
        return self.routes["serial"].solve_one(self._rt, src, dst)

    def _resolve_error(self, tickets, err: QueryError) -> None:
        """Fail exactly these tickets with a structured error (their batch
        peers resolve normally) and feed the error telemetry."""
        self._count_error(err, len(tickets))
        for t in tickets:
            t.error = err

    def _count_error(self, err: BaseException, n: int = 1) -> None:
        kind = getattr(err, "kind", "internal")
        cell = self._res_cells.errors.get(kind)
        if cell is None:
            cell = self._res_cells.errors["internal"]
        cell.inc(n)
        # only server-side failures degrade health: a client sending
        # malformed queries must not flip a healthy node's /healthz
        if kind in HEALTH_ERROR_KINDS:
            self.health.note_error(n)

    def _note_fallback(self, frm: str, to: str) -> None:
        self._res_cells.fallback_cell(frm, to).inc()

    def _paths_to_bank(self, results) -> set:
        """Of this flush's found paths, the indices of the newest
        ``dist_cache.entries`` to bank; the rest count in
        ``inserts_skipped``."""
        found = [i for i, r in enumerate(results) if r.found]
        cap = max(self.dist_cache.entries, 0)
        bank = set(found[-cap:]) if cap else set()
        self.counters["inserts_skipped"] += len(found) - len(bank)
        return bank

    def _solve_host(self, pairs) -> list[BFSResult]:
        """Solve ``pairs`` on the host route: the threaded native C batch
        when the native runtime carries the route and the flush has at
        least :attr:`HOST_BATCH_MIN` queries, else the per-query solver.
        The C batch caps each query's path buffer, so a found result
        without a path is re-solved per query (full path buffer)."""
        with span("host_batch", batch=len(pairs)):
            if self._faults is not None:
                self._faults.fire("host_batch", pairs)
            solver = self._rt.get_host_solver()
            ng = self._host_native_graph
            if ng is not None and len(pairs) >= self.HOST_BATCH_MIN:
                from bibfs_tpu_torch.solvers.native import (
                    solve_batch_native_graph,
                )

                results = solve_batch_native_graph(
                    ng, np.asarray(pairs, dtype=np.int64)
                )
                return [
                    solver(src, dst) if (r.found and r.path is None) else r
                    for (src, dst), r in zip(pairs, results)
                ]
            return [solver(src, dst) for src, dst in pairs]

    def _resolve(self, tickets, src, dst, res: BFSResult) -> None:
        self.dist_cache.put_result(
            self.graph_id, src, dst, res.found, res.hops, res.path
        )
        for t in tickets:
            t.result = res

    # ---- lifecycle ---------------------------------------------------
    def begin_drain(self) -> None:
        """Enter the draining state: health reads draining, NEW submits
        are refused with a ``kind='capacity'`` :class:`QueryError`, and
        everything already queued still resolves at the next flush.
        Reversible with :meth:`end_drain`."""
        self._draining = True
        self.health.set_draining()

    def end_drain(self) -> None:
        """Leave the draining state: submits are accepted again."""
        self._draining = False
        self.health.clear_draining()

    def kill(self) -> None:
        """Crash-semantics teardown: queued tickets fail NOW with a
        ``kind='internal'`` :class:`QueryError`, health flips to draining
        and the snapshot pin drops; later submits raise ``engine is
        closed``. :meth:`close` resolves everything queued first."""
        self._draining = True
        pend, self._pending = self._pending, []
        if pend:
            self._resolve_error(pend, QueryError(
                "replica killed: engine torn down with queries queued",
                kind="internal",
            ))
        self.health.set_draining()
        self._release_runtimes()

    def close(self) -> None:
        """Resolve anything still queued, mark the engine draining and
        drop its snapshot pin. Later ``submit``/``query`` calls raise
        ``engine is closed``; ``stats()`` stays readable."""
        self.flush()
        self.health.set_draining()
        self._release_runtimes()

    def _release_runtimes(self) -> None:
        """Drop the engine's snapshot pin, once."""
        with self._rt_lock:
            if self._rts_released:
                return
            self._rts_released = True
        self._rt.snapshot.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---- introspection ----------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._pending)

    def stats(self) -> dict:
        """Machine-readable serving counters: the JAX package's engine
        ``stats()`` keys for the ported features, plus ``device``."""
        c = dict(self.counters)
        rt = self._rt
        solved = (
            c["device_queries"] + c["host_queries"] + c["overlay_queries"]
            + c["mesh_queries"] + c["blocked_queries"]
        )
        return {
            **c,
            "solver_dispatch_free": c["queries"] - solved,
            "ladder": list(self._ladder),
            "routes": {
                name: route.stats() for name, route in self.routes.items()
            },
            "dist_cache": self.dist_cache.stats(),
            "exec_cache": self.exec_cache.stats(),
            "flush_threshold": self.flush_threshold,
            "max_batch": self.max_batch,
            "bucket": (
                list(self._bucket_key[1:3]) if self._bucket_key else None
            ),
            "device_batches_enabled": self._use_device(),
            "device": str(self._device),
            "host_backend": self.host_backend_resolved,
            "graph": {
                "n": rt.n,
                "digest": rt.snapshot.digest,
                "version": rt.snapshot.version,
            },
            "resilience": {
                **self._res_cells.snapshot(),
                "breaker": self._breaker.snapshot(),
                "retry": self._retry.snapshot(),
                "faults": (
                    None if self._faults is None else self._faults.stats()
                ),
            },
            "health": self.health.snapshot(),
        }

    def health_snapshot(self) -> dict:
        """The ``/healthz`` payload: the health state machine's view."""
        return self.health.snapshot()
