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
- **resilience** — the ladder ``device -> host`` (``mesh ->`` ahead with
  ``mesh=``, ``blocked ->`` ahead of device with ``blocked=``) with bounded
  retries and a circuit breaker
  on each dispatch rung, and per-query isolation on the host rung
  (``serial`` as each singleton's last chance). Every
  degrade is counted in ``bibfs_route_fallbacks_total`` and
  ``bibfs_retries_total`` and shows in ``stats()["resilience"]``. No
  degrade hides a kernel: on a CUDA device the constructor builds the
  kernels its ``mode`` launches (a build failure raises from it), and a
  device flush that fails for any reason but an injected fault
  (:class:`~bibfs_tpu_torch.serve.faults.InjectedFault`, the chaos seam)
  fails its tickets with a ``kind='internal'`` :class:`QueryError`
  instead of being re-solved on the host; the blocked rung follows the
  same rule. An engine on the CPU keeps the JAX package's ladder, which
  degrades on any failure.
- **mesh route** — ``mesh=`` adds the mesh rung ahead of the others
  (:mod:`bibfs_tpu_torch.serve.routes.mesh`): above its crossovers a flush
  runs on a pool of ranks that stay up across flushes
  (:class:`~bibfs_tpu_torch.parallel.pool.MeshPool`), data-parallel over
  replicas or vertex-sharded over a 1D mesh; the engine's threads never
  enter a collective.
- **blocked route** — ``blocked=`` adds the tile rung
  (:mod:`bibfs_tpu_torch.serve.routes.blocked`): above its crossover, on
  a graph whose tile structure is compact, a flush advances as int8
  block products over the tiled adjacency (a hand-written tensor-core
  kernel on the card).
- **adaptive routing** — ``adaptive=`` orders the ladder per graph digest
  from measured per-route latencies
  (:class:`~bibfs_tpu_torch.serve.policy.AdaptiveRouter`).

Every result is a :class:`~bibfs_tpu_torch.solvers.api.BFSResult` whose
fields equal the JAX package's engine on the same queries; device
results carry the whole batch's wall clock in ``time_s`` (the
``solve_batch_graph`` convention), the batch mode that ran in ``mode``
and the batch's host reads in ``host_syncs``; cache hits carry ~0.

A flush reaches the card through the device route's two stages
(``DeviceRoute.launch`` / ``finish``: :meth:`QueryEngine._device_launch`
and :meth:`QueryEngine._device_finish`), which the synchronous engine
runs in turn and the pipelined engine
(:mod:`bibfs_tpu_torch.serve.pipeline`) overlaps across batches.

- **graph store** — ``store=`` serves a
  :class:`~bibfs_tpu_torch.store.GraphStore` instead of one inline graph:
  queries name a graph (``submit(s, d, graph="social")``), a graph with
  pending live updates answers exactly through its delta overlay
  (``route="overlay"``, uncached), and a hot-swapped snapshot is picked up
  at the next flush while flushes in flight finish on the snapshot they
  pinned (the swap barrier: :meth:`QueryEngine._pin_rt` and
  :meth:`QueryEngine._bound`).
- **distance oracle** — a landmark index (``oracle_k=`` on an inline
  graph, built in the constructor on the engine's device; or the store's
  per-graph index) answers at submit time, before the cache
  (``route="oracle"``), and hands the rest a proven upper bound that the
  serial host rung takes as a search cutoff.

- **query kinds** — ``submit_query`` takes the typed queries of
  :mod:`bibfs_tpu_torch.query`: a :class:`PointToPoint` rides the ladder
  above; ``MultiSource``, ``Weighted``, ``KShortest`` and ``AsOf`` queue
  for their kind routes (:mod:`bibfs_tpu_torch.serve.routes.taxonomy`) and
  resolve at the next flush, grouped per kind, each kind down its own
  ladder (a device rung on the card — the multi-source sweep,
  delta-stepping, the restricted batch BFS of Yen's iterations — ahead of
  its host-tier rung), results cached per (snapshot digest, query key) in
  the kind cache. The counts per kind and route show in
  ``stats()["query_kinds"]``. The whole-graph analytics kinds (``Sssp``,
  ``PageRank``, ``Components``, ``Triangles``;
  :mod:`bibfs_tpu_torch.serve.routes.analytics`) ride the same path, a
  blocked rung (the kernels of ``csrc/semiring.cu`` on the card) ahead of
  the host rung; on a store-backed engine their answers persist per
  snapshot digest in ``GraphStore.analytics``, which serves repeats
  (route ``store``) and maintains SSSP and components across adds-only
  updates.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from contextlib import contextmanager

import numpy as np

from bibfs_tpu_torch.obs.dtrace import stage_histogram
from bibfs_tpu_torch.obs.metrics import REGISTRY, MetricBank, next_instance_label
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.query.types import (
    AsOf,
    MultiSource,
    PointToPoint,
    Query,
    coerce_query,
)
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


def _solve_serial_cutoff_checked(n, row_ptr, col_ind, s, d, cutoff):
    """Cutoff-armed serial solve with the false-unreachable guard. A cutoff
    is armed at submit time against the live graph of that instant; a
    delete and a swap may land before the flush solves, and a stale bound
    can then only show as ``found=False`` (a found result's hops are a
    real path's length, never below the true distance). So a not-found
    answer is retried without the cutoff."""
    from bibfs_tpu_torch.solvers.serial import solve_serial_csr

    res = solve_serial_csr(n, row_ptr, col_ind, s, d, cutoff=cutoff)
    if cutoff is not None and not res.found:
        res = solve_serial_csr(n, row_ptr, col_ind, s, d)
    return res


def _mode_sources(mode: str, blocked: bool = False) -> tuple:
    """The CUDA sources (``ops/_cuda.SOURCES``) a flush in ``mode``
    launches kernels from: the batch-minor level for the minor layouts
    (``auto`` included), the pull kernels for the kernel modes (a batch
    runs ``fused``/``fused_alt`` as ``pallas``/``pallas_alt``), none for
    the torch-composed modes; plus the blocked kernel with the blocked
    rung."""
    from bibfs_tpu_torch.solvers.dense import DENSE_MODES

    extra = ("blocked_expand",) if blocked else ()
    if mode in BATCH_LAYOUT_MODES:
        return ("batch_minor",) + extra
    return (("pull_expand",) if DENSE_MODES[mode][2] else ()) + extra


def _engine_counter_bank(label: str) -> MetricBank:
    """The engine's query-accounting cells under the JAX package's family
    names. One bank per engine instance (``engine="sync-3"``), so
    per-engine ``stats()`` stays exact while a scrape sees every engine.
    The routes of later slices (oracle, overlay, mesh) are minted too and
    stay at zero."""
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

    def __init__(self, label: str, *, mesh: bool = False,
                 blocked: bool = False):
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
        pairs = [("device", "host"), ("host", "serial")]
        if blocked:
            # the blocked rung's two exits: the device rung, or straight
            # to the host when device is ineligible
            pairs = [("blocked", "device"), ("blocked", "host")] + pairs
        if mesh:
            # the mesh rung's exits: the next dispatch rung, or the host
            pairs = [("mesh", "device"), ("mesh", "host")] + pairs
            if blocked:
                pairs = [("mesh", "blocked")] + pairs
        self.fallbacks = {
            (a, b): fallbacks.labels(**{"engine": label, "from": a, "to": b})
            for a, b in pairs
        }
        self._retry_family = retries
        self._retry_cells = {
            "device": retries.labels(engine=label, route="device"),
        }
        if mesh:
            self._retry_cells["mesh"] = retries.labels(
                engine=label, route="mesh"
            )
        if blocked:
            self._retry_cells["blocked"] = retries.labels(
                engine=label, route="blocked"
            )
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
    sinking its batch). ``graph`` is the store graph the query is against
    (None on a store-less engine); ``cutoff`` the distance oracle's proven
    upper bound when it gave one (the serial host rung seeds its meet
    bound with it); ``query`` the typed query of a ticket of another kind
    than point-to-point (None for a ``(src, dst)`` ticket, whose ``src`` /
    ``dst`` are then its pair; else they hold a representative pair for
    error reporting); ``ctx`` the distributed-trace context
    (:mod:`bibfs_tpu_torch.obs.dtrace`) its ingress hop sampled, None on
    an unsampled query, where it costs one slot and nothing else."""

    __slots__ = ("src", "dst", "graph", "result", "error", "cutoff", "query",
                 "ctx")

    def __init__(self, src: int, dst: int, graph: str | None = None,
                 ctx=None):
        self.src = src
        self.dst = dst
        self.graph = graph
        self.result: BFSResult | None = None
        self.error: BaseException | None = None
        self.cutoff: int | None = None
        self.query = None
        self.ctx = ctx


@guarded_by("_lock", "_graph", "bucket_key", "_host_solver",
            "host_native_graph", "_serial_solver", "host_backend_resolved",
            "_blocked_graph", "blocked_bucket_key", "_blocked_meta",
            "_weights", "_wtables", "_awtabs", "mesh_shipped")
class _GraphRuntime:
    """Everything an engine knows about solving one immutable graph
    snapshot: the lazily built and uploaded device graph and its bucket
    key, the blocked tile table and its key, the host solvers (native /
    serial), and the distance-cache namespace ``graph_id`` (the
    snapshot's content digest unless the caller overrides it). An engine
    keeps one runtime per served graph name and builds a fresh one when
    the store hot-swaps the snapshot; a flush binds one runtime for its
    whole life (``QueryEngine._bound``)."""

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
        self._blocked_graph = None
        self.blocked_bucket_key = None
        self._blocked_meta = None
        # per weight seed: the CSR-aligned derived weights, the weighted
        # device rung's uploaded tables and the blocked SSSP rung's weight
        # tiles (weights_for, weighted_device_tables, analytics_weight_table)
        self._weights: dict = {}
        self._wtables: dict = {}
        self._awtabs: dict = {}
        # (pool, "1d" | "dp") -> (pool generation, key, host graph): the
        # mesh route's graphs shipped to a rank pool (mesh_graph, dp_graph)
        self.mesh_shipped: dict = {}

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

    def blocked_meta(self) -> tuple:
        """``(nblocks, bwidth, nnz_blocks)`` of the snapshot's blocked
        layout without building the table
        (:func:`bibfs_tpu_torch.graph.blocked.blocked_meta`, the build's
        grid math), so the blocked route's ``eligible()`` gates on tile
        compactness before anything is built."""
        m = self._blocked_meta
        if m is None:
            from bibfs_tpu_torch.graph.blocked import blocked_meta

            with self._lock:
                m = self._blocked_meta
                if m is None:
                    m = blocked_meta(self.n, self.snapshot.pairs)
                    self._blocked_meta = m
        return m

    def blocked_graph(self):
        """The blocked tile table on the engine's device, built from the
        snapshot's memoized :meth:`~bibfs_tpu_torch.store.snapshot.
        GraphSnapshot.blocked` layout and uploaded at the first
        blocked-routed flush (a runtime that never routes blocked never
        pays the tile build). On the card the upload also packs the tiles'
        rows one bit an entry (``BlockedDeviceGraph.bits``, an eighth of the
        table's bytes: what the analytics kernels read), so no
        analytics flush pays the packed copy's allocation."""
        g = self._blocked_graph
        if g is None:
            from bibfs_tpu_torch.graph.blocked import blocked_bucket_key
            from bibfs_tpu_torch.solvers.dense import BlockedDeviceGraph

            with self._lock:
                g = self._blocked_graph
                if g is None:
                    bg = self.snapshot.blocked()
                    g = BlockedDeviceGraph.from_host(bg, device=self._device)
                    if g.tab.is_cuda:
                        from bibfs_tpu_torch.ops.semiring_plane import (
                            pack_tile_rows,
                        )

                        g.bits = pack_tile_rows(g.tab)
                    self.blocked_bucket_key = blocked_bucket_key(bg)
                    self._blocked_graph = g
        return g

    def mesh_graph(self, route) -> tuple:
        """The mesh route's vertex-sharded graph of this snapshot on the
        route's rank pool: the serving ELL re-padded to the mesh size
        (:func:`~bibfs_tpu_torch.serve.buckets.repad_rows`), shipped at the
        first mesh-routed flush. Returns ``(pool key, host graph)``."""
        from bibfs_tpu_torch.serve.buckets import repad_rows

        return self._ship(route.pool, "1d", lambda: repad_rows(
            self.snapshot.ell(), route.ndev))

    def dp_graph(self, route) -> tuple:
        """The mesh route's data-parallel replica table of this snapshot,
        on the fine row ladder (:func:`~bibfs_tpu_torch.serve.buckets.
        dp_aligned_ell`), shipped at the first dp-routed flush. Returns
        ``(pool key, host graph)``."""
        from bibfs_tpu_torch.serve.buckets import dp_aligned_ell

        return self._ship(route.pool, "dp", lambda: dp_aligned_ell(
            self.n, pairs=self.snapshot.pairs))

    def _ship(self, pool, what: str, build) -> tuple:
        """Ship ``build()`` to ``pool`` once per pool generation (a respawn
        forgets every graph): saved into the pool's directory and
        registered on the ranks as a ``graph`` descriptor; the snapshot's
        retirement releases it there, so a hot swap ships the next
        snapshot's and frees this one's."""
        with self._lock:
            have = self.mesh_shipped.get((id(pool), what))
            if have is not None and have[0] == pool.generation:
                return have[1], have[2]
            import uuid

            from bibfs_tpu_torch.solvers.sharded import save_host_graph

            host = build()
            key = f"{self.snapshot.digest[:16]}-{what}-{uuid.uuid4().hex[:8]}"
            path = save_host_graph(host, os.path.join(pool.workdir, key))
            pool.graph(key, path)
            self.mesh_shipped[id(pool), what] = (pool.generation, key, host)
        self.snapshot.on_retire(lambda _s: pool.release(key, path))
        return key, host

    #: memoized weight derivations kept per runtime: each costs one
    #: float64 per CSR entry (or an uploaded table) and the seed is client
    #: input, so the memo is bounded (FIFO eviction)
    WEIGHT_SEEDS_MAX = 8

    def _per_seed(self, memo: dict, seed: int, make):
        """``make()`` memoized in ``memo`` under ``seed``: at most
        ``WEIGHT_SEEDS_MAX`` seeds, the oldest evicted first."""
        got = memo.get(seed)
        if got is None:
            with self._lock:
                got = memo.get(seed)
                if got is None:
                    got = make()
                    while len(memo) >= self.WEIGHT_SEEDS_MAX:
                        memo.pop(next(iter(memo)))  # insert order: FIFO
                    memo[seed] = got
        return got

    def weights_for(self, seed: int, row_ptr, col_ind) -> np.ndarray:
        """The snapshot's derived edge weights for one ``weight_seed``
        (:func:`bibfs_tpu_torch.query.weighted.synthetic_weights`),
        memoized per runtime. Only valid for the snapshot's own CSR (the
        weighted route derives afresh over an overlay-merged CSR)."""
        from bibfs_tpu_torch.query.weighted import synthetic_weights

        seed = int(seed)
        return self._per_seed(
            self._weights, seed,
            lambda: synthetic_weights(row_ptr, col_ind, seed))

    def weighted_device_tables(self, seed: int):
        """The weighted device rung's relaxation tables for one
        ``weight_seed`` (:func:`bibfs_tpu_torch.solvers.query_device.
        delta_tables` over the snapshot's serving ELL) on the engine's
        device, memoized like :meth:`weights_for`: one upload per
        (snapshot, seed), freed with the runtime on a hot-swap."""
        from bibfs_tpu_torch.solvers.query_device import delta_tables

        seed = int(seed)
        return self._per_seed(
            self._wtables, seed,
            lambda: delta_tables(self.snapshot.ell(), seed,
                                 device=self._device))

    def analytics_weight_table(self, seed: int):
        """The blocked SSSP rung's float32 weight tile table for one
        ``weight_seed`` (:func:`bibfs_tpu_torch.graph.blocked.
        build_blocked_weights` over the snapshot's memoized blocked layout)
        on the engine's device, memoized like :meth:`weights_for`: one
        build and upload per (snapshot, seed), freed with the runtime on a
        hot-swap."""
        import torch

        from bibfs_tpu_torch.graph.blocked import build_blocked_weights

        seed = int(seed)
        return self._per_seed(
            self._awtabs, seed,
            lambda: torch.from_numpy(build_blocked_weights(
                self.snapshot.blocked(), self.snapshot.pairs, seed=seed,
            )).to(self._device))

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
                    # the native search has no seed seam: it ignores the
                    # oracle's cutoff
                    self._host_solver = (
                        lambda s, d, cutoff=None: solve_native_graph(ng, s, d)
                    )
                    return self._host_solver
                except OSError:
                    if backend == "native":
                        raise
            self._host_solver = self._serial_csr_solver()
            self.host_backend_resolved = "serial"
            return self._host_solver

    def _serial_csr_solver(self):
        row_ptr, col_ind = self.snapshot.csr()
        return lambda s, d, cutoff=None: _solve_serial_cutoff_checked(
            self.n, row_ptr, col_ind, s, d, cutoff
        )

    def solve_serial_one(self, src: int, dst: int,
                         cutoff: int | None = None) -> BFSResult:
        """The bottom of the fallback ladder: the NumPy serial oracle over
        the snapshot's CSR (seeded with the oracle's ``cutoff`` when
        given)."""
        if self._serial_solver is None:
            with self._lock:
                if self._serial_solver is None:
                    if (self.host_backend_resolved == "serial"
                            and self._host_solver is not None):
                        # the host route already IS the serial oracle
                        self._serial_solver = self._host_solver
                    else:
                        self._serial_solver = self._serial_csr_solver()
        return self._serial_solver(int(src), int(dst), cutoff=cutoff)


@guarded_by("_rt_lock", "_runtimes", "_rts_released")
class QueryEngine:
    """Serve ``(src, dst)`` shortest-path queries over one graph.

    Parameters
    ----------
    n, edges : the graph (same contract as ``api.solve``); ``pairs``
        optionally passes a precomputed ``canonical_pairs`` result.
        Internally the graph becomes an immutable
        :class:`~bibfs_tpu_torch.store.snapshot.GraphSnapshot`.
    store, graph : serve a :class:`~bibfs_tpu_torch.store.GraphStore`
        instead of one inline graph: ``store=`` (exclusive with
        ``n``/``edges``/``pairs``) attaches it, ``graph=`` names the
        default graph (default: the store's). Queries then take a graph
        name, live edge updates answer exactly through the store's delta
        overlay, and a hot-swapped snapshot is picked up at the next flush
        while flushes in flight finish on the version they started on.
    mode : batch mode of device flushes (default ``"auto"``: ``minor8``
        where the graph and batch fit, else ``minor``, else the lock-step
        ``sync`` batch); any mode of :func:`~bibfs_tpu_torch.solvers.dense.
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
    oracle_k : landmarks of an engine-local distance oracle over the
        inline graph (:mod:`bibfs_tpu_torch.oracle`), built in the
        constructor on the engine's device (the multi-source BFS kernel on
        the card). It is consulted before the distance cache on every
        submit: exact answers resolve with no solver (``route="oracle"``,
        ``path=None``), and an upper bound arms the serial host rung's
        cutoff. A store-backed engine reads the store's oracles
        (``GraphStore(oracle_k=...)``), so ``oracle_k`` with ``store=`` is
        an error.
    graph_id : distance-cache namespace override of the default graph
        (default: the snapshot's content digest, which equals the JAX
        package's). On a store-backed engine it holds until that graph's
        first hot-swap; the replacement runtime reverts to the digest.
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
    blocked : enable ``route="blocked"``, the blocked tile expansion
        (:mod:`bibfs_tpu_torch.serve.routes.blocked`): ``True`` or a
        :class:`~bibfs_tpu_torch.serve.routes.BlockedConfig`. The rung
        sits ahead of device (``blocked -> device -> host``) with its own
        circuit breaker, retry policy and chaos sites; eligibility is the
        batch crossover and the tile-compactness gate (the platform's
        ``blocked`` calibration block, else 128 queries and a waste cap of
        128). On a CUDA engine the constructor builds the blocked kernel.
        Default None: no blocked rung.
    adaptive : per-digest adaptive routing
        (:class:`~bibfs_tpu_torch.serve.policy.AdaptiveRouter`): ``True``
        learns the ladder's order from measured per-route latencies and
        sampled level telemetry, in memory, or over a durable store in the
        sidecar ``policy.json`` of its ``wal_dir`` (saved every few notes
        and at close, loaded by the next engine there); pass a ready
        ``AdaptiveRouter`` to share one across engines or to persist it at
        a ``path``.
        Default None: the static ladder.
    mesh : enable ``route="mesh"`` (:mod:`bibfs_tpu_torch.serve.routes.
        mesh`): a rank count, ``"auto"`` (every card; one rank on the CPU)
        or a :class:`~bibfs_tpu_torch.serve.routes.MeshConfig`. The
        constructor starts a pool of that many ranks on the engine's device
        (NCCL with a card each, staged gloo for ranks sharing a card, gloo
        on the CPU; ``MeshConfig(pool=...)`` shares a running one), and the
        mesh rung leads the ladder (``mesh -> device -> host``) with its own
        circuit breaker and retry policy. Below-crossover flushes (the
        platform's ``mesh`` calibration block, else the defaults) go on to
        the single-device rungs, counted in
        ``bibfs_mesh_crossover_reroutes_total``. ``close()`` closes the
        engine's own pool. Default None: no mesh rung.
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
        if oracle_k is not None:
            if store is not None:
                raise ValueError(
                    "oracle_k configures an engine-local oracle over an "
                    "inline graph; a store-backed engine's oracles come "
                    "from the store (GraphStore(oracle_k=...))"
                )
            if int(oracle_k) < 1:
                raise ValueError(f"oracle_k must be >= 1, got {oracle_k}")
        if store is not None:
            if n is not None or edges is not None or pairs is not None:
                raise ValueError(
                    "pass the graph inline (n, edges/pairs) OR store=, "
                    "not both"
                )
        elif graph is not None:
            raise ValueError("graph= names a store graph; pass store=")
        elif n is None:
            raise ValueError("n (and edges/pairs) required without store=")
        from bibfs_tpu_torch.serve.routes import BlockedConfig

        self._blocked_cfg = (
            None if not blocked else BlockedConfig.coerce(blocked)
        )
        if adaptive is not None and not isinstance(adaptive, bool):
            from bibfs_tpu_torch.serve.policy import AdaptiveRouter

            if not isinstance(adaptive, AdaptiveRouter):
                raise ValueError(
                    "adaptive= takes True/None or an AdaptiveRouter; "
                    f"got {adaptive!r}"
                )
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

            sources = _mode_sources(mode, self._blocked_cfg is not None)
            if mesh is not None:  # the ranks launch these (fused: both)
                sources += ("batch_minor", "pull_expand", "fused_level")
            for source in sources + (("msbfs",) if oracle_k else ()):
                _cuda.lib(source)
        # the mesh config and its pool (started here, after every check
        # above and before the store pin: a bad rank count or a failed
        # NCCL start raises without leaking a pin)
        self._mesh_cfg = None
        self._mesh_pool = None
        self._mesh_pool_owned = False
        mesh_pre = None
        if mesh is not None:
            from bibfs_tpu_torch.serve.routes import MeshConfig, mesh_prebuild

            self._mesh_cfg = MeshConfig.coerce(mesh)
            mesh_pre = mesh_prebuild(self._mesh_cfg, self._device)
            self._mesh_pool, self._mesh_pool_owned = mesh_pre
        from bibfs_tpu_torch.solvers.batch_minor import small_batch_threshold

        try:
            # the store pin comes after every check that can raise: a raise
            # past it would leak the pin and the snapshot would never retire
            self._store = store
            if store is not None:
                self._default_name = (
                    store.default_graph() if graph is None else str(graph)
                )
                try:
                    # the engine's pin
                    snap = store.acquire(self._default_name)
                except KeyError as e:
                    raise ValueError(str(e)) from e
            else:
                snap = GraphSnapshot.build(n, edges, pairs=pairs)
                self._default_name = None
            self.mode = mode
            self.layout = layout
            self.flush_threshold = (
                small_batch_threshold(self._device.type)
                if flush_threshold is None else int(flush_threshold)
            )
            self.max_batch = bucket_batch(max_batch)
            self._host_backend = host_backend
            # one runtime per served graph name; a hot-swap replaces it at the
            # next resolution while bound flushes finish on the old one
            self._rt_lock = threading.RLock()
            self._flush_tls = threading.local()
            self._rts_released = False
            self._runtimes: dict = {
                self._default_name: _GraphRuntime(
                    snap, layout=layout, device=self._device,
                    host_backend=host_backend, graph_id=graph_id,
                )
            }
            self.obs_label = (
                next_instance_label(self._OBS_PREFIX) if obs_label is None
                else obs_label
            )
            # the engine-local oracle over the inline graph (a store-backed
            # engine reads the store's per-graph oracles at submit time)
            self._oracle = None
            if oracle_k is not None:
                from bibfs_tpu_torch.oracle import DistanceOracle, build_index

                row_ptr, col_ind = snap.csr()
                self._oracle = DistanceOracle(
                    build_index(
                        snap.n, row_ptr, col_ind, int(oracle_k),
                        digest=snap.digest, version=snap.version,
                        device=self._device,
                    ),
                    metrics_label=self.obs_label,
                )
            self.dist_cache = (
                DistanceCache(entries=cache_entries,
                              metrics_label=self.obs_label)
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
            self._res_cells = _ResilienceCells(
                self.obs_label, mesh=self._mesh_cfg is not None,
                blocked=self._blocked_cfg is not None
            )
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
            self._health_window_s = health_window_s
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
            from bibfs_tpu_torch.serve.routes import (
                KindResultCache,
                QueryKindCells,
                build_routes,
            )

            # the query kinds' counts and result cache (serve/routes/
            # taxonomy.py), minted before the routes so that every family the
            # kind routes touch renders at zero from construction
            self._query_cells = QueryKindCells(self.obs_label)
            self._kind_cache = KindResultCache()
            self.routes, self._ladder = build_routes(
                self, self._mesh_cfg, mesh_pre, self._blocked_cfg
            )
            # adaptive routing (serve/policy.py): the ladder's order learned
            # per graph digest, persisted beside a durable store's checkpoints
            # so that a respawn serves its first flush on the learned route
            self._policy = None
            if adaptive:
                from bibfs_tpu_torch.serve.policy import (
                    POLICY_SIDECAR,
                    AdaptiveRouter,
                )

                if isinstance(adaptive, bool):
                    wal_dir = getattr(store, "wal_dir", None)
                    self._policy = AdaptiveRouter(
                        label=self.obs_label, routes=self._ladder,
                        path=(None if wal_dir is None
                              else os.path.join(wal_dir, POLICY_SIDECAR)),
                    )
                else:
                    self._policy = adaptive
            # direct cell handles for the per-query submit path
            self._c_queries = self.counters.cell("queries")
            self._c_trivial = self.counters.cell("trivial")
            self._c_oracle = self.counters.cell("oracle_served")
            self._c_cache_served = self.counters.cell("cache_served")
            self._c_host_queries = self.counters.cell("host_queries")
            self._c_overlay = self.counters.cell("overlay_queries")
            # the per-query stage histogram, minted so it renders at zero; the
            # pipelined engine records into it (the synchronous engine has no
            # stages of its own)
            self._stage_cells = stage_histogram()
            self._stage_acc: dict = {}
            # the sampled trace context of the flush being walked down the
            # ladder (the first sampled ticket's), for routes that carry it
            # across a process hop
            self._launch_ctx = None
        except BaseException:
            # close a pool this engine owns: nothing else would
            if self._mesh_pool_owned:
                self._mesh_pool.close()
            raise

    def _note_stage(self, route: str, stage: str, dur_s: float,
                    n: int = 1, record: bool = True) -> None:
        """Record ``dur_s`` against one serving stage: the per-route,
        per-stage sums ``stats()["stages"]`` reports, plus one
        ``bibfs_stage_seconds{stage}`` sample unless ``record=False`` (a
        multi-query sum histogrammed per query elsewhere). Callers on
        concurrent threads hold the engine lock."""
        if record:
            self._stage_cells[stage].record(dur_s)
        acc = self._stage_acc.setdefault(route, {})
        cell = acc.get(stage)
        if cell is None:
            acc[stage] = [n, dur_s]
        else:
            cell[0] += n
            cell[1] += dur_s

    # ---- graph resolution (the store seam) ---------------------------
    def _graph_rt(self, name) -> _GraphRuntime:
        """The runtime serving ``name``'s current snapshot. On a version
        change (a hot-swap) build a fresh runtime and release the old one
        (its distance-cache namespace is invalidated; its snapshot retires
        once in-flight flush pins drop)."""
        if self._store is None:
            return self._runtimes[None]
        rt = self._runtimes.get(name)
        if self._rts_released:  # post-close stats(): no new pins
            if rt is None:
                raise ValueError("engine is closed")
            return rt
        if rt is not None and rt.snapshot is self._store.current(name):
            return rt  # the hot path: same version, no lock
        with self._rt_lock:
            rt = self._runtimes.get(name)
            snap = self._store.acquire(name)
            if rt is not None and rt.snapshot is snap:
                snap.release()
                return rt
            new = _GraphRuntime(
                snap, layout=self.layout, device=self._device,
                host_backend=self._host_backend,
            )
            self._runtimes[name] = new
            if rt is not None:
                old_id = rt.graph_id
                rt.snapshot.release()
                if old_id != new.graph_id:
                    # digest keys already make the old entries unreachable;
                    # reclaim their rows now
                    self.dist_cache.invalidate(old_id)
                    self._kind_cache.invalidate(old_id)
            return new

    def _resolve_graph(self, graph) -> tuple:
        """``(name, runtime)`` for a submit-time graph argument; a client
        mistake (an unknown name, a name without a store) is a
        ``ValueError``, so ``return_errors`` tags it invalid."""
        if graph is None:
            name = self._default_name
        elif self._store is None:
            raise ValueError(
                "per-query graph names need an attached store (store=)"
            )
        else:
            name = str(graph)
        try:
            return name, self._graph_rt(name)
        except KeyError as e:
            raise ValueError(str(e)) from e

    def _pin_rt(self, name=None) -> _GraphRuntime:
        """Resolve and pin in one step, under the runtime lock, so a
        concurrent swap cannot retire the snapshot between the two. The
        caller owes one ``snapshot.release()`` (or hands the pin to
        :meth:`_bound`)."""
        with self._rt_lock:
            rt = self._graph_rt(name)
            rt.snapshot.retain()
        if self._store is not None:
            self._store.touch(name)
        return rt

    @contextmanager
    def _bound(self, rt: _GraphRuntime):
        """Make ``rt`` the calling thread's flush target: everything in the
        block (device launch, host solves, banking, cache namespacing)
        reads this runtime through the engine's graph properties, whatever
        the store swaps to meanwhile. Consumes one snapshot pin
        (:meth:`_pin_rt`)."""
        tls = self._flush_tls
        prev = getattr(tls, "rt", None)
        tls.rt = rt
        try:
            yield rt
        finally:
            tls.rt = prev
            rt.snapshot.release()

    def _current_rt(self) -> _GraphRuntime:
        """The thread's bound flush runtime, else the default graph's
        current one: what the graph properties and solver seams read."""
        rt = getattr(self._flush_tls, "rt", None)
        return rt if rt is not None else self._graph_rt(self._default_name)

    def _overlay_pending(self, name):
        """The graph's pending delta overlay (None when absent): while one
        exists, queries answer exactly through it and the distance cache
        stands aside (its entries describe the base snapshot)."""
        if self._store is None:
            return None
        return self._store.overlay(name)

    def _oracle_for(self, name):
        """The distance oracle serving ``name`` now, or None: the store's
        per-graph oracle (its generation check guarantees it describes the
        current live edges, pending overlay included, which is why the
        consult may run before the overlay route), else the engine-local
        one."""
        if self._store is None:
            return self._oracle
        return self._store.oracle(name)

    def _consult_oracle(self, t: _Pending, name) -> bool:
        """Consult the oracle for one submitted query
        (:class:`~bibfs_tpu_torch.serve.routes.OracleRoute`): True when it
        served the query exactly; False to fall through (with
        ``t.cutoff`` armed when it gave an upper bound)."""
        return self.routes["oracle"].consult(t, name)

    @property
    def n(self) -> int:
        """Vertex count of the bound flush graph (outside a flush: the
        default graph's current snapshot)."""
        return self._current_rt().n

    @property
    def graph(self):
        """The bucketed device-resident graph (built on first use)."""
        return self._current_rt().graph

    @property
    def graph_id(self):
        return self._current_rt().graph_id

    @property
    def _bucket_key(self):
        return self._current_rt().bucket_key

    @property
    def _host_native_graph(self):
        return self._current_rt().host_native_graph

    @property
    def host_backend_resolved(self):
        return self._current_rt().host_backend_resolved

    # ---- submission --------------------------------------------------
    def submit(self, src: int, dst: int, graph: str | None = None,
               ctx=None) -> _Pending:
        """Queue one query (``graph`` names a store graph on a store-backed
        engine; None: the default graph). Oracle answers, cache hits and
        trivial queries resolve immediately; everything else resolves at
        the next flush (an overfull queue flushes itself at
        ``max_batch``). ``ctx`` is a sampled distributed-trace context
        (:mod:`bibfs_tpu_torch.obs.dtrace`) that rides the ticket; None
        (the default) adds no work."""
        self._check_open((int(src), int(dst)))
        src, dst = int(src), int(dst)
        name, rt = self._resolve_graph(graph)
        if not (0 <= src < rt.n and 0 <= dst < rt.n):
            raise ValueError(f"src/dst out of range for n={rt.n}")
        t = _Pending(src, dst, name, ctx)
        self._c_queries.inc()
        if src == dst:
            self._c_trivial.inc()
            t.result = BFSResult(True, 0, [src], src, 0.0, 0, 0)
            return t
        # the oracle answers before the distance cache and the overlay
        if self._consult_oracle(t, name):
            self._c_oracle.inc()
            return t
        if self._overlay_pending(name) is not None:
            hit = None
        else:
            # re-resolve after the overlay read: a compaction commits
            # (overlay gone, snapshot k + 1) atomically, so a runtime
            # resolved before it and an overlay read after it would serve
            # a stale version-k entry
            rt = self._graph_rt(name)
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

    @staticmethod
    def _query_rep_pair(q: Query) -> tuple[int, int]:
        """A representative ``(src, dst)`` for a typed query: what error
        messages and pair-targeted chaos rules key on."""
        rep = getattr(q, "rep_pair", None)
        if rep is not None:  # the whole-graph analytics kinds declare one
            return rep()
        if isinstance(q, AsOf):
            return QueryEngine._query_rep_pair(q.inner)
        if isinstance(q, MultiSource):
            return int(q.sources[0]), int(q.dst)
        return int(q.src), int(q.dst)

    def _check_open(self, query) -> None:
        """Refuse a submit on a closed engine, and on a draining one with
        a structured capacity error (retryable on a peer; not counted as
        an engine error) naming ``query``."""
        if self._rts_released:
            raise ValueError("engine is closed")
        if self._draining:
            raise QueryError(
                "engine is draining", kind="capacity", query=query,
            )

    def submit_query(self, q, graph: str | None = None) -> _Pending:
        """Submit one typed query (:mod:`bibfs_tpu_torch.query`): a
        :class:`PointToPoint` (or a bare pair) delegates to :meth:`submit`;
        the other kinds are validated, counted and looked up in the kind
        cache (per snapshot digest and query key, on a graph with no
        pending updates) and, for an analytics kind, in the store's
        whole-graph result store (:meth:`_consult_analytics_store`), then
        handed to :meth:`_take_kind`: here they queue for their kind
        routes and resolve at the next flush, grouped per kind (the
        flush's multi-source queries share their sweeps)."""
        q = coerce_query(q)
        if isinstance(q, PointToPoint):
            self._query_cells.cell("pt", "ladder").inc()
            return self.submit(q.src, q.dst, graph)
        src, dst = self._query_rep_pair(q)
        self._check_open((src, dst))
        name, rt = self._resolve_graph(graph)
        q.validate(rt.n)
        t = self._kind_ticket(src, dst, name)
        t.query = q
        overlay = self._overlay_pending(name)
        hit = None
        if overlay is None:
            # overlay read, then resolve (the swap-race-safe order of
            # submit); while updates are pending the cache stands aside
            rt = self._graph_rt(name)
            hit = self._kind_cache.lookup(rt.graph_id, q.cache_key())
            if hit is not None:
                self._query_cells.cell(q.kind, "cache").inc()
            else:
                hit = self._consult_analytics_store(name, rt, q)
        return self._take_kind(t, overlay, hit)

    def _kind_ticket(self, src: int, dst: int, name) -> _Pending:
        """A counted ticket for a typed query."""
        self._c_queries.inc()
        return _Pending(src, dst, name)

    def _take_kind(self, t: _Pending, overlay, hit) -> _Pending:
        """A typed query's ticket after admission: answered from the kind
        cache's ``hit``, else queued for the next flush (an overfull queue
        flushes itself at ``max_batch``)."""
        if hit is not None:
            t.result = hit
            return t
        self._pending.append(t)
        if len(self._pending) >= self.max_batch:
            self.flush()
        return t

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
        """Resolve every pending query, grouped per graph, each group bound
        to the snapshot it resolves at flush start (the swap barrier):
        batched device dispatch at or above the crossover, per-query host
        dispatch below, exact overlay solves while the graph has pending
        live updates."""
        pend, self._pending = self._pending, []
        if not pend:
            return
        if self._store is None:
            self._flush_graph(None, pend)
            return
        groups: dict = {}
        for t in pend:
            groups.setdefault(t.graph, []).append(t)
        for name, group in groups.items():
            self._flush_graph(name, group)

    def _flush_graph(self, name, pend) -> None:
        # the overlay read comes BEFORE the pin: a compaction commits (new
        # snapshot, no overlay) atomically, so pin-then-read could pin the
        # old snapshot and read no overlay, serving without the folded
        # delta. Read-then-pin is safe both ways: an overlay answers on its
        # own base whatever is swapped meanwhile, and no overlay means the
        # pin taken after the read is the compacted (or a newer) snapshot.
        overlay = self._overlay_pending(name)
        rt = self._pin_rt(name)
        with self._bound(rt), span("flush", queued=len(pend)):
            tax = [t for t in pend if t.query is not None]
            if tax:
                pend = [t for t in pend if t.query is None]
                self._flush_taxonomy(name, tax, overlay)
                if not pend:
                    return
            # dedupe exact repeats within one flush: a batch slot per
            # duplicate would be pure waste
            unique: dict[tuple[int, int], list[_Pending]] = {}
            for t in pend:
                unique.setdefault((t.src, t.dst), []).append(t)
            pairs = list(unique)
            if overlay is not None:
                self._flush_overlay(overlay, pairs, unique)
                return
            # the flush's sampled trace context (the first sampled
            # ticket's: one per batch, not per query) rides on the engine
            # for the ladder walk
            self._launch_ctx = next(
                (t.ctx for t in pend if t.ctx is not None), None
            )
            try:
                for i in range(0, len(pairs), self.max_batch):
                    self._flush_ladder(pairs[i: i + self.max_batch], unique)
            finally:
                self._launch_ctx = None

    def _flush_overlay(self, overlay, pairs, unique) -> None:
        """Exact answering while live edge updates are pending
        (:class:`~bibfs_tpu_torch.serve.routes.OverlayRoute`): every query
        solves against base + delta on the host, isolated per query, with
        no cache lookup or banking (the overlaid graph is no snapshot)."""
        with span("overlay_batch", batch=len(pairs)):
            for key, res in self.routes["overlay"].solve_iter(overlay, pairs):
                if isinstance(res, QueryError):
                    self._resolve_error(unique[key], res)
                    continue
                self._c_overlay.inc()
                for t in unique[key]:
                    t.result = res

    # ---- query kinds (serve/routes/taxonomy.py) ------------------------
    def _flush_taxonomy(self, name, tickets, overlay) -> None:
        """Resolve this flush's typed tickets against the flush-bound
        truth: the snapshot's memoized CSR, or the overlay-merged live CSR
        while edge updates are pending (every kind answers exactly on the
        live edge set; the kind cache and the device rungs stand aside
        there). Kinds are grouped, so the multi-source rungs pack the whole
        flush's sources into shared sweeps."""
        from bibfs_tpu_torch.serve.routes import KindCtx

        rt = self._current_rt()
        if overlay is not None:
            from bibfs_tpu_torch.graph.csr import build_csr

            row_ptr, col_ind = build_csr(rt.n, overlay.merged_edges())
            ctx = KindCtx(rt.n, row_ptr, col_ind, base=False,
                          name=name, graph_id=rt.graph_id)
        else:
            row_ptr, col_ind = rt.snapshot.csr()
            ctx = KindCtx(rt.n, row_ptr, col_ind, base=True,
                          name=name, graph_id=rt.graph_id)
        groups: dict[str, list[_Pending]] = {}
        for t in tickets:
            groups.setdefault(t.query.kind, []).append(t)
        for kind in sorted(groups):
            self._flush_kind(kind, groups[kind], rt, ctx)

    def _flush_kind(self, kind, tickets, rt, ctx) -> None:
        """One kind group down its ladder
        (:data:`~bibfs_tpu_torch.serve.routes.taxonomy.KIND_LADDERS`: the
        device rung ahead of the host-tier kind rung): each eligible rung
        gets a resilient :meth:`~bibfs_tpu_torch.serve.routes.base.Route.
        attempt`, an ineligible one is skipped (a routing decision), an
        unavailable one degrades to the next, counted in
        ``bibfs_route_fallbacks_total``, down to the kind's per-query
        isolated ``fallback``. A failure a rung may not degrade (a device
        rung's on a CUDA engine, anything but an injected fault) fails the
        group's tickets with its :class:`QueryError`. The walk order is the
        adaptive policy's per-(digest, kind) decision when the engine runs
        adaptive."""
        from bibfs_tpu_torch.serve.routes import KIND_LADDERS, KIND_ROUTES

        ladder = KIND_LADDERS[kind]
        # dedupe identical queries within the flush (cache_key is the
        # exact-repeat identity)
        unique: dict[tuple, list[_Pending]] = {}
        for t in tickets:
            unique.setdefault(t.query.cache_key(), []).append(t)
        queries = [unique[k][0].query for k in unique]
        if self._policy is not None:
            ladder, _why = self._policy.order(
                rt.snapshot.digest, len(queries), ladder, kind=kind
            )
        results = None
        used = "host"
        t0 = time.perf_counter()
        for i, rung in enumerate(ladder):
            if rung == "host":
                break
            route = self.routes[rung]
            if not route.kind_eligible(rt, queries, ctx):
                continue
            try:
                results = route.attempt(rt, queries, ctx)
            except Exception as exc:
                # a failure the rung may not degrade: the group's tickets
                # fail, none is answered by a lower rung
                for key, q in zip(unique, queries):
                    self._resolve_error(unique[key], to_query_error(
                        exc, self._query_rep_pair(q)))
                return
            if results is not None:
                used = rung
                break
            self._note_fallback(
                rung, self._next_kind_rung(ladder, i, rt, queries, ctx)
            )
        if results is None:
            results = self.routes[KIND_ROUTES[kind]].fallback(
                rt, queries, ctx
            )
        elapsed = time.perf_counter() - t0
        if self._policy is not None:
            # whole-rung wall time (no solver-stamped batch clock here)
            self._policy.note(
                rt.snapshot.digest, used, len(queries), elapsed, kind=kind,
            )
        cell = self._query_cells.cell(kind, used)
        for key, res in zip(unique, results):
            ts = unique[key]
            if isinstance(res, QueryError):
                self._resolve_error(ts, res)
                continue
            cell.inc(len(ts))
            if ctx.base:
                self._kind_cache.put(ctx.graph_id, key, res)
                self._analytics_store_put(kind, rt, ctx, key, res)
            for t in ts:
                t.result = res

    def _analytics_store_put(self, kind, rt, ctx, key, res) -> None:
        """Persist a freshly computed whole-graph analytics answer into the
        store's per-digest result store (analytics/results.py), the
        counterpart of the submit-time consult. Base-snapshot answers only
        (the caller gates on ``ctx.base``); inline engines have no store."""
        if self._store is None:
            return
        from bibfs_tpu_torch.analytics.queries import ANALYTICS_KINDS

        if kind not in ANALYTICS_KINDS:
            return
        from bibfs_tpu_torch.analytics.results import result_to_payload

        arrays, scalars = result_to_payload(kind, res)
        self._store.analytics.put(
            ctx.name, key, rt.snapshot.digest, kind, arrays, scalars
        )

    def _consult_analytics_store(self, name, rt, q):
        """The submit-time whole-graph result-store consult (after a
        kind-cache miss, only while no overlay is pending: stored entries
        describe settled snapshots). An exact-digest entry is served as
        ``route="store"``; an entry whose digest reaches the current one
        through adds-only deltas is maintained incrementally
        (decrease-only SSSP relaxation / component re-merge), committed
        back retagged, and served. Returns the result, or None to go on to
        the flush."""
        if self._store is None:
            return None
        from bibfs_tpu_torch.analytics.queries import ANALYTICS_KINDS

        if q.kind not in ANALYTICS_KINDS:
            return None
        store = self._store.analytics
        digest = rt.snapshot.digest
        found = store.lookup(name, q.cache_key(), digest)
        if found is None:
            return None
        from bibfs_tpu_torch.analytics.queries import (
            ComponentsResult,
            SsspResult,
        )
        from bibfs_tpu_torch.analytics.results import (
            maintain_components,
            maintain_sssp,
            result_from_payload,
            result_to_payload,
        )

        t0 = time.perf_counter()
        if found[0] == "hit":
            res = result_from_payload(
                q.kind, found[1].arrays, found[1].scalars
            )
        else:
            _tag, entry, adds = found
            row_ptr, col_ind = rt.snapshot.csr()
            if q.kind == "sssp":
                seed = int(q.weight_seed)
                w = rt.weights_for(seed, row_ptr, col_ind)
                dist, _relaxed = maintain_sssp(
                    entry.arrays["dist"], adds, rt.n, row_ptr, col_ind,
                    w, seed,
                )
                res = SsspResult(
                    found=True, dist=dist,
                    reached=int(np.isfinite(dist).sum()),
                    rounds=int(entry.scalars.get("rounds", 0)),
                    time_s=time.perf_counter() - t0,
                )
            else:  # components: lookup() only offers maintainable kinds
                labels, count = maintain_components(
                    entry.arrays["labels"], adds, rt.n
                )
                res = ComponentsResult(
                    found=True, labels=labels, count=count,
                    rounds=int(entry.scalars.get("rounds", 0)),
                    time_s=time.perf_counter() - t0,
                )
            arrays, scalars = result_to_payload(q.kind, res)
            store.commit_maintained(
                name, q.cache_key(), digest, q.kind, arrays, scalars
            )
        self._query_cells.cell(q.kind, "store").inc()
        self._kind_cache.put(rt.graph_id, q.cache_key(), res)
        return res

    def _next_kind_rung(self, ladder, i: int, rt, queries, ctx) -> str:
        """The rung a failed kind-ladder step degrades TO (the ``to`` label
        of the fallback counter; the kind ladder's :meth:`_next_rung`)."""
        for name in ladder[i + 1:]:
            if name == "host" or self.routes[name].kind_eligible(
                rt, queries, ctx
            ):
                return name
        return "host"

    def _next_rung(self, i: int, rt, pairs, ladder=None) -> str:
        """The rung a failed ladder step actually degrades TO (the ``to``
        label of the fallback counter): the next rung of ``ladder`` (the
        static one by default) that is terminal or eligible."""
        ladder = self._ladder if ladder is None else ladder
        for name in ladder[i + 1:]:
            if name == "host" or self.routes[name].eligible(rt, pairs):
                return name
        return "host"

    def _ladder_for(self, rt, pairs):
        """The ladder this flush walks: the adaptive policy's per-digest
        order (:meth:`~bibfs_tpu_torch.serve.policy.AdaptiveRouter.order`,
        counted in ``bibfs_routes_adaptive_total``) when the engine runs
        adaptive, else the static ladder."""
        if self._policy is None:
            return self._ladder
        order, _reason = self._policy.order(
            rt.snapshot.digest, len(pairs), self._ladder
        )
        return order

    def _note_route_time(self, rt, route: str, pairs, seconds) -> None:
        """Feed the adaptive policy one resolved batch's measurement, plus
        its periodic level-shape sample: one telemetry-enabled serial
        solve of the batch's first pair, recording push/pull choices and
        frontier fractions into the per-digest policy and the
        ``bibfs_level_frontier_fraction`` histogram. The sample runs on a
        background thread with its own snapshot pin, so a serial search
        on a large graph never stalls a flush (or the pipelined engine's
        finish worker)."""
        if self._policy is None:
            return
        digest = rt.snapshot.digest
        if not self._policy.note(digest, route, len(pairs), seconds):
            return
        try:
            snap = rt.snapshot.retain()
        except RuntimeError:
            # racing retirement: skip this sample and release the claimed
            # slot, or sampling stops for good
            self._policy.sample_done()
            return
        policy = self._policy
        n = rt.n
        src, dst = (int(v) for v in pairs[0])

        def _sample():
            try:
                from bibfs_tpu_torch.obs.telemetry import LevelTelemetry
                from bibfs_tpu_torch.solvers.serial import solve_serial_csr

                tel = LevelTelemetry(n=n)
                row_ptr, col_ind = snap.csr()
                solve_serial_csr(n, row_ptr, col_ind, src, dst, telemetry=tel)
                policy.observe_levels(digest, tel.as_dict(), n)
            except Exception:
                pass  # a diagnostic sample must never fail anything
            finally:
                snap.release()
                policy.sample_done()  # release the one-in-flight slot

        threading.Thread(
            target=_sample, name="bibfs-policy-sample", daemon=True
        ).start()

    def _note_crossover(self) -> None:
        """A below-crossover batch skipped the mesh rung: a routing
        decision, counted apart from failures."""
        mesh = self.routes.get("mesh")
        if mesh is not None:
            mesh.cells.reroutes.inc()

    def _flush_ladder(self, pairs, unique) -> None:
        """Walk the fallback ladder for one chunk: each eligible rung gets
        a resilient :meth:`~bibfs_tpu_torch.serve.routes.base.Route.
        attempt` (bounded retries behind its breaker); an unavailable rung
        degrades to the next, counted in ``bibfs_route_fallbacks_total``,
        and the terminal host rung absorbs whatever is left behind its
        bisection isolator. A sub-crossover chunk skips the dispatch rungs
        (a routing decision, not a degrade). A rung failure the engine may
        not degrade (:meth:`_may_degrade`) fails the chunk's tickets
        instead. The walk order is the adaptive policy's when the engine
        runs adaptive, and each resolved chunk feeds it its time."""
        rt = self._current_rt()
        ladder = self._ladder_for(rt, pairs)
        for i, name in enumerate(ladder):
            if name == "host":
                break
            route = self.routes[name]
            if not route.eligible(rt, pairs):
                if name == "mesh":
                    self._note_crossover()
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
                # the batch's own clock (launch to finish), not the
                # attempt's wall time: retry backoff would bias the route
                self._note_route_time(rt, name, pairs, results[0].time_s)
                for j, (src, dst) in enumerate(pairs):
                    self._resolve(unique[(src, dst)], src, dst, results[j])
                return
            self._note_fallback(name, self._next_rung(i, rt, pairs, ladder))
        # the host rung's SOLVE time (delivery and banking excluded), the
        # measure comparable to the dispatch rungs' batch clocks
        self._note_route_time(rt, "host", pairs,
                              self._flush_host(pairs, unique))

    def _device_solve(self, pairs) -> list[BFSResult]:
        """One synchronous device flush: the device route's ``launch``
        (:meth:`_device_launch`), then its ``finish``
        (:meth:`_device_finish`). ``DeviceRoute.solve`` calls this seam,
        so the synchronous ladder runs both stages in turn."""
        route = self.routes["device"]
        out, fin, t0 = route.launch(self._current_rt(), pairs)
        return route.finish(out, fin, t0, pairs)

    def _device_launch(self, pairs):
        """Stage 1 of a device flush (``device_launch``): pad the flush to
        its batch rung with inert ``(0, 0)`` queries, resolve the batch
        mode, note the program identity, run the batch and its finish hook
        (minor8 slot decode, capped-query refill), and copy the outputs of
        the real queries to the host ONCE. Returns ``(outs, meta, t0)``:
        the host arrays, ``(elapsed, mode, host_syncs)`` and the dispatch
        start. Every tensor on the card is used here, on the calling
        thread and the engine device's current stream, so the finish stage
        needs none (the pipelined engine's finish worker never touches
        the card)."""
        from bibfs_tpu_torch.solvers.batch_minor import auto_batch_mode
        from bibfs_tpu_torch.solvers.dense import _batch_dispatch, _host
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
            with self._on_device():
                _p, dispatch, finish = _batch_dispatch(graph, padded, mode,
                                                       stats)
                t0 = time.perf_counter()
                out = dispatch()
                force_scalar(out)
                elapsed = time.perf_counter() - t0
                outs = [_host(o[:b]) for o in finish(out)]
            return outs, (elapsed, stats["mode"], stats["host_syncs"]), t0

    def _device_finish(self, outs, meta, t0, pairs) -> list[BFSResult]:
        """Stage 2 of a device flush (``device_finish``): materialize the
        per-query results and bank the parent forests, all from the host
        copies :meth:`_device_launch` made."""
        from bibfs_tpu_torch.solvers.dense import _materialize_batch

        b = len(pairs)
        with span("device_finish", batch=b):
            if self._faults is not None:
                self._faults.fire("device_finish", pairs)
            elapsed, mode, host_syncs = meta
            results = _materialize_batch(outs, b, elapsed, mode=mode,
                                         host_syncs=host_syncs)
            self.counters["device_batches"] += 1
            self.counters["device_queries"] += b
            self._bank_forests(pairs, outs[2], outs[3])
            return results

    def _on_device(self):
        """The engine's card as the calling thread's current device (a
        thread starts on device 0 and the launchers use the current
        device's stream); a no-op context on the CPU."""
        import contextlib

        if self._device.type != "cuda":
            return contextlib.nullcontext()
        import torch

        return torch.cuda.device(self._device)

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

    @staticmethod
    def _cutoffs_for(pairs, unique):
        """Per-pair oracle cutoffs of a host flush (None when no ticket
        carried one); duplicate tickets of a pair share the tightest."""
        cutoffs = [
            min((t.cutoff for t in unique[key] if t.cutoff is not None),
                default=None)
            for key in pairs
        ]
        return cutoffs if any(c is not None for c in cutoffs) else None

    def _flush_host(self, pairs, unique) -> float:
        """Solve and deliver one host batch; returns the solve seconds
        (the adaptive policy's measure of the host rung)."""
        t0 = time.perf_counter()
        results = self._solve_host_isolated(
            pairs, self._cutoffs_for(pairs, unique)
        )
        solve_s = time.perf_counter() - t0
        n_ok = self._deliver_host_results(
            pairs, results,
            lambda key, res: self._resolve(unique[key], *key, res),
            lambda key, err: self._resolve_error(unique[key], err),
        )
        self._c_host_queries.inc(n_ok)
        return solve_s

    def _deliver_host_results(self, pairs, results, resolve_ok,
                              resolve_err) -> int:
        """One host batch's delivery, shared by the synchronous flush and
        the pipelined finish worker (which differ only in how a ticket
        resolves or fails): bank the newest ``dist_cache.entries`` found
        paths and hand each entry of the isolator's ``BFSResult |
        QueryError`` list to its callback. Returns the successes. No
        parent planes exist on the host route, but each found shortest
        path is a valid forest fragment for both endpoints."""
        ok_idx = [i for i, r in enumerate(results)
                  if not isinstance(r, QueryError)]
        bank = self._paths_to_bank([results[i] for i in ok_idx])
        bank_idx = {ok_idx[j] for j in bank}
        for i, ((src, dst), res) in enumerate(zip(pairs, results)):
            if isinstance(res, QueryError):
                resolve_err((src, dst), res)
                continue
            if i in bank_idx:
                self.dist_cache.put_path(self.graph_id, res.path, self.n)
            resolve_ok((src, dst), res)
        return len(ok_idx)

    def _solve_host_isolated(self, pairs, cutoffs=None):
        """The host route with failure isolation: the whole batch first;
        on failure, BISECT — halves re-solve independently, so a poison
        batch converges in O(log B) extra solves to exactly the queries
        that are bad. A failing singleton gets one last rung (the serial
        oracle) and only then a structured :class:`QueryError`.
        ``cutoffs`` (oracle upper bounds, aligned with ``pairs``) ride the
        recursion. Returns one ``BFSResult | QueryError`` per pair; never
        raises."""
        try:
            return self._solve_host(pairs, cutoffs)
        except Exception as exc:
            if len(pairs) == 1:
                self._note_fallback("host", "serial")
                try:
                    src, dst = pairs[0]
                    return [self._solve_serial_one(
                        src, dst, cutoffs[0] if cutoffs else None
                    )]
                except Exception as exc2:
                    return [to_query_error(exc2, pairs[0])]
            self._res_cells.bisections.inc()
            mid = len(pairs) // 2
            del exc  # halves re-derive their own failure (or succeed)
            c_lo = cutoffs[:mid] if cutoffs else None
            c_hi = cutoffs[mid:] if cutoffs else None
            return (self._solve_host_isolated(pairs[:mid], c_lo)
                    + self._solve_host_isolated(pairs[mid:], c_hi))

    def _solve_serial_one(self, src: int, dst: int,
                          cutoff: int | None = None) -> BFSResult:
        """The bottom of the fallback ladder
        (:class:`~bibfs_tpu_torch.serve.routes.SerialRoute`) over the bound
        graph; a thin seam so chaos tests can break this rung per
        engine."""
        return self.routes["serial"].solve_one(
            self._current_rt(), src, dst, cutoff
        )

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

    def _solve_host(self, pairs, cutoffs=None) -> list[BFSResult]:
        """Solve ``pairs`` on the host route: the threaded native C batch
        when the native runtime carries the route and the flush has at
        least :attr:`HOST_BATCH_MIN` queries, else the per-query solver.
        The C batch caps each query's path buffer, so a found result
        without a path is re-solved per query (full path buffer).
        ``cutoffs`` reach the per-query solvers (the serial one seeds its
        meet bound; the native ones ignore them)."""
        with span("host_batch", batch=len(pairs)):
            if self._faults is not None:
                self._faults.fire("host_batch", pairs)
            solver = self._current_rt().get_host_solver()
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
            if cutoffs is None:
                return [solver(src, dst) for src, dst in pairs]
            return [solver(src, dst, cutoff=c)
                    for (src, dst), c in zip(pairs, cutoffs)]

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
        drop its snapshot pins (store-backed snapshots retire once the last
        pin lands). Later ``submit``/``query`` calls raise ``engine is
        closed``; ``stats()`` stays readable."""
        self.flush()
        self.health.set_draining()
        self._release_runtimes()

    def _release_runtimes(self) -> None:
        """Drop the engine's per-runtime snapshot pins, once. The runtimes
        stay readable (``stats()``) but are never re-resolved."""
        with self._rt_lock:
            if self._rts_released:
                return
            self._rts_released = True
            rts = list(self._runtimes.values())
        for rt in rts:
            rt.snapshot.release()
        if self._mesh_pool_owned:
            # after the runtimes: their graphs' release descriptors go
            # first, then the ranks shut down
            self._mesh_pool.close()
        if self._policy is not None:
            try:
                self._policy.save()  # best-effort: a full disk must not
                # turn a clean close into a raise
            except OSError:
                pass

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
        rt = self._current_rt()
        solved = (
            c["device_queries"] + c["host_queries"] + c["overlay_queries"]
            + c["mesh_queries"] + c["blocked_queries"]
        )
        kinds = self._query_cells.snapshot()
        # typed queries a solver rung resolved (anything but the kind
        # cache) count as solved for the dispatch-free figure
        solved += sum(
            v for kind, routes in kinds.items() if kind != "pt"
            for route, v in routes.items() if route != "cache"
        )
        return {
            **c,
            "solver_dispatch_free": c["queries"] - solved,
            "stages": {
                route: {
                    stage: {"n": cell[0], "s": round(cell[1], 6)}
                    for stage, cell in sorted(acc.items())
                }
                for route, acc in sorted(self._stage_acc.items())
            },
            "query_kinds": kinds,
            "kind_cache": self._kind_cache.stats(),
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
                "store_graph": self._default_name,
                "graphs_resolved": (
                    None if self._store is None
                    else sorted(self._runtimes)
                ),
            },
            # the engine-local oracle (store-backed engines report their
            # per-graph oracles through store.stats())
            "oracle": None if self._oracle is None else self._oracle.stats(),
            "resilience": {
                **self._res_cells.snapshot(),
                "breaker": self._breaker.snapshot(),
                "retry": self._retry.snapshot(),
                "faults": (
                    None if self._faults is None else self._faults.stats()
                ),
            },
            "health": self.health.snapshot(),
            "adaptive": (
                None if self._policy is None else self._policy.stats()
            ),
        }

    def health_snapshot(self) -> dict:
        """The ``/healthz`` payload: the health state machine's view."""
        return self.health.snapshot()
