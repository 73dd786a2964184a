"""The taxonomy query routes — ``msbfs`` / ``weighted`` / ``kshortest``
/ ``asof`` as peer Route rungs: the counterpart of
``bibfs_tpu/serve/routes/taxonomy.py``.

Each non-point-to-point query kind (:mod:`bibfs_tpu_torch.query`) is served
by a :class:`~bibfs_tpu_torch.serve.routes.base.Route` subclass with the
full resilience contract the dispatch rungs carry: its own retry
policy and circuit breaker (``Route.attempt``), its own chaos seam in
:data:`bibfs_tpu_torch.serve.faults.KNOWN_SITES` (``msbfs`` / ``weighted`` /
``kshortest`` / ``asof_replay``), and a ``fallback`` rung that solves
per query through INDEPENDENT machinery with failure isolation — an
injected (or real) fault on the primary degrades the kind to its
fallback exactly the way a dead accelerator degrades to the host
ladder, counted in ``bibfs_route_fallbacks_total{from=<kind>,
to=host}``:

- ``msbfs`` primary: the bitmask-packed sweep
  (:mod:`bibfs_tpu_torch.query.msbfs` — 64 sources per sweep, one sweep set
  per flush); fallback: one host BFS per source (the very per-query
  solves the packed sweep exists to beat — availability over
  throughput).
- ``weighted`` primary: delta-stepping; fallback: the binary-heap
  Dijkstra oracle, the independent implementation the tests validate
  against.
- ``kshortest`` primary: Yen's; fallback: Yen's again but isolated
  per query with no chaos seam in the way (the algorithm IS the
  bottom rung — what degrades here is batching and the seam, not the
  math).
- ``asof`` primary: historical-snapshot reconstruction
  (:meth:`bibfs_tpu_torch.store.GraphStore.reconstruct_version` over
  :mod:`bibfs_tpu_torch.store.history`) + host solves of the inner
  queries, with a per-engine reconstruction cache; fallback:
  re-reconstruction per query, isolated.

These rungs are host-tier (NumPy) on every engine, so any failure of
theirs degrades as in the reference, on a CUDA engine too
(``TaxonomyRoute.host_tier``); the kinds' device rungs
(:mod:`bibfs_tpu_torch.serve.routes.taxonomy_device`) degrade on a CUDA
engine only for an injected fault. The whole-graph analytics kinds
(:data:`~bibfs_tpu_torch.analytics.queries.ANALYTICS_KINDS`) keep their
label cells and ladder entries here; their rungs
(:mod:`bibfs_tpu_torch.serve.routes.analytics`) join the set in
:func:`build_taxonomy_routes`.

Queries solve against a :class:`KindCtx` — the flush-bound CSR truth:
the snapshot's memoized CSR normally, the overlay-merged CSR while
live updates are pending (every kind answers EXACTLY on the live edge
set, the same contract the overlay route gives point-to-point), in
which case result caching stands aside. Executable accounting: packed
sweeps are noted in the engine's ExecutableCache under
``placement_bucket_key(kind="msbfs")`` keys so msBFS "programs" (host
sweeps, keyed by padded word geometry) never collide with device
executables of the same graph.

Metrics (README "Query taxonomy"): ``bibfs_query_total{engine,kind,
route}`` counts every taxonomy query by resolving route (kind ``pt``
counts its delegation to the classic ladder under ``route="ladder"``
— the per-rung split of that ladder already lives in
``bibfs_queries_routed_total``), ``bibfs_query_asof_replay_seconds``
is the last historical reconstruction's cost, and
``bibfs_msbfs_breaker_state`` mirrors the msbfs rung's breaker the
way the mesh/blocked gauges mirror theirs. All minted at route-set
construction so a scrape renders the whole group at zero.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict

import numpy as np

from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.query.types import MSBFS_WORD, QUERY_KINDS
from bibfs_tpu_torch.serve.buckets import placement_bucket_key
from bibfs_tpu_torch.serve.resilience import (
    BREAKER_STATE_CODES,
    QueryError,
    to_query_error,
)
from bibfs_tpu_torch.serve.routes.base import Route
from bibfs_tpu_torch.utils.annotations import guarded_by

#: kind -> the Route name serving it (the HOST-tier primary rung; its
#: ``fallback`` is every kind's terminal answering machinery, and
#: ``host`` is the terminal rung name in the ladder/fallback counters)
KIND_ROUTES = {
    "msbfs": "msbfs",
    "weighted": "weighted",
    "kshortest": "kshortest",
    "asof": "asof",
    # the whole-graph analytics kinds (serve/routes/analytics.py): same
    # contract, answers are vectors/scalars instead of paths
    "sssp": "sssp",
    "pagerank": "pagerank",
    "components": "components",
    "triangles": "triangles",
}

#: the per-kind ladder ``QueryEngine._flush_kind`` walks: the device
#: rung (serve/routes/taxonomy_device.py) ahead of the host-tier kind
#: rung, ``host`` terminal — an ineligible device rung is skipped
#: silently (a routing decision), an UNAVAILABLE one (breaker open /
#: retries burned) degrades with a counted fallback. Per-kind adaptive
#: policies reorder the non-terminal rungs per graph digest.
KIND_LADDERS = {
    "msbfs": ("msbfs_device", "msbfs", "host"),
    "weighted": ("weighted_device", "weighted", "host"),
    "kshortest": ("kshortest_device", "kshortest", "host"),
    "asof": ("asof", "host"),
    "sssp": ("sssp_blocked", "sssp", "host"),
    "pagerank": ("pagerank_blocked", "pagerank", "host"),
    "components": ("components_blocked", "components", "host"),
    "triangles": ("triangles_blocked", "triangles", "host"),
}

#: eagerly minted (kind, route) label pairs — the render-at-zero set
KIND_ROUTE_LABELS = (
    ("pt", "ladder"),
    ("msbfs", "msbfs"), ("msbfs", "msbfs_device"),
    ("msbfs", "host"), ("msbfs", "cache"),
    ("weighted", "weighted"), ("weighted", "weighted_device"),
    ("weighted", "host"), ("weighted", "cache"),
    ("kshortest", "kshortest"), ("kshortest", "kshortest_device"),
    ("kshortest", "host"), ("kshortest", "cache"),
    ("asof", "asof"), ("asof", "host"), ("asof", "cache"),
    # the analytics kinds add a "store" route: answers served from the
    # per-digest whole-graph result store (analytics/results.py)
    ("sssp", "sssp"), ("sssp", "sssp_blocked"),
    ("sssp", "host"), ("sssp", "cache"), ("sssp", "store"),
    ("pagerank", "pagerank"), ("pagerank", "pagerank_blocked"),
    ("pagerank", "host"), ("pagerank", "cache"), ("pagerank", "store"),
    ("components", "components"), ("components", "components_blocked"),
    ("components", "host"), ("components", "cache"),
    ("components", "store"),
    ("triangles", "triangles"), ("triangles", "triangles_blocked"),
    ("triangles", "host"), ("triangles", "cache"),
    ("triangles", "store"),
)


class QueryKindCells:
    """The taxonomy metric cells of ONE engine, minted at route-set
    construction (module docstring names)."""

    def __init__(self, label: str):
        family = REGISTRY.counter(
            "bibfs_query_total",
            "Taxonomy queries resolved, by query kind and serving "
            "route (kind=pt counts its delegation to the classic "
            "ladder; the per-rung split lives in "
            "bibfs_queries_routed_total)",
            ("engine", "kind", "route"),
        )
        self._family = family
        self._label = label
        self._cells = {
            (k, r): family.labels(engine=label, kind=k, route=r)
            for k, r in KIND_ROUTE_LABELS
        }
        self.asof_replay_gauge = REGISTRY.gauge(
            "bibfs_query_asof_replay_seconds",
            "Duration of the engine's last as-of historical "
            "reconstruction (WAL + versioned manifests replay)",
            ("engine",),
        ).labels(engine=label)

    def cell(self, kind: str, route: str):
        c = self._cells.get((kind, route))
        if c is None:
            c = self._family.labels(
                engine=self._label, kind=kind, route=route
            )
            self._cells[(kind, route)] = c
        return c

    def snapshot(self) -> dict:
        out: dict = {k: {} for k in QUERY_KINDS}
        for (k, r), c in self._cells.items():
            if c.value:
                out.setdefault(k, {})[r] = c.value
        return {k: v for k, v in out.items() if v}


class KindCtx:
    """The CSR truth one taxonomy flush group solves against: the
    bound snapshot's memoized CSR (``base=True`` — results cacheable),
    or the overlay-merged live CSR (``base=False`` — exact answers,
    caching stands aside). ``name`` is the store graph name (None on
    an inline engine)."""

    __slots__ = ("n", "row_ptr", "col_ind", "base", "name", "graph_id")

    def __init__(self, n, row_ptr, col_ind, *, base, name, graph_id):
        self.n = int(n)
        self.row_ptr = row_ptr
        self.col_ind = col_ind
        self.base = bool(base)
        self.name = name
        self.graph_id = graph_id


@guarded_by("_lock", "_entries", "hits", "misses")
class KindResultCache:
    """A small per-engine LRU over taxonomy results, keyed
    ``(graph_id, query.cache_key())`` — the snapshot digest namespace
    makes cross-version aliasing impossible, the same argument as the
    distance cache. Results are immutable once resolved, so sharing
    the object between tickets is safe."""

    def __init__(self, entries: int = 256):
        self.entries = int(entries)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, graph_id, key):
        k = (graph_id, key)
        with self._lock:
            res = self._entries.get(k)
            if res is None:
                self.misses += 1
                return None
            self._entries.move_to_end(k)
            self.hits += 1
            return res

    def put(self, graph_id, key, result) -> None:
        if self.entries <= 0:
            return
        k = (graph_id, key)
        with self._lock:
            self._entries[k] = result
            self._entries.move_to_end(k)
            while len(self._entries) > self.entries:
                self._entries.popitem(last=False)

    def invalidate(self, graph_id) -> int:
        with self._lock:
            dead = [k for k in self._entries if k[0] == graph_id]
            for k in dead:
                del self._entries[k]
            return len(dead)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.entries,
                "hits": self.hits,
                "misses": self.misses,
            }


class TaxonomyRoute(Route):
    """Shared shape of the four kind routes: never eligible from the
    point-to-point ladder (the engines dispatch by kind), a resilient
    primary behind ``Route.attempt``, and a per-query-isolated
    ``fallback`` that never raises and never returns unavailable."""

    kind: str = "taxonomy"
    # the host kind rungs degrade on any failure (the reference's
    # ladder), on a CUDA engine too: no kernel of the card is hidden by
    # their fallback
    host_tier = True

    def eligible(self, rt, pairs) -> bool:
        return False  # kind-dispatched, never from the pt ladder

    def kind_eligible(self, rt, queries, ctx) -> bool:
        """The kind-ladder routing predicate (``_flush_kind`` skips an
        ineligible rung silently — a routing decision, not a failure).
        Host-tier kind rungs carry anything; the device rungs
        (serve/routes/taxonomy_device.py) gate on substrate, snapshot
        base, layout, and their calibrated crossovers."""
        return True

    def solve(self, rt, queries, ctx=None):
        out, fin, t0 = self.launch(rt, queries, ctx)
        return self.finish(out, fin, t0, queries)

    def launch(self, rt, queries, ctx=None):
        raise NotImplementedError

    def finish(self, out, fin, t0, queries):
        return out

    # base Route.attempt(rt, queries, ctx) hands ctx on to solve():
    # bounded retries behind this route's own breaker.

    def fallback(self, rt, queries, ctx):
        """The kind's terminal rung: solve each query independently
        (failure isolation — one poisoned query costs one slot, never
        its batch). Returns one result-or-``QueryError`` per query."""
        out = []
        for q in queries:
            try:
                out.append(self._fallback_one(rt, q, ctx))
            except Exception as exc:
                out.append(to_query_error(
                    exc, self._query_pair(q),
                ))
        return out

    def _fallback_one(self, rt, q, ctx):
        raise NotImplementedError

    def _query_pair(self, q):
        """The engine's representative-pair rule — ONE implementation
        (``QueryEngine._query_rep_pair``) keys fault targeting and
        error reporting alike."""
        return self.engine._query_rep_pair(q)

    def _fire(self, site: str, queries) -> None:
        faults = self.engine._faults
        if faults is not None:
            pairs = [
                p for p in (self._query_pair(q) for q in queries)
                if p is not None
            ]
            faults.fire(site, pairs or None)


class MsbfsRoute(TaxonomyRoute):
    """The multi-source rung: one bitmask-packed sweep per 64 distinct
    sources across the whole flush group (module docstring). Owns the
    ``bibfs_msbfs_breaker_state`` gauge the way mesh/blocked rungs own
    theirs; sweeps are noted in the ExecutableCache under
    ``placement_bucket_key(kind="msbfs")`` keys."""

    name = "msbfs"
    kind = "msbfs"

    def __init__(self, engine, *, retry, breaker, label: str):
        super().__init__(engine, retry=retry, breaker=breaker)
        self.sweeps = 0  # single-mutator: the flushing thread
        gauge = REGISTRY.gauge(
            "bibfs_msbfs_breaker_state",
            "msbfs-route circuit breaker (0=closed 1=half_open 2=open)",
            ("engine",),
        ).labels(engine=label)
        self.breaker_gauge = gauge
        # weakly bound through the route (registry cells themselves
        # are not weakref-able): a shared breaker must not pin a dead
        # engine's route — the mesh/blocked contract
        self_ref = weakref.ref(self)

        def _on_transition(state):
            route = self_ref()
            if route is None:
                return False
            route.breaker_gauge.set(BREAKER_STATE_CODES[state])
            return True

        breaker.add_listener(_on_transition)
        gauge.set(BREAKER_STATE_CODES[breaker.state])

    def launch(self, rt, queries, ctx=None):
        from bibfs_tpu_torch.query.msbfs import solve_multi_source

        with span("msbfs_batch", batch=len(queries)):
            self._fire("msbfs", queries)
            t0 = time.perf_counter()
            distinct = len({
                int(s) for q in queries for s in q.sources
            })
            sweeps = -(-distinct // MSBFS_WORD)
            # host-sweep "program" identity: padded word geometry per
            # graph — keyed apart from any device executable
            self.engine.exec_cache.note(placement_bucket_key(
                ("msbfs", ctx.n), kind="msbfs", shards=1,
                extra=(min(distinct, MSBFS_WORD),),
            ))
            results = solve_multi_source(
                ctx.n, ctx.row_ptr, ctx.col_ind, queries
            )
            self.sweeps += sweeps
            return results, None, t0

    def _fallback_one(self, rt, q, ctx):
        """Per-source host BFS — the independent machinery the packed
        sweep is measured against, availability-shaped."""
        from bibfs_tpu_torch.query.types import MultiSourceResult
        from bibfs_tpu_torch.solvers.serial import solve_serial_csr

        t0 = time.perf_counter()
        per = []
        best = None
        best_path = None
        for i, s in enumerate(q.sources):
            r = solve_serial_csr(
                ctx.n, ctx.row_ptr, ctx.col_ind, int(s), int(q.dst)
            )
            per.append(r.hops if r.found else None)
            if r.found and (best is None or r.hops < per[best]):
                best = i
                best_path = r.path
        return MultiSourceResult(
            found=best is not None,
            per_source=tuple(per),
            best=best,
            hops=per[best] if best is not None else None,
            path=best_path,
            time_s=time.perf_counter() - t0,
            sweeps=0,
        )

    def stats(self) -> dict:
        out = super().stats()
        out["sweeps"] = self.sweeps
        return out


class WeightedRoute(TaxonomyRoute):
    """The weighted rung: delta-stepping over bucketed frontiers,
    weights derived per (snapshot, seed) by the symmetric hash
    (cached on the flush runtime for the no-overlay case)."""

    name = "weighted"
    kind = "weighted"

    def launch(self, rt, queries, ctx=None):
        from bibfs_tpu_torch.query.weighted import delta_stepping

        with span("weighted_batch", batch=len(queries)):
            self._fire("weighted", queries)
            t0 = time.perf_counter()
            out = []
            for q in queries:
                w = self._weights(rt, ctx, int(q.weight_seed))
                out.append(delta_stepping(
                    ctx.n, ctx.row_ptr, ctx.col_ind, w,
                    int(q.src), int(q.dst),
                ))
            return out, None, t0

    def _weights(self, rt, ctx, seed: int):
        from bibfs_tpu_torch.query.weighted import synthetic_weights

        if ctx.base:
            return rt.weights_for(seed, ctx.row_ptr, ctx.col_ind)
        # overlay-merged CSR: derive fresh (the merged shape is not
        # the snapshot's; memoizing it would alias across updates)
        return synthetic_weights(ctx.row_ptr, ctx.col_ind, seed)

    def _fallback_one(self, rt, q, ctx):
        """The binary-heap Dijkstra oracle — the independent
        implementation the property tests pin delta-stepping to."""
        from bibfs_tpu_torch.query.types import WeightedResult
        from bibfs_tpu_torch.query.weighted import dijkstra_numpy

        t0 = time.perf_counter()
        w = self._weights(rt, ctx, int(q.weight_seed))
        dist, parent = dijkstra_numpy(
            ctx.n, ctx.row_ptr, ctx.col_ind, w, int(q.src), int(q.dst)
        )
        found = bool(np.isfinite(dist[int(q.dst)]))
        path = None
        if found:
            path = [int(q.dst)]
            while path[-1] != int(q.src):
                path.append(int(parent[path[-1]]))
            path.reverse()
        return WeightedResult(
            found=found,
            dist=float(dist[int(q.dst)]) if found else None,
            hops=len(path) - 1 if found else None,
            path=path,
            time_s=time.perf_counter() - t0,
        )


class KShortestRoute(TaxonomyRoute):
    """The k-shortest rung: Yen's over the restricted-BFS machinery, a
    host-tier kind by nature (module docstring)."""

    name = "kshortest"
    kind = "kshortest"

    def launch(self, rt, queries, ctx=None):
        from bibfs_tpu_torch.query.kshortest import yen_k_shortest

        with span("kshortest_batch", batch=len(queries)):
            self._fire("kshortest", queries)
            t0 = time.perf_counter()
            out = [
                yen_k_shortest(
                    ctx.n, ctx.row_ptr, ctx.col_ind,
                    int(q.src), int(q.dst), int(q.k),
                )
                for q in queries
            ]
            return out, None, t0

    def _fallback_one(self, rt, q, ctx):
        from bibfs_tpu_torch.query.kshortest import yen_k_shortest

        return yen_k_shortest(
            ctx.n, ctx.row_ptr, ctx.col_ind,
            int(q.src), int(q.dst), int(q.k),
        )


@guarded_by("_snap_lock", "_snaps")
class AsOfRoute(TaxonomyRoute):
    """The time-travel rung: reconstruct the graph as of a historical
    store version (``store/history.py`` — WAL + versioned manifests),
    cache the reconstructed CSR per (graph, version) for the engine's
    lifetime (history is immutable — a committed version's edge set
    never changes), and solve the inner queries against it on the
    host tier. The chaos seam is the reconstruction itself
    (``asof_replay``): the disk read + replay is what a dying disk
    breaks."""

    name = "asof"
    kind = "asof"

    #: reconstructed (n, row_ptr, col_ind) CSRs kept per engine — each
    #: costs one CSR, bounded to keep a version-scanning client from
    #: holding every historical graph in memory at once
    MAX_SNAPS = 8

    def __init__(self, engine, *, retry, breaker):
        super().__init__(engine, retry=retry, breaker=breaker)
        self._snap_lock = threading.Lock()
        self._snaps: OrderedDict = OrderedDict()
        self.replays = 0  # single-mutator: the flushing thread

    def launch(self, rt, queries, ctx=None):
        with span("asof_batch", batch=len(queries)):
            t0 = time.perf_counter()
            # group by version so each historical CSR reconstructs
            # once per batch — but results land back at their query's
            # INPUT position (a batch may mix versions)
            out: list = [None] * len(queries)
            by_version: dict[int, list] = {}
            for i, q in enumerate(queries):
                by_version.setdefault(int(q.version), []).append((i, q))
            for version, group in sorted(by_version.items()):
                try:
                    hist = self._historical(
                        rt, ctx, version, [q for _i, q in group]
                    )
                except QueryError as e:
                    if e.kind != "invalid":
                        raise
                    # an unknown/unprovable version is the CLIENT's
                    # input: it becomes those queries' per-slot error
                    # RESULT, never a route failure — raising it out
                    # of launch would burn retries and open the asof
                    # breaker on bad input, degrading valid traffic
                    for i, _q in group:
                        out[i] = e
                    continue
                for i, q in group:
                    out[i] = self._solve_inner(q.inner, hist)
            return out, None, t0

    def _historical(self, rt, ctx, version: int, queries) -> KindCtx:
        """The CSR as of ``version`` — cached per (graph, version);
        a miss fires the ``asof_replay`` chaos seam and pays the
        reconstruction, timed into
        ``bibfs_query_asof_replay_seconds``."""
        key = (ctx.name, version)
        with self._snap_lock:
            hist = self._snaps.get(key)
            if hist is not None:
                self._snaps.move_to_end(key)
                return hist
        self._fire("asof_replay", queries)
        t0 = time.perf_counter()
        snap = self._reconstruct(rt, ctx, version)
        row_ptr, col_ind = snap.csr()
        elapsed = time.perf_counter() - t0
        eng = self.engine
        eng._query_cells.asof_replay_gauge.set(elapsed)
        self.replays += 1
        hist = KindCtx(
            snap.n, row_ptr, col_ind, base=True, name=ctx.name,
            # historical results are cached under the historical
            # snapshot's OWN digest — immune to live-graph swaps
            graph_id=snap.digest,
        )
        with self._snap_lock:
            self._snaps[key] = hist
            self._snaps.move_to_end(key)
            while len(self._snaps) > self.MAX_SNAPS:
                self._snaps.popitem(last=False)
        return hist

    def _reconstruct(self, rt, ctx, version: int):
        store = self.engine._store
        if store is not None:
            try:
                return store.reconstruct_version(ctx.name, version)
            except ValueError as e:
                # an unknown/unprovable version is the CLIENT's input
                # being wrong (or history retention being off), not a
                # server failure: tag it invalid so retries don't burn
                # on it and health stays clean
                raise QueryError(
                    str(e), kind="invalid",
                ) from e
        # inline engine: the one immutable graph IS every version it
        # has — only its own stamp answers
        snap = rt.snapshot
        if version != snap.version:
            raise QueryError(
                f"as_of version {version} unknown: engine has no "
                f"store (inline graph is version {snap.version})",
                kind="invalid",
            )
        return snap

    def _solve_inner(self, q, hist: KindCtx):
        """One inner query against the historical CSR, on the host
        tier (no device table is ever built for a historical
        version — time-travel is a read path, not a serving tier)."""
        from bibfs_tpu_torch.query.host import solve_query_csr

        return solve_query_csr(hist.n, hist.row_ptr, hist.col_ind, q)

    def _fallback_one(self, rt, q, ctx):
        """Per-query re-reconstruction with the chaos seam behind us —
        degraded time-travel pays the replay per query instead of per
        version group, but still answers exactly."""
        snap = self._reconstruct(rt, ctx, int(q.version))
        row_ptr, col_ind = snap.csr()
        from bibfs_tpu_torch.query.host import solve_query_csr

        return solve_query_csr(snap.n, row_ptr, col_ind, q.inner)

    def stats(self) -> dict:
        out = super().stats()
        with self._snap_lock:
            out["historical_snapshots"] = len(self._snaps)
        out["replays"] = self.replays
        return out


def build_taxonomy_routes(engine, label: str) -> dict:
    """The kind-route set every engine carries (``build_routes`` calls
    this unconditionally — the taxonomy is part of the serving
    contract, not an opt-in), each rung with its OWN retry policy and
    circuit breaker. The device rungs ride along as ladder peers
    (serve/routes/taxonomy_device.py) — ineligible until the engine
    routes device at all, so a CPU-substrate engine's behavior is
    unchanged until it opts in."""
    from bibfs_tpu_torch.serve.resilience import CircuitBreaker, RetryPolicy
    from bibfs_tpu_torch.serve.routes.taxonomy_device import (
        build_taxonomy_device_routes,
    )

    routes = {
        "msbfs": MsbfsRoute(
            engine, retry=RetryPolicy(), breaker=CircuitBreaker(),
            label=label,
        ),
        "weighted": WeightedRoute(
            engine, retry=RetryPolicy(), breaker=CircuitBreaker(),
        ),
        "kshortest": KShortestRoute(
            engine, retry=RetryPolicy(), breaker=CircuitBreaker(),
        ),
        "asof": AsOfRoute(
            engine, retry=RetryPolicy(), breaker=CircuitBreaker(),
        ),
    }
    routes.update(build_taxonomy_device_routes(engine, label))
    # the whole-graph analytics kinds (host + blocked rungs) ride every
    # engine the same way: kind-dispatched, never from the pt ladder
    from bibfs_tpu_torch.serve.routes.analytics import build_analytics_routes

    routes.update(build_analytics_routes(engine, label))
    return routes
