"""The whole-graph analytics rungs — ``sssp`` / ``pagerank`` /
``components`` / ``triangles`` through the kind ladder: the counterpart
of ``bibfs_tpu/serve/routes/analytics.py``.

Each analytics kind is served like the other taxonomy kinds: a host-tier
primary (the CSR semiring iteration,
:mod:`bibfs_tpu_torch.analytics.semiring`) with its own retry policy and
circuit breaker, a per-query-isolated terminal ``fallback``, and a
BLOCKED rung above it (:mod:`bibfs_tpu_torch.ops.semiring_plane` over the
``BlockedGraph`` tile tables) that an adaptive per-digest ladder reorders
and a faulted rung degrades out of with no lost ticket.

The blocked rungs run on the engine's device: on the card one launch of a
hand-written kernel a fixpoint (``csrc/semiring.cu``; the triangle count
one a 256-column chunk), on a CPU engine the plain torch twins, as the
JAX package runs its jitted programs on the CPU substrate too. So they do
not gate on ``_use_device()``: eligibility is snapshot base + ELL layout +
the tile-table budget (times :attr:`AnalyticsBlockedRoute.TABLE_SCALE`) +
an EXACTNESS bound (integer-valued planes stay exact in f32 below 2^24) +
the ``analytics`` crossover block of the engine's device type (the card
has no ``cuda`` block yet, so it reads the committed defaults below). On a
CUDA engine a blocked rung degrades to its host rung only for an injected
fault (``Route.may_degrade``, the engine's rule): a kernel that fails to
build or launch fails the flush's tickets with ``kind='internal'``.

Chaos seams: every analytics launch fires ``analytics`` going in and
``analytics_finish`` on the way out (both rungs: the seam is the kind, not
the tier), so one spec line degrades the whole tier to its fallbacks.
Metrics: ``bibfs_analytics_rounds_total{engine,kind}`` (relaxation sweeps
/ power iterations / label rounds / column chunks) and
``bibfs_analytics_breaker_state{engine,kind}`` for the blocked rungs, all
minted at route-set construction.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from bibfs_tpu_torch.graph.blocked import TILE as TILE_EDGE
from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.ops.semiring_plane import TRI_CHUNK
from bibfs_tpu_torch.serve.buckets import placement_bucket_key
from bibfs_tpu_torch.serve.resilience import BREAKER_STATE_CODES
from bibfs_tpu_torch.serve.routes.taxonomy import TaxonomyRoute

#: committed host->blocked crossovers (edge counts, the reference's),
#: overridden by the platform's calibrated ``analytics`` block. Below a
#: few thousand edges the NumPy scatter iteration wins.
DEFAULT_ANALYTICS_MIN_EDGES = {
    "sssp": 4000,
    "pagerank": 4000,
    "components": 4000,
    "triangles": 2000,
}

#: exactness bound for float32 planes: distances / labels / counts are
#: integer-valued and exact below 2^24
_F32_EXACT = 1 << 24


def analytics_calibration(platform: str) -> dict:
    """The calibrated ``analytics`` crossover block of ``platform``
    (``cpu`` or ``cuda``; empty when absent: the committed defaults
    apply)."""
    from bibfs_tpu_torch.utils.calibrate import load_calibration

    cal = load_calibration(platform)
    if not cal:
        return {}
    block = cal.get("analytics")
    return block if isinstance(block, dict) else {}


def _rounds_cell(label: str, kind: str):
    return REGISTRY.counter(
        "bibfs_analytics_rounds_total",
        "Whole-graph analytics iteration rounds (Bellman sweeps, "
        "power iterations, label-propagation rounds, triangle column "
        "chunks), by kind",
        ("engine", "kind"),
    ).labels(engine=label, kind=kind)


class AnalyticsHostRoute(TaxonomyRoute):
    """Shared shape of the four host-tier analytics rungs: the CSR
    semiring iteration behind ``Route.attempt``, the ``analytics`` /
    ``analytics_finish`` chaos seams, and a per-query-isolated fallback
    over the same single-query machinery."""

    def __init__(self, engine, *, retry, breaker, label: str):
        super().__init__(engine, retry=retry, breaker=breaker)
        self.rounds_cell = _rounds_cell(label, self.kind)

    def launch(self, rt, queries, ctx=None):
        with span(f"{self.kind}_batch", batch=len(queries)):
            self._fire("analytics", queries)
            t0 = time.perf_counter()
            out = self._solve_batch(rt, queries, ctx, t0)
            self._fire("analytics_finish", queries)
            return out, None, t0

    def _solve_batch(self, rt, queries, ctx, t0):
        raise NotImplementedError

    def _weights(self, rt, ctx, seed: int):
        from bibfs_tpu_torch.query.weighted import synthetic_weights

        if ctx.base:
            return rt.weights_for(seed, ctx.row_ptr, ctx.col_ind)
        return synthetic_weights(ctx.row_ptr, ctx.col_ind, seed)


class SsspRoute(AnalyticsHostRoute):
    """(min, +) Bellman sweeps to fixpoint; a flush's same-seed sources
    batch into ONE multi-column plane (the landmarks shape)."""

    name = "sssp"
    kind = "sssp"

    def _solve_batch(self, rt, queries, ctx, t0):
        from bibfs_tpu_torch.analytics.queries import SsspResult
        from bibfs_tpu_torch.analytics.semiring import host_sssp

        out: list = [None] * len(queries)
        for seed, group in _by_seed(queries):
            w = self._weights(rt, ctx, seed)
            dist, rounds = host_sssp(
                ctx.n, ctx.row_ptr, ctx.col_ind, w,
                [int(q.source) for _i, q in group],
            )
            self.rounds_cell.inc(int(rounds))
            for col, (i, _q) in enumerate(group):
                out[i] = _sssp_result(SsspResult, dist[:, col], rounds, t0)
        return out

    def _fallback_one(self, rt, q, ctx):
        from bibfs_tpu_torch.analytics.queries import SsspResult
        from bibfs_tpu_torch.analytics.semiring import host_sssp

        t0 = time.perf_counter()
        w = self._weights(rt, ctx, int(q.weight_seed))
        dist, rounds = host_sssp(
            ctx.n, ctx.row_ptr, ctx.col_ind, w, [int(q.source)]
        )
        return _sssp_result(SsspResult, dist[:, 0], rounds, t0)


def _by_seed(queries) -> list:
    """A flush's SSSP queries grouped by weight seed, ascending: each
    group is ``[(index in the flush, query), ...]``, one plane."""
    by_seed: dict[int, list] = {}
    for i, q in enumerate(queries):
        by_seed.setdefault(int(q.weight_seed), []).append((i, q))
    return sorted(by_seed.items())


def _sssp_result(cls, d, rounds, t0):
    return cls(found=True, dist=d, reached=int(np.isfinite(d).sum()),
               rounds=int(rounds), time_s=time.perf_counter() - t0)


class PageRankRoute(AnalyticsHostRoute):
    """(+, x) damped power iteration with L1-tolerance termination."""

    name = "pagerank"
    kind = "pagerank"

    def _solve_batch(self, rt, queries, ctx, t0):
        return [self._fallback_one(rt, q, ctx) for q in queries]

    def _fallback_one(self, rt, q, ctx):
        from bibfs_tpu_torch.analytics.queries import PageRankResult
        from bibfs_tpu_torch.analytics.semiring import host_pagerank

        t0 = time.perf_counter()
        ranks, iters, delta = host_pagerank(
            ctx.n, ctx.row_ptr, ctx.col_ind,
            damping=float(q.damping), tol=float(q.tol),
            max_iters=int(q.max_iters),
        )
        self.rounds_cell.inc(int(iters))
        return PageRankResult(
            found=ctx.n > 0, ranks=ranks, iters=int(iters),
            delta=float(delta), time_s=time.perf_counter() - t0,
        )


class ComponentsRoute(AnalyticsHostRoute):
    """Min-label propagation to fixpoint."""

    name = "components"
    kind = "components"

    def _solve_batch(self, rt, queries, ctx, t0):
        return [self._fallback_one(rt, q, ctx) for q in queries]

    def _fallback_one(self, rt, q, ctx):
        from bibfs_tpu_torch.analytics.queries import ComponentsResult
        from bibfs_tpu_torch.analytics.semiring import host_components

        t0 = time.perf_counter()
        labels, count, rounds = host_components(
            ctx.n, ctx.row_ptr, ctx.col_ind
        )
        self.rounds_cell.inc(int(rounds))
        return ComponentsResult(
            found=True, labels=labels, count=int(count),
            rounds=int(rounds), time_s=time.perf_counter() - t0,
        )


class TrianglesRoute(AnalyticsHostRoute):
    """The masked popcount matmul count, column-chunked."""

    name = "triangles"
    kind = "triangles"

    def _solve_batch(self, rt, queries, ctx, t0):
        return [self._fallback_one(rt, q, ctx) for q in queries]

    def _fallback_one(self, rt, q, ctx):
        from bibfs_tpu_torch.analytics.queries import TrianglesResult
        from bibfs_tpu_torch.analytics.semiring import host_triangles

        t0 = time.perf_counter()
        count, chunks = host_triangles(ctx.n, ctx.row_ptr, ctx.col_ind)
        self.rounds_cell.inc(int(chunks))
        return TrianglesResult(
            found=True, count=int(count),
            time_s=time.perf_counter() - t0,
        )


class AnalyticsBlockedRoute(TaxonomyRoute):
    """Shared shape of the blocked analytics rungs: tile-table gates +
    calibrated crossover, the per-kind breaker gauge, and the ladder
    contract (an unavailable rung degrades to the host kind rung; no
    ``fallback`` of its own)."""

    host_tier = False  # the engine's degrade rule (module docstring)

    #: resident bytes per int8 table byte (sssp adds the f32 weight table
    #: at 4x)
    TABLE_SCALE = 1

    def __init__(self, engine, *, retry, breaker, label: str):
        super().__init__(engine, retry=retry, breaker=breaker)
        self.rounds_cell = _rounds_cell(label, self.kind)
        gauge = REGISTRY.gauge(
            "bibfs_analytics_breaker_state",
            "Blocked analytics rung circuit breakers "
            "(0=closed 1=half_open 2=open)",
            ("engine", "kind"),
        ).labels(engine=label, kind=self.kind)
        self.breaker_gauge = gauge
        # weakly bound through the route (registry cells are not
        # weakref-able): the mesh/blocked/msbfs contract
        self_ref = weakref.ref(self)

        def _on_transition(state):
            route = self_ref()
            if route is None:
                return False
            route.breaker_gauge.set(BREAKER_STATE_CODES[state])
            return True

        breaker.add_listener(_on_transition)
        gauge.set(BREAKER_STATE_CODES[breaker.state])
        cal = analytics_calibration(engine._device.type)
        self.min_edges = int(cal.get(
            f"{self.kind}_min_edges",
            DEFAULT_ANALYTICS_MIN_EDGES[self.kind],
        ))

    def kind_eligible(self, rt, queries, ctx) -> bool:
        if ctx is None or not ctx.base:
            return False  # overlay-merged truth: host rungs answer
        if getattr(rt, "layout", None) != "ell":
            return False
        nblocks, bwidth, _nnz = rt.blocked_meta()
        if nblocks * TILE_EDGE >= _F32_EXACT:
            return False  # f32 planes would lose integer exactness
        from bibfs_tpu_torch.ops.blocked_expand import (
            BLOCKED_TAB_BUDGET_BYTES,
        )

        tab_bytes = nblocks * bwidth * TILE_EDGE * TILE_EDGE
        if tab_bytes * self.TABLE_SCALE > BLOCKED_TAB_BUDGET_BYTES:
            return False
        num_edges = int(ctx.col_ind.size) // 2
        return num_edges >= self.min_edges

    def launch(self, rt, queries, ctx=None):
        with span(f"{self.name}_batch", batch=len(queries)):
            self._fire("analytics", queries)
            t0 = time.perf_counter()
            bg = rt.blocked_graph()
            with self.engine._on_device():
                out = self._solve_blocked(rt, bg, queries, ctx, t0)
            self._fire("analytics_finish", queries)
            return out, None, t0

    def _solve_blocked(self, rt, bg, queries, ctx, t0):
        raise NotImplementedError

    def _note_exec(self, nblocks: int, bwidth: int, extra=()):
        self.engine.exec_cache.note(placement_bucket_key(
            ("analytics", nblocks, bwidth),
            kind=f"{self.kind}_blocked", shards=1, extra=tuple(extra),
        ))

    def _fallback_one(self, rt, q, ctx):
        raise NotImplementedError(
            "blocked analytics rungs degrade to their host kind route"
        )

    def stats(self) -> dict:
        out = super().stats()
        out["crossover"] = {"min_edges": self.min_edges}
        return out


class SsspBlockedRoute(AnalyticsBlockedRoute):
    """Multi-source (min, +) fixpoint over the float32 weight tables
    (``graph/blocked.build_blocked_weights``, uploaded and memoized per
    (runtime, seed): ``_GraphRuntime.analytics_weight_table``), one plane
    of a flush's same-seed sources; on the card the kernel lists each
    row's edges from the uploaded graph's packed tile rows
    (``BlockedDeviceGraph.bits``) and reads one weight an edge."""

    name = "sssp_blocked"
    kind = "sssp"
    TABLE_SCALE = 5  # int8 adjacency + f32 weight table

    def _solve_blocked(self, rt, bg, queries, ctx, t0):
        from bibfs_tpu_torch.analytics.queries import SsspResult
        from bibfs_tpu_torch.ops.semiring_plane import sssp_blocked

        out: list = [None] * len(queries)
        for seed, group in _by_seed(queries):
            wtab = rt.analytics_weight_table(seed)
            init = torch.full((bg.n_pad, len(group)), float("inf"),
                              dtype=torch.float32, device=wtab.device)
            src = torch.tensor([int(q.source) for _i, q in group],
                               device=wtab.device)
            init[src, torch.arange(len(group), device=wtab.device)] = 0.0
            self._note_exec(bg.nblocks, bg.bwidth, extra=(len(group),))
            dist, rounds = sssp_blocked(wtab, bg.bcol, init, bits=bg.bits)
            dist = dist[: ctx.n].cpu().numpy().astype(np.float64)
            self.rounds_cell.inc(int(rounds))
            for col, (i, _q) in enumerate(group):
                out[i] = _sssp_result(SsspResult, dist[:, col], rounds, t0)
        return out


class PageRankBlockedRoute(AnalyticsBlockedRoute):
    """Damped power iteration as one launch per parameter set over the
    uploaded graph's packed tile rows (``BlockedDeviceGraph.bits``; tolerance
    clamped to f32 resolution: ranks agree with the host rung to ~1e-6,
    the verification tolerance)."""

    name = "pagerank_blocked"
    kind = "pagerank"

    def _solve_blocked(self, rt, bg, queries, ctx, t0):
        from bibfs_tpu_torch.analytics.queries import PageRankResult
        from bibfs_tpu_torch.ops.semiring_plane import pagerank_blocked

        out = []
        for q in queries:
            self._note_exec(bg.nblocks, bg.bwidth)
            ranks, iters, delta = pagerank_blocked(
                bg.tab, bg.bcol, bg.deg, n=ctx.n,
                damping=float(q.damping), tol=float(q.tol),
                max_iters=int(q.max_iters), bits=bg.bits,
            )
            self.rounds_cell.inc(int(iters))
            out.append(PageRankResult(
                found=ctx.n > 0,
                ranks=ranks[: ctx.n].cpu().numpy().astype(np.float64),
                iters=int(iters), delta=float(delta),
                time_s=time.perf_counter() - t0,
            ))
        return out


class ComponentsBlockedRoute(AnalyticsBlockedRoute):
    """Min-label propagation over the adjacency (0 on every edge: no
    weight table; on the card the edges come from the uploaded graph's
    packed tile rows, ``BlockedDeviceGraph.bits``)."""

    name = "components_blocked"
    kind = "components"

    def _solve_blocked(self, rt, bg, queries, ctx, t0):
        from bibfs_tpu_torch.analytics.queries import ComponentsResult
        from bibfs_tpu_torch.ops.semiring_plane import components_blocked

        self._note_exec(bg.nblocks, bg.bwidth)
        init = torch.arange(bg.n_pad, dtype=torch.float32,
                            device=bg.device)[:, None]
        labels, rounds = components_blocked(bg.tab, bg.bcol, init,
                                            bits=bg.bits)
        labels = labels[: ctx.n, 0].cpu().numpy().astype(np.int64)
        count = int(np.unique(labels).size) if ctx.n else 0
        self.rounds_cell.inc(int(rounds))
        res = ComponentsResult(
            found=True, labels=labels, count=count,
            rounds=int(rounds), time_s=time.perf_counter() - t0,
        )
        return [res for _q in queries]


class TrianglesBlockedRoute(AnalyticsBlockedRoute):
    """The masked popcount count over the uploaded graph's packed tile
    rows (``BlockedDeviceGraph.bits``), one launch a 256-column chunk into
    one int64 total on the device, read once."""

    name = "triangles_blocked"
    kind = "triangles"

    def _solve_blocked(self, rt, bg, queries, ctx, t0):
        from bibfs_tpu_torch.analytics.queries import TrianglesResult
        from bibfs_tpu_torch.ops.semiring_plane import (
            triangles_chunk_blocked,
        )

        self._note_exec(bg.nblocks, bg.bwidth, extra=(TRI_CHUNK,))
        total = torch.zeros(1, dtype=torch.int64, device=bg.device)
        chunks = 0
        for c0 in range(0, ctx.n, TRI_CHUNK):
            triangles_chunk_blocked(bg.tab, bg.bcol, c0, total, bits=bg.bits)
            chunks += 1
        self.rounds_cell.inc(chunks)
        res = TrianglesResult(
            found=True, count=int(total.item()) // 6,
            time_s=time.perf_counter() - t0,
        )
        return [res for _q in queries]


def build_analytics_routes(engine, label: str) -> dict:
    """The analytics rung set every engine carries (host + blocked per
    kind), each with its OWN retry policy and circuit breaker."""
    from bibfs_tpu_torch.serve.resilience import CircuitBreaker, RetryPolicy

    routes: dict = {}
    for cls in (SsspRoute, PageRankRoute, ComponentsRoute,
                TrianglesRoute, SsspBlockedRoute, PageRankBlockedRoute,
                ComponentsBlockedRoute, TrianglesBlockedRoute):
        routes[cls.name] = cls(
            engine, retry=RetryPolicy(), breaker=CircuitBreaker(),
            label=label,
        )
    return routes
