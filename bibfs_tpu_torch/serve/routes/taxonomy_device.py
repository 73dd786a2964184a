"""Device-tier rungs for the taxonomy query kinds — ``msbfs_device``
/ ``weighted_device`` / ``kshortest_device`` as peer ladder rungs
above their host-tier kinds: the counterpart of
``bibfs_tpu/serve/routes/taxonomy_device.py``.

Each kind's device solver — the multi-source sweep
(:func:`bibfs_tpu_torch.ops.msbfs_device.msbfs_plane_graph`, the CUDA
``msbfs_sweep_kernel``), delta-stepping and the restricted batch BFS of
Yen's iterations (:mod:`bibfs_tpu_torch.solvers.query_device`, the CUDA
``delta_stepping_kernel`` and ``restricted_sweep_kernel``; their plain
torch twins on a CPU engine) — sits behind the full resilience
contract the dispatch rungs carry — its own retry policy and circuit
breaker (mirrored into ``bibfs_query_device_breaker_state{engine,
kind}`` the way the mesh/blocked gauges mirror theirs), its own chaos
seam (``msbfs_device`` / ``weighted_device`` / ``kshortest_device`` in
:data:`bibfs_tpu_torch.serve.faults.KNOWN_SITES`), and a place in the kind
ladder (:data:`bibfs_tpu_torch.serve.routes.taxonomy.KIND_LADDERS`) walked
by ``QueryEngine._flush_kind``: a faulted device rung degrades to the
existing host kind rung (counted in
``bibfs_route_fallbacks_total{from=<kind>_device,to=<kind>}``) with
zero lost tickets. On a CUDA engine only an injected fault degrades
(``Route.may_degrade``, the engine's rule): a kernel
that fails to build or launch, or memory that runs out, fails the
flush's tickets with a ``kind='internal'`` error instead of being
answered on the host.

Eligibility is the device ladder's rule set: the engine must route
device at all (``_use_device()`` — substrate-auto, forced by
``device_batches=True``), the flush must be bound to a BASE snapshot
(device tables are built from snapshots; overlay-merged truth stays on
the host rungs), the layout plain ELL (hub tiers carry edges the mask
gather would miss), and the batch above the kind's calibrated
crossover — the ``queries`` block of the calibration entry of the
engine's device type, read through :func:`queries_calibration` (the
card has no ``cuda`` block yet, so it reads the committed defaults). Per-kind adaptive ladders
(``AdaptiveRouter.order(kind=)``) reorder the walk per graph digest on
top of the static gates, unchanged.
"""

from __future__ import annotations

import time
import weakref

from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.serve.buckets import placement_bucket_key
from bibfs_tpu_torch.serve.resilience import BREAKER_STATE_CODES
from bibfs_tpu_torch.serve.routes.taxonomy import TaxonomyRoute

#: committed crossover defaults (the reference's), overridden by the
#: calibrated ``queries`` block of the platform's calibration entry.
#: msbfs: the sweep's launch amortizes over distinct sources — below a
#: handful the NumPy sweep's zero-launch start wins. weighted/kshortest:
#: one launch per solve (kshortest one per Yen iteration), from the first
#: query / any multi-path request.
DEFAULT_MSBFS_DEVICE_MIN_SOURCES = 8
DEFAULT_WEIGHTED_DEVICE_MIN_BATCH = 1
DEFAULT_KSHORTEST_DEVICE_MIN_K = 2


def queries_calibration(platform: str) -> dict:
    """The calibrated ``queries`` crossover block of ``platform``
    (``cpu`` or ``cuda``; empty when absent — callers fall back to the
    committed defaults)."""
    from bibfs_tpu_torch.utils.calibrate import load_calibration

    cal = load_calibration(platform)
    if not cal:
        return {}
    block = cal.get("queries")
    return block if isinstance(block, dict) else {}


class TaxonomyDeviceRoute(TaxonomyRoute):
    """Shared shape of the three device kind rungs: the substrate /
    snapshot-base / layout gates, the per-kind breaker gauge, and the
    ladder contract (an unavailable rung returns None from
    ``attempt`` and the kind degrades to its host rung — the device
    rungs never own a ``fallback`` of their own)."""

    host_tier = False  # the engine's degrade rule (module docstring)

    def __init__(self, engine, *, retry, breaker, label: str):
        super().__init__(engine, retry=retry, breaker=breaker)
        gauge = REGISTRY.gauge(
            "bibfs_query_device_breaker_state",
            "Device-tier query-kind rung circuit breakers "
            "(0=closed 1=half_open 2=open)",
            ("engine", "kind"),
        ).labels(engine=label, kind=self.kind)
        self.breaker_gauge = gauge
        # weakly bound through the route (registry cells are not
        # weakref-able): a shared breaker must not pin a dead engine's
        # route — the mesh/blocked/msbfs contract
        self_ref = weakref.ref(self)

        def _on_transition(state):
            route = self_ref()
            if route is None:
                return False
            route.breaker_gauge.set(BREAKER_STATE_CODES[state])
            return True

        breaker.add_listener(_on_transition)
        gauge.set(BREAKER_STATE_CODES[breaker.state])

    def kind_eligible(self, rt, queries, ctx) -> bool:
        """The device ladder's gates, kind edition (module
        docstring); subclasses add their calibrated crossover."""
        if ctx is None or not ctx.base:
            return False  # overlay-merged truth: host rungs answer
        if not self.engine._use_device():
            return False
        if rt.layout != "ell":
            return False  # hub tiers carry edges the sweep would miss
        return self._crossover(queries)

    def _crossover(self, queries) -> bool:
        return True

    def _fallback_one(self, rt, q, ctx):
        raise NotImplementedError(
            "device kind rungs degrade to their host kind route"
        )


class MsbfsDeviceRoute(TaxonomyDeviceRoute):
    """The device multi-source rung: the whole flush's distinct
    sources ride ONE multi-word sweep (one launch) over the uploaded
    table (:func:`bibfs_tpu_torch.ops.msbfs_device.msbfs_plane_graph`),
    unpacked into the same per-query reads the host sweep serves."""

    name = "msbfs_device"
    kind = "msbfs"

    def __init__(self, engine, *, retry, breaker, label: str):
        super().__init__(engine, retry=retry, breaker=breaker,
                         label=label)
        cal = queries_calibration(engine._device.type)
        self.min_sources = int(cal.get(
            "msbfs_min_sources", DEFAULT_MSBFS_DEVICE_MIN_SOURCES
        ))
        self.sweeps = 0  # single-mutator: the flushing thread

    def _crossover(self, queries) -> bool:
        distinct = len({int(s) for q in queries for s in q.sources})
        return distinct >= self.min_sources

    def launch(self, rt, queries, ctx=None):
        from bibfs_tpu_torch.ops.msbfs_device import (
            msbfs_plane_graph,
            plane_words,
        )
        from bibfs_tpu_torch.query.msbfs import solve_multi_source

        with span("msbfs_device_batch", batch=len(queries)):
            self._fire("msbfs_device", queries)
            t0 = time.perf_counter()
            g = rt.graph  # the uploaded serving table (lazy build)
            distinct = len({int(s) for q in queries for s in q.sources})
            self.engine.exec_cache.note(placement_bucket_key(
                ("msbfs", g.n_pad, g.width), kind="msbfs_device",
                shards=1, extra=(plane_words(distinct),),
            ))

            def dist_fn(sources):
                return msbfs_plane_graph(g, sources)

            with self.engine._on_device():
                results = solve_multi_source(
                    ctx.n, ctx.row_ptr, ctx.col_ind, queries,
                    dist_fn=dist_fn,
                )
            self.sweeps += 1
            return results, None, t0

    def stats(self) -> dict:
        out = super().stats()
        out["sweeps"] = self.sweeps
        out["crossover"] = {"min_sources": self.min_sources}
        return out


class WeightedDeviceRoute(TaxonomyDeviceRoute):
    """The device weighted rung: delta-stepping as one launch per query
    (:func:`bibfs_tpu_torch.solvers.query_device.delta_stepping_device`),
    the ELL-aligned weight tables memoized per (runtime, seed)."""

    name = "weighted_device"
    kind = "weighted"

    def __init__(self, engine, *, retry, breaker, label: str):
        super().__init__(engine, retry=retry, breaker=breaker,
                         label=label)
        cal = queries_calibration(engine._device.type)
        self.min_batch = int(cal.get(
            "weighted_min_batch", DEFAULT_WEIGHTED_DEVICE_MIN_BATCH
        ))

    def _crossover(self, queries) -> bool:
        return len(queries) >= self.min_batch

    def launch(self, rt, queries, ctx=None):
        from bibfs_tpu_torch.solvers.query_device import delta_stepping_device

        with span("weighted_device_batch", batch=len(queries)):
            self._fire("weighted_device", queries)
            t0 = time.perf_counter()
            out = []
            for q in queries:
                seed = int(q.weight_seed)
                # ctx.base holds, so the flush CSR IS the snapshot CSR
                # and the memoized derivations line up
                w = rt.weights_for(seed, ctx.row_ptr, ctx.col_ind)
                tables = rt.weighted_device_tables(seed)
                self.engine.exec_cache.note(placement_bucket_key(
                    ("weighted", int(tables[0].shape[0]),
                     int(tables[0].shape[1])),
                    kind="weighted_device", shards=1,
                ))
                with self.engine._on_device():
                    out.append(delta_stepping_device(
                        ctx.n, ctx.row_ptr, ctx.col_ind, w, tables,
                        int(q.src), int(q.dst),
                    ))
            return out, None, t0

    def stats(self) -> dict:
        out = super().stats()
        out["crossover"] = {"min_batch": self.min_batch}
        return out


class KShortestDeviceRoute(TaxonomyDeviceRoute):
    """The device k-shortest rung: Yen's with each iteration's spur
    candidates batched through ONE restricted-BFS launch
    (:func:`bibfs_tpu_torch.solvers.query_device.restricted_batch_paths`),
    the first path one more launch of one candidate (the reference finds
    it by a host BFS; the path is the same),
    per-candidate node masks on the plane, banned spur edges folded
    into the seeding — paths IDENTICAL to the host rung's by the
    shared canonical descent."""

    name = "kshortest_device"
    kind = "kshortest"

    def __init__(self, engine, *, retry, breaker, label: str):
        super().__init__(engine, retry=retry, breaker=breaker,
                         label=label)
        cal = queries_calibration(engine._device.type)
        self.min_k = int(cal.get(
            "kshortest_min_k", DEFAULT_KSHORTEST_DEVICE_MIN_K
        ))

    def _crossover(self, queries) -> bool:
        # k=1 has no spur candidates to batch — nothing for the
        # device program to amortize
        return any(int(q.k) >= self.min_k for q in queries)

    def launch(self, rt, queries, ctx=None):
        from bibfs_tpu_torch.query.kshortest import yen_k_shortest
        from bibfs_tpu_torch.solvers.query_device import restricted_batch_paths

        with span("kshortest_device_batch", batch=len(queries)):
            self._fire("kshortest_device", queries)
            t0 = time.perf_counter()
            g = rt.graph
            self.engine.exec_cache.note(placement_bucket_key(
                ("kshortest", g.n_pad, g.width),
                kind="kshortest_device", shards=1,
            ))
            out = []
            for q in queries:
                dst = int(q.dst)

                def spur_batch(cands, _dst=dst):
                    return restricted_batch_paths(
                        g, ctx.n, ctx.row_ptr, ctx.col_ind, _dst, cands
                    )

                with self.engine._on_device():
                    out.append(yen_k_shortest(
                        ctx.n, ctx.row_ptr, ctx.col_ind,
                        int(q.src), dst, int(q.k),
                        spur_batch=spur_batch,
                    ))
            return out, None, t0

    def stats(self) -> dict:
        out = super().stats()
        out["crossover"] = {"min_k": self.min_k}
        return out


def build_taxonomy_device_routes(engine, label: str) -> dict:
    """The device kind rungs every engine carries (ladder peers of the
    host kind routes — ineligible until the engine routes device at
    all), each with its OWN retry policy and circuit breaker."""
    from bibfs_tpu_torch.serve.resilience import CircuitBreaker, RetryPolicy

    return {
        "msbfs_device": MsbfsDeviceRoute(
            engine, retry=RetryPolicy(), breaker=CircuitBreaker(),
            label=label,
        ),
        "weighted_device": WeightedDeviceRoute(
            engine, retry=RetryPolicy(), breaker=CircuitBreaker(),
            label=label,
        ),
        "kshortest_device": KShortestDeviceRoute(
            engine, retry=RetryPolicy(), breaker=CircuitBreaker(),
            label=label,
        ),
    }
