"""``route="blocked"`` — the blocked tile expansion as a rung of the
fallback ladder (``blocked -> device -> host``): the counterpart of
``bibfs_tpu/serve/routes/blocked.py``.

The compute lives in ``graph/blocked.py``, ``ops/blocked_expand.py`` and
the blocked search of ``solvers/dense.py``: a flush's whole dual-side
frontier plane advances per level as masked block products over the
tiled int8 adjacency (on the card, a hand-written tensor-core kernel).

Routing: the table trades arithmetic for locality, so it loses on graphs
whose tile structure is not compact (a sparse random graph lights up
nearly every tile at a few edges each). The static gate is the
candidate-waste ratio (stored tile candidates per directed edge) under
``waste_cap``, the batch crossover ``min_batch`` and the working-set fit;
the two constants come from the platform's ``blocked`` calibration block
where it has one, else the committed defaults. The per-graph ordering on
top of the static gate belongs to the
:class:`~bibfs_tpu_torch.serve.policy.AdaptiveRouter` when the engine
runs adaptive. The route carries its own circuit breaker and retry policy
and its own chaos sites (``blocked`` / ``blocked_finish``).

The two stages split as the device route's do in this package: ``launch``
runs the batch on the engine's device and copies the real queries'
outputs (their dist rows) to the host once, so ``finish`` (the path
walks over the snapshot's CSR) touches no tensor on the card and the
pipelined finish worker never uses it.

Executable identity: blocked programs are noted under
``placement_bucket_key(kind="blocked")`` over the blocked shape key
(``graph/blocked.blocked_bucket_key``).
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.serve.buckets import bucket_batch, placement_bucket_key
from bibfs_tpu_torch.serve.resilience import BREAKER_STATE_CODES
from bibfs_tpu_torch.serve.routes.base import Route

#: committed defaults, overridden by the platform's calibrated ``blocked``
#: block. min_batch: the plane pads to 128 lanes per side, so the route
#: pays once a flush fills a lane group. waste_cap: stored tile candidates
#: per directed edge; the JAX package measured its wins (grid ~99,
#: dense-ish G(n, p) ~32-96) under 128, and the sparse random regime where
#: the route loses sits in the thousands.
DEFAULT_BLOCKED_MIN_BATCH = 128
DEFAULT_BLOCKED_WASTE_CAP = 128.0


@dataclass(frozen=True)
class BlockedConfig:
    """Blocked-route configuration (``QueryEngine(blocked=...)``).

    ``min_batch`` / ``waste_cap`` override the calibrated crossover
    constants (None = calibration, else the committed defaults); ``dt``
    forces the frontier-plane type (None = int8 on the card, float32 on
    the CPU; the CUDA kernel takes int8 only)."""

    min_batch: int | None = None
    waste_cap: float | None = None
    dt: str | None = None

    @classmethod
    def coerce(cls, blocked) -> "BlockedConfig":
        if isinstance(blocked, cls):
            return blocked
        if blocked is True:
            return cls()
        raise ValueError(
            f"blocked= takes True or a BlockedConfig; got {blocked!r}"
        )


def _dtype_name(dt: torch.dtype) -> str:
    """``int8`` / ``float32``: the JAX package's dtype names."""
    return str(dt).removeprefix("torch.")


def blocked_calibration(platform: str) -> dict:
    """The ``blocked`` block of ``calibration.json``'s entry for
    ``platform`` (``cpu`` or ``cuda``); empty when absent, and callers
    then take the committed defaults."""
    from bibfs_tpu_torch.utils.calibrate import load_calibration

    cal = load_calibration(platform)
    if not cal:
        return {}
    block = cal.get("blocked")
    return block if isinstance(block, dict) else {}


class _BlockedCells:
    """The blocked route's registry cells, minted at route construction so
    a scrape shows the family at zero before any blocked traffic."""

    def __init__(self, label: str):
        self.batches = REGISTRY.counter(
            "bibfs_blocked_batches_total",
            "Blocked-route batch dispatches (masked block-matmul "
            "expansion)",
            ("engine",),
        ).labels(engine=label)
        self.breaker_gauge = REGISTRY.gauge(
            "bibfs_blocked_breaker_state",
            "Blocked-route circuit breaker (0=closed 1=half_open 2=open)",
            ("engine",),
        ).labels(engine=label)

    def snapshot(self) -> dict:
        return {"batches": self.batches.value}


class BlockedRoute(Route):
    """The tile rung of the fallback ladder (module docstring). Its own
    breaker and retry policy: a broken blocked rung degrades to the
    device and host rungs, never to unavailability (on a CUDA engine only
    for an injected fault, as the device route)."""

    name = "blocked"
    is_dispatch = True

    def __init__(self, engine, cfg: BlockedConfig, *, retry, breaker,
                 label: str):
        super().__init__(engine, retry=retry, breaker=breaker)
        from bibfs_tpu_torch.ops.blocked_expand import resolve_plane_dtype

        self.config = cfg
        platform = engine._device.type
        cal = blocked_calibration(platform)
        self.min_batch = int(
            cfg.min_batch if cfg.min_batch is not None
            else cal.get("min_batch", DEFAULT_BLOCKED_MIN_BATCH)
        )
        self.waste_cap = float(
            cfg.waste_cap if cfg.waste_cap is not None
            else cal.get("waste_cap", DEFAULT_BLOCKED_WASTE_CAP)
        )
        self.dt = resolve_plane_dtype(cfg.dt, engine._device)
        if platform == "cuda" and self.dt.itemsize != 1:
            raise ValueError(
                f"the blocked kernel takes int8 planes; dt={cfg.dt!r}"
            )
        self.cells = _BlockedCells(label)
        # a weakly bound breaker-gauge listener: a shared breaker must not
        # pin dead cells (returning False unsubscribes)
        cells_ref = weakref.ref(self.cells)

        def _on_transition(state):
            cells = cells_ref()
            if cells is None:
                return False
            cells.breaker_gauge.set(BREAKER_STATE_CODES[state])
            return True

        breaker.add_listener(_on_transition)
        self.cells.breaker_gauge.set(BREAKER_STATE_CODES[breaker.state])

    # ---- selection ---------------------------------------------------
    def eligible(self, rt, pairs) -> bool:
        """Above the batch crossover, on a graph whose tile structure is
        compact enough to pay, within the working-set fit. The meta check
        reads counts only: the table is built at the first routed
        flush."""
        if len(pairs) < self.min_batch:
            return False
        from bibfs_tpu_torch.graph.blocked import TILE
        from bibfs_tpu_torch.ops.blocked_expand import blocked_fits

        nblocks, bwidth, _nnz = rt.blocked_meta()
        edges2 = 2 * rt.snapshot.num_edges
        if edges2 == 0:
            return False
        waste = bwidth * TILE * nblocks * TILE / edges2
        if waste > self.waste_cap:
            return False
        return blocked_fits(nblocks, bwidth, bucket_batch(len(pairs)),
                            itemsize=self.dt.itemsize)

    # ---- the two-stage solve seam ------------------------------------
    def launch(self, rt, pairs):
        """Stage 1: pad the flush to its batch rung with inert ``(0, 0)``
        queries, note the program identity, run the batch on the engine's
        device and copy the real queries' outputs to the host. Returns
        ``(outs, meta, t0)``: the host arrays (``best``, ``meet``, the
        ``[n_pad, 2b]`` dist plane, ``levels``, ``edges``),
        ``(elapsed, host_syncs)`` and the dispatch start."""
        from bibfs_tpu_torch.solvers.batch_minor import blocked_batch_dispatch
        from bibfs_tpu_torch.solvers.dense import _host
        from bibfs_tpu_torch.solvers.timing import force_scalar

        b = len(pairs)
        with span("blocked_launch", batch=b):
            eng = self.engine
            if eng._faults is not None:
                eng._faults.fire("blocked", pairs)
            g = rt.blocked_graph()
            rung = min(bucket_batch(b), eng.max_batch)
            padded = np.zeros((rung, 2), dtype=np.int64)
            padded[:b] = pairs
            eng.exec_cache.note(placement_bucket_key(
                rt.blocked_bucket_key, kind="blocked", shards=1,
                extra=(_dtype_name(self.dt), rung),
            ))
            stats = {"host_syncs": 0}
            with eng._on_device():
                _p, thunk = blocked_batch_dispatch(g, padded, dt=self.dt,
                                                   stats=stats)
                t0 = time.perf_counter()
                out = thunk()
                force_scalar(out)
                elapsed = time.perf_counter() - t0
                best, meet, dist, levels, edges = out
                # the real queries' dist rows of both sides, one copy
                dq = dist.T
                half = dq.shape[0] // 2
                rows = _host(torch.cat((dq[:b], dq[half:half + b])))
                outs = [_host(best[:b]), _host(meet[:b]), rows.T,
                        _host(levels[:b]), _host(edges[:b])]
            return outs, (elapsed, stats["host_syncs"]), t0

    def finish(self, outs, meta, t0, pairs):
        """Stage 2: the path walks over the snapshot's CSR, from the host
        copies :meth:`launch` made."""
        from bibfs_tpu_torch.solvers.dense import _materialize_blocked_batch

        with span("blocked_finish", batch=len(pairs)):
            eng = self.engine
            if eng._faults is not None:
                eng._faults.fire("blocked_finish", pairs)
            elapsed, host_syncs = meta
            results = _materialize_blocked_batch(
                outs, pairs, elapsed, *eng._current_rt().snapshot.csr(),
                host_syncs=host_syncs,
            )
            # one mutator: the flushing thread (sync) or the one finish
            # worker (pipelined)
            self.cells.batches.inc()
            eng.counters["blocked_queries"] += len(pairs)
            return results

    # ---- introspection -----------------------------------------------
    def stats(self) -> dict:
        out = super().stats()
        out.update(self.cells.snapshot())
        out["crossover"] = {
            "min_batch": self.min_batch,
            "waste_cap": self.waste_cap,
            "plane_dtype": _dtype_name(self.dt),
        }
        return out

