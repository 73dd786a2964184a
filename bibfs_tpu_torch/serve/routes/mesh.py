"""``route="mesh"`` — serving from a mesh of ranks: the counterpart of
``bibfs_tpu/serve/routes/mesh.py``.

:class:`MeshRoute` puts a :class:`~bibfs_tpu_torch.parallel.pool.MeshPool`
(ranks that stay up across flushes) behind the Route seam, with two
sub-paths chosen per batch:

- **dp** (queries sharded, graph replicated): every rank runs the
  batch-minor search on its lane-padded slice of the flush over its own
  replica of the fine-ladder table (:func:`~bibfs_tpu_torch.serve.
  buckets.dp_aligned_ell`), with no collective
  (:func:`~bibfs_tpu_torch.solvers.batch_minor.solve_batch_dp`): the
  throughput path, taken once the batch fills every rank's lane groups
  (``dp_min_batch``) on a large enough graph (``dp_min_n``);
- **sharded** (vertex-sharded 1D mesh): the graph's ELL rows are split
  over the ranks and each query runs the collective search in
  ``config.mode``, one after another
  (:func:`~bibfs_tpu_torch.solvers.sharded.solve_batch_sharded_graph`),
  the frontier crossing the ranks packed 32 vertices a word: the path for
  graphs of ``shard_min_n`` vertices and more, which every flush on such
  a graph takes.

Below both crossovers the route is not eligible: the engine counts
``bibfs_mesh_crossover_reroutes_total`` and the ladder goes on to the
single-device rungs (routing, not failure). The crossovers come from the
``mesh`` block of the platform's ``calibration.json`` entry when it was
measured on a mesh of this size, else the committed defaults
(``shard_min_n`` 2^20, ``dp_min_n`` 5000, ``dp_min_batch`` 128 lanes a
rank); a :class:`MeshConfig` overrides each.

The two stages map onto the pipelined engine's: :meth:`MeshRoute.launch`
ships the runtime's graph to the ranks on the first mesh flush of a
snapshot (a ``graph`` descriptor; the snapshot's retirement releases it,
so a hot swap re-shards the new one) and sends the flush's ``jobs``
descriptor; :meth:`MeshRoute.finish` waits for rank 0's materialized
results (paths, never parent rows: no forest is banked, as in the
reference). The engine's threads never enter a collective, and a rank
that dies or outlasts the pool's timeout fails the wait with
:class:`~bibfs_tpu_torch.parallel.pool.MeshError`. The route has its own
breaker and retry policy; its half-open probe respawns a pool that went
down (:meth:`~bibfs_tpu_torch.parallel.pool.MeshPool.ensure_up`). On a
CUDA engine only the injected ``mesh`` / ``mesh_finish`` faults go down
the ladder: a real :class:`MeshError` fails the batch's tickets
(``kind='internal'``) and counts on the route's breaker.

Exchange accounting (``bibfs_mesh_exchange_bytes_total{encoding}``): the
port's sharded batch runs its queries one after another, so each query
is charged the levels it actually ran, a side's packed plane per level
and rank (``packed``), against the same planes as one byte per vertex
(``bool``); the reference charges its padded lock-step program. The dp
path exchanges nothing.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass

import numpy as np

from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.serve.buckets import bucket_batch, placement_bucket_key
from bibfs_tpu_torch.serve.resilience import BREAKER_STATE_CODES
from bibfs_tpu_torch.serve.routes.base import Route

#: the committed defaults (the reference's), overridden by the calibrated
#: ``mesh`` block of the platform's entry when its ``devices`` match the
#: mesh. On the card the port has no ``mesh`` block yet, so a graph of
#: 2^20 vertices takes the sequential sharded path unless the caller sets
#: ``shard_min_n`` (PERF.md).
DEFAULT_DP_MIN_N = 5000
DEFAULT_SHARD_MIN_N = 1 << 20


@dataclass(frozen=True)
class MeshConfig:
    """Mesh-route configuration (``QueryEngine(mesh=...)``).

    ``devices`` — ranks (None: every card; one rank on the CPU);
    ``dp_min_batch`` / ``dp_min_n`` / ``shard_min_n`` — crossover
    overrides (None: calibrated, else the defaults); ``dt8`` — the
    int8-plane dp kernel on/off (None: int8 where the minor8 geometry
    fits); ``mode`` — the sharded path's search mode; ``pool`` — a running
    :class:`~bibfs_tpu_torch.parallel.pool.MeshPool` to serve from (shared
    across engines; the engine does not close it; default: the engine
    starts and closes its own)."""

    devices: int | None = None
    dp_min_batch: int | None = None
    dp_min_n: int | None = None
    shard_min_n: int | None = None
    dt8: bool | None = None
    mode: str = "sync"
    pool: object = None

    @classmethod
    def coerce(cls, mesh) -> "MeshConfig":
        """The engine's ``mesh=``: a config, a rank count or ``"auto"``."""
        if isinstance(mesh, cls):
            return mesh
        if mesh == "auto":
            return cls()
        if isinstance(mesh, bool):
            raise ValueError(
                "mesh= takes a device count, 'auto', or a MeshConfig")
        if isinstance(mesh, int):
            if mesh < 1:
                raise ValueError(f"mesh devices must be >= 1, got {mesh}")
            return cls(devices=mesh)
        raise ValueError(
            f"mesh= takes a device count, 'auto', or a MeshConfig; "
            f"got {mesh!r}")


def mesh_calibration(platform: str) -> dict:
    """The ``mesh`` block of ``calibration.json``'s entry for ``platform``
    (``cpu`` or ``cuda``); empty when absent."""
    from bibfs_tpu_torch.utils.calibrate import load_calibration

    cal = load_calibration(platform)
    if not cal:
        return {}
    block = cal.get("mesh")
    return block if isinstance(block, dict) else {}


class _MeshCells:
    """The mesh route's registry cells, minted at construction so a scrape
    shows the families at zero before any mesh traffic."""

    def __init__(self, label: str):
        self.shards = REGISTRY.gauge(
            "bibfs_mesh_shards",
            "Devices in the serving mesh (0 = mesh route not configured)",
            ("engine",),
        ).labels(engine=label)
        batches = REGISTRY.counter(
            "bibfs_mesh_batches_total",
            "Mesh-route batch dispatches by sub-path (dp/sharded)",
            ("engine", "path"),
        )
        self.batches = {
            "dp": batches.labels(engine=label, path="dp"),
            "sharded": batches.labels(engine=label, path="sharded"),
        }
        exch = REGISTRY.counter(
            "bibfs_mesh_exchange_bytes_total",
            "Frontier-exchange wire bytes by encoding (packed = the "
            "bitpacked payload actually shipped; bool = the unpacked "
            "counterfactual)",
            ("engine", "encoding"),
        )
        self.exchange = {
            "packed": exch.labels(engine=label, encoding="packed"),
            "bool": exch.labels(engine=label, encoding="bool"),
        }
        self.breaker_gauge = REGISTRY.gauge(
            "bibfs_mesh_breaker_state",
            "Mesh-route circuit breaker (0=closed 1=half_open 2=open)",
            ("engine",),
        ).labels(engine=label)
        self.reroutes = REGISTRY.counter(
            "bibfs_mesh_crossover_reroutes_total",
            "Below-crossover batches routed to the single-device path",
            ("engine",),
        ).labels(engine=label)

    def snapshot(self) -> dict:
        return {
            "shards": self.shards.value,
            "batches": {k: c.value for k, c in self.batches.items()},
            "exchange_bytes": {k: c.value for k, c in self.exchange.items()},
            "crossover_reroutes": self.reroutes.value,
        }


def mesh_prebuild(cfg: MeshConfig, device) -> tuple:
    """Validate ``cfg`` for an engine on ``device`` and start its pool,
    before the engine pins a store snapshot (a later raise would leak the
    pin): ``(pool, owned)``, ``owned`` False for ``cfg.pool``. A rank count
    the host cannot place, a failed NCCL start or an unknown mode raises
    here."""
    import torch

    from bibfs_tpu_torch.parallel.pool import MeshPool
    from bibfs_tpu_torch.solvers.sharded import SHARDED_MODES

    if cfg.mode not in SHARDED_MODES:
        raise ValueError(f"unknown mesh mode {cfg.mode!r}; have "
                         f"{sorted(SHARDED_MODES)}")
    dev = torch.device(device)
    if cfg.pool is not None:
        pool = cfg.pool
        if cfg.devices is not None and cfg.devices != pool.ranks:
            raise ValueError(f"mesh devices={cfg.devices} but the pool has "
                             f"{pool.ranks} ranks")
        if pool.device != dev.type:
            raise ValueError(f"a {pool.device} pool cannot serve a "
                             f"{dev.type} engine")
        pool.ensure_up()
        return pool, False
    ndev = cfg.devices or (torch.cuda.device_count() if dev.type == "cuda"
                           else 1)
    return MeshPool(ndev, dev.type), True


class MeshRoute(Route):
    """The mesh rung of the fallback ladder (module docstring), with its
    own circuit breaker and retry policy."""

    name = "mesh"
    is_dispatch = True

    def __init__(self, engine, cfg: MeshConfig, pool, *, retry, breaker,
                 label: str):
        super().__init__(engine, retry=retry, breaker=breaker)
        from bibfs_tpu_torch.solvers.batch_minor import LANES

        self.config = cfg
        self.pool = pool
        self.ndev = int(pool.ranks)
        cal = mesh_calibration(engine._device.type)
        try:
            cal_devs = int(cal.get("devices", -1))
        except (TypeError, ValueError):
            cal_devs = -1
        if cal_devs != self.ndev:
            # the crossovers are mesh-size specific (the dp lane crossover
            # is ndev * LANES): another size takes the defaults
            cal = {}
        self.dp_min_batch = int(
            cfg.dp_min_batch if cfg.dp_min_batch is not None
            else cal.get("dp_min_batch", self.ndev * LANES))
        self.dp_min_n = int(cfg.dp_min_n if cfg.dp_min_n is not None
                            else cal.get("dp_min_n", DEFAULT_DP_MIN_N))
        self.shard_min_n = int(
            cfg.shard_min_n if cfg.shard_min_n is not None
            else cal.get("shard_min_n", DEFAULT_SHARD_MIN_N))
        self._lock = threading.Lock()
        self._dt8_by_key: dict = {}
        self.cells = _MeshCells(label)
        self.cells.shards.set(self.ndev)
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
        """Above a crossover only: dp once the batch fills the mesh's lane
        groups on a large enough graph, sharded once the graph itself is
        mesh-scale."""
        return rt.n >= self.shard_min_n or (
            len(pairs) >= self.dp_min_batch and rt.n >= self.dp_min_n)

    def _use_dp(self, rt, pairs) -> bool:
        # a mesh-scale graph always takes the vertex-sharded path: the dp
        # sub-path replicates the whole table on every rank
        return (rt.n < self.shard_min_n and len(pairs) >= self.dp_min_batch
                and rt.n >= self.dp_min_n)

    # ---- the data-parallel plane type -------------------------------
    def _resolve_dt8(self, host, key, b_loc: int) -> bool:
        """Whether this graph and slice run the int8-plane dp kernel: the
        config's choice, else whether the minor8 geometry fits (probed
        once per bucket key and slice)."""
        if self.config.dt8 is not None:
            return self.config.dt8
        memo = (key, b_loc)
        with self._lock:
            hit = self._dt8_by_key.get(memo)
        if hit is not None:
            return hit
        from types import SimpleNamespace

        from bibfs_tpu_torch.solvers.batch_minor import _minor_geometry

        shape = SimpleNamespace(n_pad=host.n_pad, width=host.width,
                                tier_meta=())
        try:
            _minor_geometry(shape, b_loc, True)
            fits = True
        except ValueError:
            fits = False
        with self._lock:
            self._dt8_by_key[memo] = fits
        return fits

    # ---- the two-stage solve seam ------------------------------------
    def launch(self, rt, pairs):
        eng = self.engine
        with span("mesh_launch", batch=len(pairs), shards=self.ndev):
            if eng._faults is not None:
                eng._faults.fire("mesh", pairs)
            if not self.pool.up:
                if self.breaker.state != "half_open":
                    from bibfs_tpu_torch.parallel.pool import MeshError

                    raise MeshError("mesh pool is down (respawned at the "
                                    "breaker's half-open probe)")
                self.pool.ensure_up()  # the probe respawns the ranks
            arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
            if self._use_dp(rt, pairs):
                return self._launch_dp(rt, arr)
            return self._launch_sharded(rt, arr)

    def _launch_dp(self, rt, arr):
        from bibfs_tpu_torch.serve.buckets import ell_bucket_key
        from bibfs_tpu_torch.solvers.batch_minor import pad_batch

        key, host = rt.dp_graph(self)
        b_loc = pad_batch(-(-len(arr) // self.ndev))
        bkey = ell_bucket_key(host)
        dt8 = self._resolve_dt8(host, bkey, b_loc)
        self.engine.exec_cache.note(placement_bucket_key(
            bkey, kind="dp", shards=self.ndev,
            extra=("dt8" if dt8 else "i32", b_loc)))
        t0 = time.perf_counter()
        seq = self.pool.jobs([dict(kind="dp", graph=key, pairs=arr, dt8=dt8)])
        return seq, ("dp", None), t0

    def _launch_sharded(self, rt, arr):
        from bibfs_tpu_torch.serve.buckets import ell_bucket_key

        key, host = rt.mesh_graph(self)
        rung = min(bucket_batch(len(arr)), self.engine.max_batch)
        self.engine.exec_cache.note(placement_bucket_key(
            ell_bucket_key(host), kind="mesh1d", shards=self.ndev,
            extra=(self.config.mode, rung)))
        t0 = time.perf_counter()
        seq = self.pool.jobs([dict(kind="batch", graph=key, pairs=arr,
                                   mode=self.config.mode)])
        return seq, ("sharded", host.n_pad // self.ndev), t0

    def finish(self, out, fin, t0, pairs):
        kind, n_loc = fin
        with span("mesh_finish", batch=len(pairs), path=kind):
            eng = self.engine
            if eng._faults is not None:
                eng._faults.fire("mesh_finish", pairs)
            results = self.pool.wait(out)["results"][0]
            elapsed = time.perf_counter() - t0
            for r in results:
                r.time_s = elapsed
            if kind == "sharded":
                self._note_exchange(n_loc, results)
            # single mutator: the sync engine finishes on the flushing
            # thread, the pipelined engine on its one finish worker
            self.cells.batches[kind].inc()
            eng.counters["mesh_queries"] += len(pairs)
            return results

    def _note_exchange(self, n_loc: int, results) -> None:
        """Charge the sharded batch's frontier exchanges (module
        docstring): per query, one side's plane per level it ran, shipped
        by each rank."""
        from bibfs_tpu_torch.parallel.collectives import frontier_exchange_bytes

        planes = sum(r.levels for r in results) * self.ndev
        self.cells.exchange["packed"].inc(
            planes * frontier_exchange_bytes(n_loc, True))
        self.cells.exchange["bool"].inc(
            planes * frontier_exchange_bytes(n_loc, False))

    def hard_failure(self, exc: BaseException) -> None:
        """A failure the engine does not degrade: a real :class:`MeshError`
        counts on the breaker (a dead pool opens it, and its half-open
        probe respawns the ranks); anything else releases the claim."""
        from bibfs_tpu_torch.parallel.pool import MeshError

        if isinstance(exc, MeshError):
            self.breaker.record_failure()
        else:
            self.breaker.release()

    # ---- introspection -----------------------------------------------
    def stats(self) -> dict:
        out = super().stats()
        out.update(self.cells.snapshot())
        out["crossover"] = {
            "dp_min_batch": self.dp_min_batch,
            "dp_min_n": self.dp_min_n,
            "shard_min_n": self.shard_min_n,
        }
        out["pool"] = {"ranks": self.pool.ranks, "up": self.pool.up,
                       "generation": self.pool.generation,
                       "spawns": self.pool.spawns,
                       "spawn_s": self.pool.spawn_s,
                       "transport": self.pool.transport}
        return out
