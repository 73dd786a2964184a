"""Canonical metric-name registry: the counterpart of
``bibfs_tpu/obs/names.py``, with the same data.

The serving components of this package mint the JAX package's
``bibfs_*`` family names, kinds and labels, so one list serves both:
every ``*_METRIC_FAMILIES`` tuple groups the families one component
mints at its construction (so they render at zero before traffic), and
:data:`ALL_METRIC_NAMES` is their union. Render gates (the smoke's
``/metrics`` checks, the tests) read the tuples instead of spelling the
names out. Every group's component is ported: the fleet's families mint
in ``fleet/``, the pod worker's epoch gauge in ``parallel/podmesh.py``.

Data only, no imports: scripts and tests read it without pulling the
serving stack.
"""

from __future__ import annotations

#: sync/pipelined engine query accounting (serve/engine.py)
ENGINE_METRIC_FAMILIES = (
    "bibfs_queries_total",
    "bibfs_queries_routed_total",
    "bibfs_device_batches_total",
    "bibfs_cache_inserts_skipped_total",
)

#: pipelined-engine flusher/queue instrumentation (serve/pipeline.py)
PIPELINE_METRIC_FAMILIES = (
    "bibfs_flushes_total",
    "bibfs_flush_cause_total",
    "bibfs_submit_blocked_total",
    "bibfs_serve_queue_depth",
    "bibfs_serve_queue_depth_max",
    "bibfs_queue_wait_max_ms",
    "bibfs_batch_service_max_ms",
    "bibfs_query_latency_seconds",
)

#: distance/executable cache accounting (serve/cache.py, serve/buckets.py)
CACHE_METRIC_FAMILIES = (
    "bibfs_dist_cache_events_total",
    "bibfs_dist_cache_entries",
    "bibfs_exec_cache_events_total",
    "bibfs_exec_programs",
    "bibfs_exec_program_dispatches_total",
    "bibfs_exec_compiles_total",
)

#: failure-handling telemetry (serve/resilience threading + serve/faults);
#: all minted at engine construction, so the chaos gate asserts the FULL
#: group renders — not the hand-picked subset it used to
RESILIENCE_METRIC_FAMILIES = (
    "bibfs_errors_total",
    "bibfs_route_fallbacks_total",
    "bibfs_retries_total",
    "bibfs_batch_bisections_total",
    "bibfs_breaker_state",
    "bibfs_breaker_transitions_total",
    "bibfs_health_state",
    "bibfs_faults_injected_total",
)

#: versioned graph store (store/registry.py); the memory-tier trio
#: (mmap_bytes / tier / remap) is minted at store construction and
#: per-graph registration like the rest, so every group member renders
#: at zero before the first checkpoint or recovery
STORE_METRIC_FAMILIES = (
    "bibfs_store_graphs",
    "bibfs_store_swaps_total",
    "bibfs_store_delta_edges",
    "bibfs_store_compactions_total",
    "bibfs_store_compact_failures_total",
    "bibfs_store_mmap_bytes",
    "bibfs_store_tier",
    "bibfs_store_remap_total",
)

#: WAL durability layer (store/wal.py + store/registry.py); the crash
#: soak's render gate and the bench CI gate share this exact tuple
DURABLE_METRIC_FAMILIES = (
    "bibfs_wal_records_total",
    "bibfs_wal_fsyncs_total",
    "bibfs_checkpoints_total",
    "bibfs_recovery_replayed_records",
    "bibfs_recovery_seconds",
)

#: landmark distance-oracle tier (oracle/oracle.py + store/registry.py)
ORACLE_METRIC_FAMILIES = (
    "bibfs_oracle_hits_total",
    "bibfs_oracle_index_builds_total",
    "bibfs_oracle_index_age_seconds",
)

#: mesh-sharded serving route (serve/routes/mesh.py); minted at route
#: construction (engines configured with ``mesh=``), so a mesh-enabled
#: process renders the whole group at zero before any mesh traffic
MESH_METRIC_FAMILIES = (
    "bibfs_mesh_shards",
    "bibfs_mesh_batches_total",
    "bibfs_mesh_exchange_bytes_total",
    "bibfs_mesh_breaker_state",
    "bibfs_mesh_crossover_reroutes_total",
)

#: blocked (MXU-tile) serving route (serve/routes/blocked.py); minted
#: at route construction (engines configured with ``blocked=``), so a
#: blocked-enabled process renders the group at zero before any traffic
BLOCKED_METRIC_FAMILIES = (
    "bibfs_blocked_batches_total",
    "bibfs_blocked_breaker_state",
)

#: telemetry-driven adaptive routing (serve/policy.py; the frontier
#: histogram is fed by every telemetry-enabled solve, obs/telemetry.py)
ADAPTIVE_METRIC_FAMILIES = (
    "bibfs_routes_adaptive_total",
    "bibfs_level_frontier_fraction",
)

#: query taxonomy routes (serve/routes/taxonomy.py); minted at
#: route-set construction on EVERY engine, so any serving process
#: renders the group at zero before the first taxonomy query
QUERY_METRIC_FAMILIES = (
    "bibfs_query_total",
    "bibfs_query_asof_replay_seconds",
    "bibfs_msbfs_breaker_state",
    "bibfs_query_device_breaker_state",
)

#: whole-graph analytics tier (serve/routes/analytics.py +
#: analytics/results.py): the rounds counter and blocked-rung breaker
#: gauges mint at route-set construction on EVERY engine, the result-
#: store event/entry families at store construction — all render at
#: zero before the first analytics query
ANALYTICS_METRIC_FAMILIES = (
    "bibfs_analytics_rounds_total",
    "bibfs_analytics_breaker_state",
    "bibfs_analytics_store_events_total",
    "bibfs_analytics_store_entries",
)

#: network front door (serve/net.py); minted at NetServer construction
#: so a ``bibfs-serve --port`` process renders the whole group at zero
#: before the first connection. Rejection reasons are tenant-less
#: labels (reason= only — tenant ids are unbounded cardinality)
NET_METRIC_FAMILIES = (
    "bibfs_net_connections",
    "bibfs_net_requests_total",
    "bibfs_net_rejections_total",
    "bibfs_net_bytes_total",
    "bibfs_net_deadline_misses_total",
)

#: self-healing elastic layer (fleet/supervisor.py + fleet/router.py +
#: parallel/podmesh.py + serve/net.py): scale events and the replica
#: target mint at Supervisor construction, the catchup-stuck gauge at
#: Router construction (per replica, zero when healthy), the worker
#: epoch gauge at PodPrimary construction, and the admission-shed
#: counter (brownout ladder + deadline-feasibility, reason-labeled)
#: at NetServer construction — the elastic soak's render gate scrapes
#: exactly this tuple, so every family must render at zero before the
#: first scale event
ELASTIC_METRIC_FAMILIES = (
    "bibfs_fleet_scale_events_total",
    "bibfs_fleet_replicas_target",
    "bibfs_fleet_catchup_stuck",
    "bibfs_pod_worker_epoch",
    "bibfs_admission_shed_total",
)

#: distributed tracing + per-query cost attribution (obs/dtrace.py):
#: the span-spool counter mints at DTracer construction, the
#: flight-recorder dump counter at module import (process-singleton
#: recorder), and the stage histogram at engine / front-door
#: construction via ``dtrace.stage_histogram()`` — all render at zero
#: before the first sampled query
DTRACE_METRIC_FAMILIES = (
    "bibfs_stage_seconds",
    "bibfs_trace_spans_total",
    "bibfs_flightrec_dumps_total",
)

#: build identity (obs/metrics.py; minted at every registry init)
BUILD_INFO_METRIC = "bibfs_build_info"

#: fleet router (fleet/router.py) — bibfs_build_info rides along in the
#: gate tuple below because "which build is this replica" is the fleet
#: question a rolling restart asks
_FLEET_ONLY = (
    "bibfs_fleet_replicas",
    "bibfs_fleet_routed_total",
    "bibfs_fleet_reroutes_total",
    "bibfs_fleet_rolls_total",
    "bibfs_fleet_spills_total",
    "bibfs_fleet_catchups_total",
)
FLEET_METRIC_FAMILIES = _FLEET_ONLY + (BUILD_INFO_METRIC,)

#: every metric family the process can mint, grouped — the metric-mint
#: lint rule's ground truth
ALL_METRIC_NAMES = frozenset(
    ENGINE_METRIC_FAMILIES
    + PIPELINE_METRIC_FAMILIES
    + CACHE_METRIC_FAMILIES
    + RESILIENCE_METRIC_FAMILIES
    + STORE_METRIC_FAMILIES
    + DURABLE_METRIC_FAMILIES
    + ORACLE_METRIC_FAMILIES
    + MESH_METRIC_FAMILIES
    + BLOCKED_METRIC_FAMILIES
    + ADAPTIVE_METRIC_FAMILIES
    + QUERY_METRIC_FAMILIES
    + ANALYTICS_METRIC_FAMILIES
    + NET_METRIC_FAMILIES
    + ELASTIC_METRIC_FAMILIES
    + DTRACE_METRIC_FAMILIES
    + _FLEET_ONLY
    + (BUILD_INFO_METRIC,)
)

#: families rendered with Prometheus histogram exposition (each also
#: renders ``<name>_bucket{le=}`` / ``<name>_count`` / ``<name>_sum``
#: series — :func:`exposition_names`)
HISTOGRAM_METRIC_NAMES = frozenset((
    "bibfs_query_latency_seconds",
    "bibfs_level_frontier_fraction",
    "bibfs_stage_seconds",
))

#: ``bibfs_``-prefixed tokens that are NOT metric names (package paths,
#: reference source files) — the lint's literal/README scans skip these
NON_METRIC_TOKENS = frozenset((
    "bibfs_tpu",        # the package itself (paths in prose)
    "bibfs_cuda_only",  # the reference's v3 CUDA source file
))

#: the names the live-endpoint CI probe
#: (scripts/check_metrics_endpoint.py) asserts on a real
#: ``bibfs-serve --metrics-port`` scrape — the minimal always-on
#: pipelined-serving surface (store/fleet/oracle families need those
#: subsystems attached and are gated by their own soaks)
SERVE_ENDPOINT_METRICS = (
    "bibfs_queries_total",
    "bibfs_queries_routed_total",
    "bibfs_query_total",
    "bibfs_dist_cache_events_total",
    "bibfs_flush_cause_total",
    "bibfs_flushes_total",
    "bibfs_query_latency_seconds",
    "bibfs_serve_queue_depth",
    # per-query cost attribution: pre-labeled at engine construction,
    # so a live /metrics renders every stage cell at zero
    "bibfs_stage_seconds",
)


def exposition_names(name: str) -> tuple:
    """The text-exposition series one family renders: the family name
    itself for counters/gauges, the ``_bucket``/``_count``/``_sum``
    triple for histograms."""
    if name in HISTOGRAM_METRIC_NAMES:
        return (f"{name}_bucket", f"{name}_count", f"{name}_sum")
    return (name,)


def canonical_family(token: str) -> str | None:
    """Resolve a ``bibfs_*`` token to its canonical family name: the
    name itself, or the histogram family a ``_bucket``/``_count``/
    ``_sum`` exposition series belongs to. None if the token is not a
    known metric."""
    if token in ALL_METRIC_NAMES:
        return token
    for suffix in ("_bucket", "_count", "_sum"):
        if token.endswith(suffix):
            base = token[: -len(suffix)]
            if base in HISTOGRAM_METRIC_NAMES:
                return base
    return None
