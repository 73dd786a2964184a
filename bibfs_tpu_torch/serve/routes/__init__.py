"""Pluggable serving routes (see :mod:`bibfs_tpu_torch.serve.routes.base`).

``build_routes`` is the one place the engine assembles its route set
and fallback ladder: the ladder runs ``device -> host``, with the
blocked tile rung ahead of device when the engine has one
(``blocked -> device -> host``), and ``serial`` reached per query
through the host isolator. ``oracle`` (submit-time consult) and
``overlay`` (exact base + delta answering) sit outside the ladder. The
query-kind routes (:mod:`bibfs_tpu_torch.serve.routes.taxonomy` and
:mod:`bibfs_tpu_torch.serve.routes.taxonomy_device`) ride every engine,
dispatched by kind at flush time down their own ladders. The mesh rung
(:mod:`bibfs_tpu_torch.serve.routes.mesh`) leads the ladder when the
engine has one (``mesh -> blocked -> device -> host``). The analytics
kinds' host and blocked rungs
(:mod:`bibfs_tpu_torch.serve.routes.analytics`) join the query-kind set.
"""

from __future__ import annotations

from bibfs_tpu_torch.serve.routes.analytics import (
    AnalyticsBlockedRoute,
    AnalyticsHostRoute,
    build_analytics_routes,
)
from bibfs_tpu_torch.serve.routes.base import Route
from bibfs_tpu_torch.serve.routes.blocked import BlockedConfig, BlockedRoute
from bibfs_tpu_torch.serve.routes.device import DeviceRoute
from bibfs_tpu_torch.serve.routes.host import HostRoute, SerialRoute
from bibfs_tpu_torch.serve.routes.mesh import (
    MeshConfig,
    MeshRoute,
    mesh_prebuild,
)
from bibfs_tpu_torch.serve.routes.oracle import OracleRoute
from bibfs_tpu_torch.serve.routes.overlay import OverlayRoute
from bibfs_tpu_torch.serve.routes.taxonomy import (
    KIND_LADDERS,
    KIND_ROUTES,
    AsOfRoute,
    KindCtx,
    KindResultCache,
    KShortestRoute,
    MsbfsRoute,
    QueryKindCells,
    WeightedRoute,
    build_taxonomy_routes,
)
from bibfs_tpu_torch.serve.routes.taxonomy_device import (
    KShortestDeviceRoute,
    MsbfsDeviceRoute,
    WeightedDeviceRoute,
    build_taxonomy_device_routes,
)

__all__ = ["AnalyticsBlockedRoute", "AnalyticsHostRoute",
           "build_analytics_routes", "Route", "BlockedConfig", "BlockedRoute", "DeviceRoute",
           "HostRoute", "MeshConfig", "MeshRoute", "OracleRoute",
           "OverlayRoute", "SerialRoute",
           "KIND_LADDERS", "KIND_ROUTES", "AsOfRoute", "KindCtx",
           "KindResultCache", "KShortestRoute", "KShortestDeviceRoute",
           "MsbfsRoute", "MsbfsDeviceRoute", "QueryKindCells",
           "WeightedRoute", "WeightedDeviceRoute", "build_routes",
           "build_taxonomy_device_routes", "build_taxonomy_routes",
           "mesh_prebuild"]


def build_routes(engine, mesh_cfg=None, mesh_pre=None, blocked_cfg=None):
    """The engine's route set and fallback ladder: ``(routes, ladder)``,
    ``ladder`` the ordered batch rungs (``host`` terminal); ``oracle``,
    ``overlay``, ``serial`` and the query-kind routes sit outside it. The
    device rung carries the engine's retry policy and circuit breaker;
    ``blocked_cfg`` adds the blocked rung ahead of device and ``mesh_cfg``
    the mesh rung ahead of all (over ``mesh_pre``, the ``(pool, owned)``
    :func:`mesh_prebuild` returned before the engine pinned its snapshot),
    each with a retry policy and breaker of its own."""
    from bibfs_tpu_torch.serve.resilience import CircuitBreaker, RetryPolicy

    routes = {
        "oracle": OracleRoute(engine),
        "overlay": OverlayRoute(engine),
        "device": DeviceRoute(
            engine, retry=engine._retry, breaker=engine._breaker
        ),
        "host": HostRoute(engine),
        "serial": SerialRoute(engine),
    }
    # the query-kind routes ride every engine: dispatched by kind at flush
    # time, never from the point-to-point ladder below
    routes.update(build_taxonomy_routes(engine, engine.obs_label))
    ladder = ("device", "host")
    if blocked_cfg is not None:
        routes["blocked"] = BlockedRoute(
            engine, blocked_cfg,
            retry=RetryPolicy(), breaker=CircuitBreaker(),
            label=engine.obs_label,
        )
        ladder = ("blocked",) + ladder
    if mesh_cfg is not None:
        routes["mesh"] = MeshRoute(
            engine, mesh_cfg, mesh_pre[0],
            retry=RetryPolicy(), breaker=CircuitBreaker(),
            label=engine.obs_label,
        )
        ladder = ("mesh",) + ladder
    return routes, ladder
