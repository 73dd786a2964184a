"""Pluggable serving routes (see :mod:`bibfs_tpu_torch.serve.routes.base`).

``build_routes`` is the one place the engine assembles its route set
and fallback ladder: the ladder runs ``device -> host`` with ``serial``
reached per query through the host isolator. The oracle, overlay, mesh,
blocked, query-kind and analytics routes of the JAX package come with
their slices of the port (ROADMAP Queue 1).
"""

from __future__ import annotations

from bibfs_tpu_torch.serve.routes.base import Route
from bibfs_tpu_torch.serve.routes.device import DeviceRoute
from bibfs_tpu_torch.serve.routes.host import HostRoute, SerialRoute

__all__ = ["Route", "DeviceRoute", "HostRoute", "SerialRoute", "build_routes"]


def build_routes(engine):
    """The engine's route set and fallback ladder: ``(routes, ladder)``,
    ``ladder`` the ordered batch rungs (``host`` terminal); ``serial``
    sits outside it. The device rung carries the engine's retry policy
    and circuit breaker."""
    routes = {
        "device": DeviceRoute(
            engine, retry=engine._retry, breaker=engine._breaker
        ),
        "host": HostRoute(engine),
        "serial": SerialRoute(engine),
    }
    return routes, ("device", "host")
