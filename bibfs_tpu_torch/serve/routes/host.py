"""``route="host"`` and ``route="serial"`` — the host rungs as Routes: the
counterpart of ``bibfs_tpu/serve/routes/host.py``.

The host route is the ladder's terminal batch rung: the engine solves it
(``QueryEngine._flush_host``) through the threaded native C batch when
the native runtime carries it, per query otherwise, and it never returns
unavailable — failure isolation happens inside it (the engine's
bisection isolator), converging a poison batch to per-query
``QueryError`` s with the serial rung as each singleton's last chance.
``serial`` is that bottom rung: the NumPy oracle over the bound
snapshot's CSR — no native runtime, no device, nothing left to be broken
but the graph itself.
"""

from __future__ import annotations

from bibfs_tpu_torch.serve.routes.base import Route


class HostRoute(Route):
    """The terminal batch rung (named in the ladder and ``stats()``; the
    engine's ``_flush_host`` solves it, never unavailable)."""

    name = "host"


class SerialRoute(Route):
    """The bottom rung, reached per query through the host isolator."""

    name = "serial"

    def solve_one(self, rt, src: int, dst: int):
        return rt.solve_serial_one(src, dst)
