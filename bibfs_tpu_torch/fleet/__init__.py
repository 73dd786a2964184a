"""Fleet serving: a health-aware router over N engine replicas, the
counterpart of ``bibfs_tpu/fleet``.

:class:`~bibfs_tpu_torch.fleet.router.Router` routes queries by
consistent hash on graph name (spilling hot graphs to the least-loaded
replica) across :class:`~bibfs_tpu_torch.fleet.replica.EngineReplica`
(in-process engines over per-replica graph stores),
:class:`~bibfs_tpu_torch.fleet.replica.ProcessReplica` (spawned
``bibfs-torch-serve`` children over stdin pipes) and
:class:`~bibfs_tpu_torch.fleet.netreplica.NetReplica` (spawned
``bibfs-torch-serve --port`` children over the framed TCP front door)
behind one replica interface; routing consumes replica health, failures
re-route with retry/backoff, and
:meth:`~bibfs_tpu_torch.fleet.router.Router.rolling_swap` rolls snapshot
swaps across the fleet one drained replica at a time.
``bibfs-torch-fleet`` is the CLI; ``serve/loadgen.py::run_fleet`` the
kill/restart + rolling-swap soak.

The self-healing elastic layer sits on top:
:class:`~bibfs_tpu_torch.fleet.supervisor.Supervisor` autoscales the
fleet (hysteresis + cooldown flap damping over the replicas' own serving
telemetry), respawns dead replicas, repairs stuck catch-ups from the
durable store, and heals watched pod meshes.

Every replica's engine runs on the card (``device="cuda"``, the
default) unless the caller asks for the CPU; the spawned children get
the replica's device as ``--device`` and fail their spawn when they
cannot reach it.
"""

from bibfs_tpu_torch.fleet.netreplica import NetReplica  # noqa: F401
from bibfs_tpu_torch.fleet.replica import (  # noqa: F401
    EngineReplica,
    ProcessReplica,
    ReplicaDead,
    engine_replica,
)
from bibfs_tpu_torch.fleet.router import (  # noqa: F401
    FLEET_METRIC_FAMILIES,
    FleetTicket,
    Router,
)
from bibfs_tpu_torch.fleet.supervisor import (  # noqa: F401
    ScalePolicy,
    Supervisor,
    Verdict,
    decide_scale,
)
