"""Self-healing elastic fleet control loop: the counterpart of
``bibfs_tpu/fleet/supervisor.py``.

The :class:`~bibfs_tpu_torch.fleet.router.Router` gave the fleet a health
table, failover and rolling swaps — but capacity was still an
operator decision and a dead replica stayed dead until someone typed
``restart``. The :class:`Supervisor` closes that loop. One daemon
thread per fleet ticks every ``poll_interval_s`` and owns four jobs:

- **autoscaling.** The decision core (:func:`decide_scale`) is a PURE
  function from ``(policy, replica count, signal snapshot, clock,
  streak state)`` to a scale verdict, so the flap-damping rules are
  unit-testable with scripted metric feeds and no processes. Signals
  come from the replicas' own serving telemetry (queue depths via
  ``replica.load()``; ``latency_ms`` p99 from ``stats()`` when a p99
  threshold is configured) — the same numbers the metrics registry
  exports. Two dampers keep the target from oscillating: a signal
  must hold over (or under) its threshold for ``settle_ticks``
  consecutive ticks (hysteresis), and after any scale event the
  target is frozen for ``cooldown_s`` (flap damping) — the elastic
  soak gates on zero target oscillation inside one cooldown window.
- **fast scale-out.** ``spawn(index)`` is the caller's factory; its
  contract is that the replica it returns is CHEAP to warm — seeded
  from the current durable store (WAL catch-up), mmap sidecars
  remapped, policy sidecar prewarmed — and the supervisor still
  ready-probes it end-to-end BEFORE :meth:`Router.add_replica`, so a
  scale-out replica is warm before it can be picked. Scale-in drains
  (``begin_drain`` + ``flush``) before retiring, so no acked ticket
  is lost.
- **dead-replica respawn.** A ``dead`` table entry is restarted (same
  replica object, next incarnation) with ``respawn_backoff_s``
  between attempts; the router's catch-up gate then holds it in
  ``catchup`` until it declares the fleet's committed version — the
  supervisor never bypasses that gate.
- **wedge repair (the catch-up escape hatch).** A replica held in
  ``catchup`` longer than ``stuck_after_s`` — lagging beyond
  ``ROLL_HISTORY_MAX`` rolls, or respawned with a half-applied roll
  re-armed in its overlay (the documented mid-roll-crash trade in
  ``Router._try_catchup``) — is REPLACED: a fresh replica is spawned
  from the current durable store, warmed, admitted, and only then is
  the wedged one removed and closed. Safe-but-unroutable stays the
  default; the hatch is the supervisor's explicit, counted repair.

Pod-worker failure domains ride the same loop: :meth:`watch_pod`
registers a pod primary (duck-typed: anything with
``check_heartbeats()`` and ``dead_workers()``, the surface of the
reference's ``PodPrimary``) plus a respawn callback; each tick checks worker heartbeats and calls the
callback for dead workers, which re-spawns the worker at a higher
incarnation epoch and re-admits it through ``accept_rejoin`` — the
zombie's late acks stay fenced by the epoch check in the primary's
reader.

Every action is counted in ``bibfs_fleet_scale_events_total{dir,
reason}`` and the current target is exported as
``bibfs_fleet_replicas_target`` — what the soak's flap gate and the
dashboards both read.

Thread discipline: all mutable supervisor state sits under ``_lock``;
spawning, warming, draining and closing replicas (blocking I/O,
seconds) happen OUTSIDE it — the lock only guards bookkeeping, so
``stats()`` never blocks behind a spawn.
"""

from __future__ import annotations

import threading
import time

from bibfs_tpu_torch.utils.annotations import guarded_by
from bibfs_tpu_torch.obs.metrics import REGISTRY, next_instance_label

#: every (dir, reason) pair the supervisor emits — pre-minted at
#: construction so the family renders at zero before the first event
SCALE_EVENT_KINDS = (
    ("out", "queue"),
    ("out", "p99"),
    ("out", "shed"),
    ("in", "idle"),
    ("respawn", "dead"),
    ("respawn", "pod_worker"),
    ("repair", "catchup_stuck"),
)


class ScalePolicy:
    """The autoscaler's thresholds and dampers.

    ``queue_hi``/``queue_lo`` bound the fleet-max queue depth
    (``replica.load()``) that triggers scale-out / allows scale-in;
    ``p99_hi_ms``/``p99_lo_ms`` and ``shed_hi`` are optional extra
    signals (None = not consulted). ``settle_ticks`` is the
    hysteresis window: a signal must hold beyond its threshold for
    that many CONSECUTIVE ticks before the verdict fires.
    ``cooldown_s`` freezes the target after any scale event (flap
    damping). ``stuck_after_s`` arms the catch-up escape hatch;
    ``respawn_backoff_s`` paces dead-replica restarts;
    ``warm_timeout_s`` bounds the pre-admission ready probe."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 queue_hi: int = 64, queue_lo: int = 4,
                 p99_hi_ms: float | None = None,
                 p99_lo_ms: float | None = None,
                 shed_hi: float | None = None,
                 settle_ticks: int = 2, cooldown_s: float = 10.0,
                 stuck_after_s: float = 30.0,
                 respawn_backoff_s: float = 2.0,
                 warm_timeout_s: float = 60.0):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1: {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas "
                f"{min_replicas}"
            )
        if queue_lo > queue_hi:
            raise ValueError(
                f"queue_lo {queue_lo} > queue_hi {queue_hi}"
            )
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_hi = int(queue_hi)
        self.queue_lo = int(queue_lo)
        self.p99_hi_ms = p99_hi_ms
        self.p99_lo_ms = p99_lo_ms
        self.shed_hi = shed_hi
        self.settle_ticks = max(1, int(settle_ticks))
        self.cooldown_s = float(cooldown_s)
        self.stuck_after_s = float(stuck_after_s)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.warm_timeout_s = float(warm_timeout_s)


class Verdict:
    """One autoscale decision: ``action`` in ``("out", "in", "hold")``,
    the ``reason`` that drove it (signal name, or ``cooldown`` /
    ``at_max`` / ``at_min`` / ``steady`` for holds) and the replica
    ``target`` it implies."""

    __slots__ = ("action", "reason", "target")

    def __init__(self, action: str, reason: str, target: int):
        self.action = action
        self.reason = reason
        self.target = int(target)

    def __repr__(self) -> str:
        return (f"Verdict(action={self.action!r}, "
                f"reason={self.reason!r}, target={self.target})")


def decide_scale(policy: ScalePolicy, *, replicas: int, signals: dict,
                 now_s: float, last_scale_s: float, out_streak: int,
                 in_streak: int):
    """The autoscaler's PURE decision core: no clocks, no processes,
    no registry — everything it consumes arrives as arguments, so
    scripted metric feeds can drive every verdict in a unit test.

    ``signals`` carries ``queue_depth`` (fleet-max queued queries) and
    optionally ``p99_ms`` / ``shed_rate``; ``out_streak``/``in_streak``
    are the caller-held hysteresis counters from the PREVIOUS call.
    Returns ``(verdict, out_streak, in_streak)`` — the caller feeds
    the streaks back in on the next tick, and resets
    ``last_scale_s`` itself when it actually acts on an out/in
    verdict."""
    q = float(signals.get("queue_depth", 0) or 0)
    p99 = signals.get("p99_ms")
    shed = signals.get("shed_rate")
    over_reason = None
    if q >= policy.queue_hi:
        over_reason = "queue"
    elif (policy.p99_hi_ms is not None and p99 is not None
            and float(p99) >= policy.p99_hi_ms):
        over_reason = "p99"
    elif (policy.shed_hi is not None and shed is not None
            and float(shed) >= policy.shed_hi):
        over_reason = "shed"
    under = q <= policy.queue_lo and over_reason is None
    if (under and policy.p99_lo_ms is not None and p99 is not None
            and float(p99) > policy.p99_lo_ms):
        under = False
    out_streak = out_streak + 1 if over_reason is not None else 0
    in_streak = in_streak + 1 if under else 0
    in_cooldown = (now_s - last_scale_s) < policy.cooldown_s
    if over_reason is not None and out_streak >= policy.settle_ticks:
        if replicas >= policy.max_replicas:
            return (Verdict("hold", "at_max", replicas),
                    out_streak, in_streak)
        if in_cooldown:
            return (Verdict("hold", "cooldown", replicas),
                    out_streak, in_streak)
        return Verdict("out", over_reason, replicas + 1), 0, 0
    if under and in_streak >= policy.settle_ticks:
        if replicas <= policy.min_replicas:
            return (Verdict("hold", "at_min", replicas),
                    out_streak, in_streak)
        if in_cooldown:
            return (Verdict("hold", "cooldown", replicas),
                    out_streak, in_streak)
        return Verdict("in", "idle", replicas - 1), 0, 0
    return Verdict("hold", "steady", replicas), out_streak, in_streak


@guarded_by("_lock", "_events", "_spawned", "_respawn_at", "_pods",
            "_out_streak", "_in_streak", "_last_scale_s", "_next_idx")
class Supervisor:
    """The fleet's self-healing control loop (module docstring).

    Parameters
    ----------
    router : the :class:`~bibfs_tpu_torch.fleet.router.Router` to supervise.
    spawn : ``spawn(index) -> replica`` factory for scale-out and
        wedge replacement. The replica must come up over the CURRENT
        durable content (the fast-spawn path: durable store seed +
        sidecar remap + policy prewarm); the supervisor ready-probes
        it before admission regardless.
    policy : :class:`ScalePolicy` (defaults above).
    poll_interval_s : control-loop cadence.
    signals : optional zero-arg callable returning the signal dict for
        :func:`decide_scale`; default collects from the replicas'
        ``load()``/``stats()``.
    obs_label : the ``router=`` label on the supervisor's metric
        families (default: the router's own label).
    """

    def __init__(self, router, spawn, *, policy: ScalePolicy | None = None,
                 poll_interval_s: float = 0.5, signals=None,
                 obs_label: str | None = None):
        self._router = router
        self._spawn = spawn
        self.policy = ScalePolicy() if policy is None else policy
        self.poll_interval_s = float(poll_interval_s)
        self._signals = signals if signals is not None else self._collect
        self._lock = threading.Lock()
        self._out_streak = 0
        self._in_streak = 0
        self._last_scale_s = float("-inf")
        self._next_idx = len(router.replica_names)
        self._spawned: list = []      # supervisor-spawned replica names
        self._respawn_at: dict = {}   # name/worker key -> last attempt
        self._pods: list = []         # (pod, respawn_cb)
        self._events: list = []       # scale-event timeline (stats())
        self._spawn_failures = 0
        self.obs_label = (
            obs_label if obs_label is not None
            else getattr(router, "obs_label", None)
            or next_instance_label("supervisor")
        )
        self._c_scale = REGISTRY.counter(
            "bibfs_fleet_scale_events_total",
            "Supervisor scale events (out/in/respawn/repair) by reason",
            ("router", "dir", "reason"),
        )
        for d, reason in SCALE_EVENT_KINDS:  # render at zero
            self._c_scale.labels(router=self.obs_label, dir=d,
                                 reason=reason)
        self._g_target = REGISTRY.gauge(
            "bibfs_fleet_replicas_target",
            "The supervisor's current replica target",
            ("router",),
        ).labels(router=self.obs_label)
        self._g_target.set(len(router.replica_names))
        self._stop = threading.Event()
        self._nudge = threading.Event()
        self._thread = threading.Thread(
            target=self._main, name="bibfs-fleet-supervisor",
            daemon=True,
        )
        self._thread.start()

    # ---- control loop -----------------------------------------------
    def _main(self) -> None:
        while True:
            self._nudge.wait(self.poll_interval_s)
            self._nudge.clear()
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception:
                pass  # one bad tick must not kill the loop

    def nudge(self) -> None:
        """Run a control-loop tick now (tests, operator REPL)."""
        self._nudge.set()

    def tick(self) -> None:
        """One full control-loop pass: respawn dead replicas, repair
        stuck catch-ups, heal watched pods, then autoscale. Public so
        tests (and the REPL) can drive the loop deterministically."""
        now = time.monotonic()
        self._respawn_dead(now)
        self._repair_stuck(now)
        self._heal_pods(now)
        self._autoscale(now)
        self._g_target.set(len(self._router.replica_names))

    # ---- dead-replica respawn ---------------------------------------
    def _respawn_dead(self, now: float) -> None:
        for name, state in self._router.table().items():
            if state != "dead":
                continue
            with self._lock:
                last = self._respawn_at.get(name, float("-inf"))
                if now - last < self.policy.respawn_backoff_s:
                    continue
                self._respawn_at[name] = now
            try:
                replica = self._router.replica(name)
            except KeyError:
                continue
            try:
                replica.restart()
            except Exception:
                continue
            # the restart's lifecycle hook already nudged the poller;
            # the router holds the respawn in `catchup` until it
            # declares the committed version
            self._event("respawn", "dead")

    # ---- catch-up escape hatch --------------------------------------
    def _repair_stuck(self, now: float) -> None:
        for name, stuck_s in self._router.catchup_stuck().items():
            if stuck_s < self.policy.stuck_after_s:
                continue
            with self._lock:
                key = f"repair:{name}"
                last = self._respawn_at.get(key, float("-inf"))
                if now - last < self.policy.respawn_backoff_s:
                    continue
                self._respawn_at[key] = now
            if self._replace_replica(name):
                self._event("repair", "catchup_stuck")

    def _replace_replica(self, name: str) -> bool:
        """Full respawn from the durable store: spawn a fresh replica
        (factory-seeded at the current committed content), warm it,
        admit it, and only then retire the wedged one — capacity never
        dips below the pre-repair count."""
        replacement = self._spawn_one()
        if replacement is None:
            return False
        try:
            self._router.add_replica(replacement)
        except Exception:
            self._close_quiet(replacement)
            return False
        self._router.remove_replica(name, close=True)
        with self._lock:
            if name in self._spawned:
                self._spawned.remove(name)
            self._spawned.append(replacement.name)
        return True

    # ---- pod-worker failure domains ---------------------------------
    def watch_pod(self, pod, respawn) -> None:
        """Register a pod primary for heartbeat supervision (duck-typed:
        only ``check_heartbeats()`` and ``dead_workers()`` are called).
        ``respawn(pod, pidx)`` must start a replacement worker at a
        HIGHER epoch and drive ``pod.accept_rejoin`` — the supervisor
        only decides when."""
        with self._lock:
            self._pods.append((pod, respawn))

    def _heal_pods(self, now: float) -> None:
        with self._lock:
            pods = list(self._pods)
        for pod, respawn in pods:
            try:
                pod.check_heartbeats()
            except Exception:
                pass
            try:
                dead = dict(pod.dead_workers())
            except Exception:
                continue
            for pidx in dead:
                with self._lock:
                    key = f"pod:{id(pod)}:{pidx}"
                    last = self._respawn_at.get(key, float("-inf"))
                    if now - last < self.policy.respawn_backoff_s:
                        continue
                    self._respawn_at[key] = now
                try:
                    respawn(pod, pidx)
                except Exception:
                    continue
                self._event("respawn", "pod_worker")

    # ---- autoscaling ------------------------------------------------
    def _autoscale(self, now: float) -> None:
        signals = self._signals()
        replicas = len(self._router.replica_names)
        with self._lock:
            out_streak = self._out_streak
            in_streak = self._in_streak
            last_scale = self._last_scale_s
        verdict, out_streak, in_streak = decide_scale(
            self.policy, replicas=replicas, signals=signals,
            now_s=now, last_scale_s=last_scale,
            out_streak=out_streak, in_streak=in_streak,
        )
        with self._lock:
            self._out_streak = out_streak
            self._in_streak = in_streak
        acted = False
        if verdict.action == "out":
            acted = self._scale_out(verdict.reason)
        elif verdict.action == "in":
            acted = self._scale_in(verdict.reason)
        if acted:
            with self._lock:
                # cooldown runs from when the scale event COMPLETED,
                # not from the tick's start: spawn+warm takes seconds,
                # and stamping the decision time would let the next
                # opposite verdict fire inside the flap window
                self._last_scale_s = time.monotonic()

    def _spawn_one(self):
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        try:
            replica = self._spawn(idx)
        except Exception:
            self._spawn_failures += 1
            return None
        if not self._warm(replica):
            self._spawn_failures += 1
            self._close_quiet(replica)
            return None
        return replica

    def _scale_out(self, reason: str) -> bool:
        replica = self._spawn_one()
        if replica is None:
            return False
        try:
            self._router.add_replica(replica)
        except Exception:
            self._close_quiet(replica)
            return False
        with self._lock:
            self._spawned.append(replica.name)
        self._event("out", reason)
        return True

    def _scale_in(self, reason: str) -> bool:
        victim = self._pick_victim()
        if victim is None:
            return False
        try:
            replica = self._router.replica(victim)
        except KeyError:
            return False
        # drain first: queued tickets resolve, new submits fail over
        # to the survivors — zero acked tickets lost to a scale-in
        try:
            replica.begin_drain()
            replica.flush(timeout=30.0)
        except Exception:
            pass
        try:
            self._router.remove_replica(victim, close=True)
        except ValueError:
            try:
                replica.end_drain()
            except Exception:
                pass
            return False
        with self._lock:
            if victim in self._spawned:
                self._spawned.remove(victim)
        self._event("in", reason)
        return True

    def _pick_victim(self):
        """Retire the most recently supervisor-spawned replica that is
        still routed — never a replica the operator built the fleet
        with, so scale-in can only unwind the supervisor's own
        scale-outs."""
        names = set(self._router.replica_names)
        with self._lock:
            for name in reversed(self._spawned):
                if name in names:
                    return name
        return None

    def _warm(self, replica) -> bool:
        """Ready-probe a freshly spawned replica end-to-end BEFORE it
        is admitted — one trivial query through the submit seam plus a
        ready health read, retried up to ``warm_timeout_s``."""
        deadline = time.monotonic() + self.policy.warm_timeout_s
        while time.monotonic() < deadline:
            try:
                if replica.probe(timeout=5.0):
                    if replica.health()["state"] == "ready":
                        return True
            except Exception:
                pass
            time.sleep(0.05)
        return False

    @staticmethod
    def _close_quiet(replica) -> None:
        try:
            replica.close()
        except Exception:
            pass

    # ---- bookkeeping ------------------------------------------------
    def _event(self, d: str, reason: str) -> None:
        self._c_scale.labels(
            router=self.obs_label, dir=d, reason=reason
        ).inc()
        row = {
            "t": round(time.monotonic(), 3),
            "dir": d,
            "reason": reason,
            "replicas": len(self._router.replica_names),
        }
        with self._lock:
            self._events.append(row)

    def events(self) -> list:
        """The scale-event timeline (copies) — the soak's flap gate."""
        with self._lock:
            return [dict(e) for e in self._events]

    def stats(self) -> dict:
        with self._lock:
            events = [dict(e) for e in self._events]
            spawned = list(self._spawned)
            out_streak = self._out_streak
            in_streak = self._in_streak
        return {
            "replicas": self._router.replica_names,
            "target": len(self._router.replica_names),
            "spawned": spawned,
            "events": events,
            "out_streak": out_streak,
            "in_streak": in_streak,
            "spawn_failures": self._spawn_failures,
            "poll_interval_s": self.poll_interval_s,
        }

    # ---- default signal collector -----------------------------------
    def _collect(self) -> dict:
        """Fleet-max signals from the replicas' own serving telemetry:
        queue depth via ``load()`` always; latency p99 via ``stats()``
        only when a p99 threshold is configured (it is an RPC on
        out-of-process replicas)."""
        depth = 0
        p99 = None
        want_p99 = (self.policy.p99_hi_ms is not None
                    or self.policy.p99_lo_ms is not None)
        for name in self._router.replica_names:
            try:
                replica = self._router.replica(name)
            except KeyError:
                continue
            try:
                load = int(replica.load())
            except Exception:
                continue
            if load < (1 << 29):  # dead replicas read as saturated
                depth = max(depth, load)
            if want_p99:
                try:
                    lat = replica.stats().get("latency_ms") or {}
                    v = lat.get("p99_ms")
                    if v is not None:
                        p99 = max(p99 or 0.0, float(v))
                except Exception:
                    pass
        return {"queue_depth": depth, "p99_ms": p99, "shed_rate": None}

    # ---- lifecycle --------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        self._nudge.set()
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
