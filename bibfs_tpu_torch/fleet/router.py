"""Health-aware front-end router over N engine replicas: the counterpart
of ``bibfs_tpu/fleet/router.py``.

The horizontal serving story: one router owns a fleet
of replicas (:mod:`bibfs_tpu_torch.fleet.replica`) and gives callers the
engine-shaped surface — ``submit``/``query``/``query_many`` — while
underneath:

- **consistent-hash routing with spill.** Each query routes by a
  consistent hash of its graph name (``vnodes`` virtual nodes per
  replica on a 64-bit ring), so a graph's traffic sticks to one
  replica — which is what makes per-replica distance caches, oracle
  indexes and compiled-program warmth ACCUMULATE instead of being
  diluted fleet-wide: aggregate cache capacity scales with the replica
  count, the measured reason a fleet beats one replica on repeat-heavy
  multi-graph traffic (``serve/loadgen.py::run_fleet``). A hot graph
  spills: when
  the hash owner's queue depth reaches ``spill_after``, the query goes
  to the least-loaded healthy replica instead
  (``bibfs_fleet_spills_total``).
- **health-driven routing table.** A poller thread polls every
  replica's ``health_snapshot()`` / ``health`` command each
  ``poll_interval_s``: ready replicas route, degraded replicas are
  demoted (used only when nothing is ready), draining/dead/live ones
  are ejected, and recovery re-admits automatically
  (``bibfs_fleet_replicas{state}``). A submit that hits a dead replica
  marks it dead immediately — ejection does not wait for the poll.
- **failure re-routing.** A replica failure — submit refused, ticket
  failed with a server-side :class:`QueryError` (``internal`` /
  ``capacity``), process death — re-routes the query to a peer with
  the resilience layer's retry/backoff taxonomy (:class:`RetryPolicy` bounds
  attempts; ``bibfs_fleet_reroutes_total`` counts failovers), so one
  dead replica costs retries, not lost tickets. Client-invalid errors
  never re-route.
- **rolling swaps.** :meth:`Router.rolling_swap` rolls an edge-update
  batch across the fleet one replica at a time: demote -> engine-level
  drain (submits answer structured capacity refusals while queued
  tickets resolve) -> flush -> ``store.roll`` (apply + compact + atomic
  hot-swap on THAT replica's store) -> ready-probe -> re-admit. The
  fleet serves mixed versions mid-roll; every answer is exact for the
  version its replica declares, which each
  :class:`FleetTicket.declared_version` records.
- **catch-up re-admission.** A completed roll records the fleet's
  COMMITTED version per graph (plus a bounded roll history). A replica
  coming back from ``dead`` whose declared version lags a committed one
  is held in the ``catchup`` table state — not routable — until it
  catches up: the router replays the missed roll batches from its
  history (contiguously, version by version) onto the recovering
  replica's store, then re-reads the declared version and only then
  admits. A durable replica (``store/wal``) usually recovers to the
  committed version from its own WAL and passes straight through; a
  replica that lost state (or missed a roll while dead) is repaired
  rather than silently re-admitted at a stale version (a respawned
  subprocess serving v1 answers for a fleet that had rolled to v2). A replica too far behind the retained
  history stays in ``catchup``, visibly, instead of serving stale data
  (``bibfs_fleet_catchups_total`` counts completed catch-ups).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time

from bibfs_tpu_torch.utils.annotations import guarded_by
from bibfs_tpu_torch.fleet.replica import ReplicaDead
from bibfs_tpu_torch.obs.dtrace import FLIGHT, dspan, sample_ctx
from bibfs_tpu_torch.obs.metrics import REGISTRY, next_instance_label
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.serve.resilience import (
    QueryError,
    RetryPolicy,
    to_query_error,
)

#: routing-table states a query may be sent to (in preference order)
ROUTABLE_STATES = ("ready", "degraded")
#: every state the table (and the bibfs_fleet_replicas gauge) can hold
#: — ``catchup`` holds a recovering replica whose declared graph
#: version lags the fleet's committed one (module docstring)
TABLE_STATES = ("live", "ready", "degraded", "draining", "dead",
                "catchup")

#: rolls retained per graph for catch-up replay; a replica further
#: behind than this stays in ``catchup`` (visibly) instead of being
#: re-admitted stale
ROLL_HISTORY_MAX = 8

#: error kinds that re-route to a peer; everything else is the
#: client's problem (invalid) or the caller's deadline (timeout)
REROUTE_KINDS = ("internal", "capacity")

# the fleet metric families a router mints —
# re-exported from the ONE canonical list (obs/names.py) that the soak's
# live-render gate and the parity tests share, so they cannot drift
# apart; bibfs_build_info rides along
# because "which build is this replica" is the fleet question
from bibfs_tpu_torch.obs.names import FLEET_METRIC_FAMILIES  # noqa: E402,F401


def _hash64(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big"
    )


class FleetTicket:
    """A routed query's handle: wraps the serving replica's ticket and
    re-routes on replica failure when waited/polled (failover is driven
    by the waiter — the router never parks threads per ticket).
    ``replica`` / ``declared_version`` name the replica that finally
    answered and the graph version it declared at dispatch, which is
    what makes mid-rolling-swap answers verifiable."""

    __slots__ = ("src", "dst", "graph", "replica", "declared_version",
                 "attempts", "tried", "result", "error", "_router",
                 "_inner", "ctx")

    def __init__(self, router, src: int, dst: int, graph: str | None,
                 ctx=None):
        self.src = src
        self.dst = dst
        self.graph = graph
        self.replica: str | None = None
        self.declared_version = None
        self.attempts = 0
        self.tried: set = set()
        self.result = None
        self.error: BaseException | None = None
        self._router = router
        self._inner = None
        self.ctx = ctx  # sampled trace context (None = unsampled)

    def done(self) -> bool:
        return self.result is not None or self.error is not None

    def poll(self) -> bool:
        """Non-blocking progress check: True once the ticket is FINAL
        (result or terminal error). A failed inner ticket triggers the
        re-route right here (non-blocking dispatch, no backoff sleep) —
        how a streaming caller (the ``bibfs-torch-fleet`` REPL) drives
        failover without parking a thread."""
        while True:
            if self.done():
                return True
            inner = self._inner
            if inner is None:
                return False
            if inner.error is not None:
                if not self._router._reroute(self, inner.error,
                                             blocking=False):
                    return True
                continue
            if inner.result is not None:
                self.result = inner.result
                return True
            return False

    def wait(self, timeout: float | None = 60.0):
        """Block for the result, re-routing on replica failure (with
        the retry policy's backoff) until the attempts bound; raises
        the final structured error or ``TimeoutError``."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        while True:
            if self.result is not None:
                return self.result
            if self.error is not None:
                raise self.error
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"query ({self.src}, {self.dst}) unresolved "
                        f"after {timeout}s (replica {self.replica})"
                    )
            replica = self._router._replicas.get(self.replica)
            if replica is None:  # retired mid-flight (scale-in)
                if not self._router._reroute(
                        self,
                        ReplicaDead(f"replica {self.replica} retired"),
                        blocking=True):
                    raise self.error
                continue
            try:
                self.result = replica.wait_ticket(
                    self._inner, timeout=remaining
                )
                return self.result
            except TimeoutError:
                raise
            except (QueryError, ReplicaDead, RuntimeError) as e:
                if not self._router._reroute(self, e, blocking=True):
                    raise self.error


# the routing table and every catch-up/version structure the poller,
# the dispatch path and rolling_swap share; reads stay lock-free by
# design (_pick's GIL-atomic table read is the hot path)
@guarded_by("_table_lock", "_states", "_versions", "_committed",
            "_roll_history", "_needs_catchup", "_forced_drain",
            "_last_gen", "_catchup_since")
class Router:
    """Front-end router over N replicas (module docstring).

    Parameters
    ----------
    replicas : the fleet — :class:`EngineReplica` /
        :class:`ProcessReplica` (or anything replica-shaped). Names
        must be unique.
    retry : failover policy (default: 3 attempts, exp backoff +
        jitter) — ``attempts`` bounds how many replicas one query may
        try in total.
    poll_interval_s : health-poll cadence (the re-admit latency floor).
    spill_after : hash-owner queue depth at which a query spills to the
        least-loaded healthy replica (0/None disables spilling). Set it
        ABOVE the replicas' routine flush depth (a multiple of their
        ``max_batch``): a queue that merely filled to its next batch is
        the micro-batcher working, not pressure — spilling on it
        scatters hot-graph traffic and destroys exactly the cache
        affinity hash routing exists to build (measured: a threshold at
        half the flush depth spilled ~40% of a steady hot-traffic pass
        and halved the fleet's hit rate).
    vnodes : virtual nodes per replica on the hash ring.
    obs_label : the ``router=`` label on the fleet metric families
        (default: a process-unique ``router-N``).
    """

    def __init__(self, replicas, *, retry: RetryPolicy | None = None,
                 poll_interval_s: float = 0.25, spill_after: int = 256,
                 vnodes: int = 64, obs_label: str | None = None):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("a router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        self._replicas = {r.name: r for r in replicas}
        self._order = sorted(self._replicas)
        self._retry = RetryPolicy(attempts=3) if retry is None else retry
        self.poll_interval_s = float(poll_interval_s)
        self.spill_after = int(spill_after or 0)
        self._vnodes = int(vnodes)
        ring = []
        for name in self._order:
            for i in range(self._vnodes):
                ring.append((_hash64(f"{name}#{i}"), name))
        ring.sort()
        self._ring = ring
        self._ring_keys = [h for h, _ in ring]
        self._table_lock = threading.Lock()
        self._states = {name: "live" for name in self._order}
        self._forced_drain: dict[str, bool] = {}
        self._versions: dict = {}
        # catch-up state (module docstring): fleet-committed version +
        # bounded roll history per graph, and the replicas whose next
        # ready transition must be version-checked (set on death)
        self._committed: dict[str, int] = {}
        self._roll_history: dict[str, list] = {}
        self._needs_catchup: set = set()
        # last seen incarnation per replica: a generation change means
        # the replica died and came back BETWEEN polls (a respawn
        # faster than one tick) — the catch-up check must still run
        self._last_gen: dict[str, int] = {
            name: getattr(r, "generation", 0)
            for name, r in self._replicas.items()
        }
        # when each replica ENTERED the catchup table state (monotonic)
        # — the stuck-duration source for the bibfs_fleet_catchup_stuck
        # gauge, stats()["pending_catchup"] and health_snapshot()
        self._catchup_since: dict[str, float] = {}
        self.obs_label = (
            next_instance_label("router") if obs_label is None
            else obs_label
        )
        self._g_replicas = REGISTRY.gauge(
            "bibfs_fleet_replicas",
            "Fleet replicas by routing-table state",
            ("router", "state"),
        )
        for s in TABLE_STATES:  # render at zero from the first scrape
            self._g_replicas.labels(router=self.obs_label, state=s).set(0)
        # the family handle outlives the ctor: add_replica mints a cell
        # for every replica that joins after construction
        self._c_routed_family = REGISTRY.counter(
            "bibfs_fleet_routed_total",
            "Queries dispatched per replica",
            ("router", "replica"),
        )
        self._routed_cells = {
            name: self._c_routed_family.labels(
                router=self.obs_label, replica=name
            )
            for name in self._order
        }
        self._g_catchup_stuck = REGISTRY.gauge(
            "bibfs_fleet_catchup_stuck",
            "Seconds a replica has been held in the catchup table "
            "state (0 = not stuck)",
            ("router", "replica"),
        )
        for name in self._order:  # render at zero from the first scrape
            self._g_catchup_stuck.labels(
                router=self.obs_label, replica=name
            ).set(0)
        self._c_reroutes = REGISTRY.counter(
            "bibfs_fleet_reroutes_total",
            "Queries re-routed off a failed/refusing replica",
            ("router",),
        ).labels(router=self.obs_label)
        self._c_spills = REGISTRY.counter(
            "bibfs_fleet_spills_total",
            "Hot-graph queries spilled to the least-loaded replica",
            ("router",),
        ).labels(router=self.obs_label)
        self._c_rolls = REGISTRY.counter(
            "bibfs_fleet_rolls_total",
            "Fleet-wide rolling swaps completed",
            ("router",),
        ).labels(router=self.obs_label)
        self._c_catchups = REGISTRY.counter(
            "bibfs_fleet_catchups_total",
            "Recovering replicas caught up to the fleet's committed "
            "version before re-admission (roll-history replays "
            "included)",
            ("router",),
        ).labels(router=self.obs_label)
        self._closed = False
        self._poll_stop = threading.Event()
        # set by nudge_poll() (replica kill/restart hooks, supervisor
        # scale events) to cut the re-admit latency floor from
        # poll_interval_s to one immediate tick
        self._poll_nudge = threading.Event()
        for r in self._replicas.values():
            self._subscribe_lifecycle(r)
        self._poll_once()  # routing works before the first poller tick
        self._poller = threading.Thread(
            target=self._poll_main, name="bibfs-fleet-poller",
            daemon=True,
        )
        self._poller.start()

    def _subscribe_lifecycle(self, replica) -> None:
        """Wire a replica's kill/restart notifications to an immediate
        poll tick (the re-admit latency cut): duck-typed, so anything
        replica-shaped without the hook still routes."""
        hook = getattr(replica, "on_lifecycle", None)
        if hook is not None:
            hook(lambda _name, _event: self.nudge_poll())

    # ---- submission --------------------------------------------------
    def replica(self, name: str):
        return self._replicas[name]

    @property
    def replica_names(self) -> list:
        return list(self._order)

    # ---- elastic membership -----------------------------------------
    def _ring_of_locked(self, order) -> list:
        ring = []
        for name in order:
            for i in range(self._vnodes):
                ring.append((_hash64(f"{name}#{i}"), name))
        ring.sort()
        return ring

    def add_replica(self, replica) -> None:
        """Admit one replica into the fleet at runtime (supervisor
        scale-out). It enters the table as ``live`` (not routable) and
        is admitted by the nudged poll tick once its health reads
        ready; a fleet with committed rolls on record version-checks
        it through the catch-up gate like any recovering replica.
        Hot-path readers stay lock-free: the replica dict, order, ring
        and key list are REPLACED wholesale (GIL-atomic reference
        assignments), never mutated in place."""
        name = replica.name
        # mint the per-replica cells BEFORE the replica becomes
        # pickable: a dispatch racing the admitting poll tick must
        # find its routed cell in place
        self._routed_cells[name] = self._c_routed_family.labels(
            router=self.obs_label, replica=name
        )
        self._g_catchup_stuck.labels(
            router=self.obs_label, replica=name
        ).set(0)
        with self._table_lock:
            if name in self._replicas:
                raise ValueError(f"replica name already routed: {name!r}")
            replicas = dict(self._replicas)
            replicas[name] = replica
            order = sorted(replicas)
            ring = self._ring_of_locked(order)
            self._states[name] = "live"
            self._last_gen[name] = getattr(replica, "generation", 0)
            if self._committed:
                # never admit a late joiner at a stale version: it
                # passes the same version gate a recovering replica does
                self._needs_catchup.add(name)
            self._replicas = replicas
            self._order = order
            self._ring = ring
            self._ring_keys = [h for h, _ in ring]
        self._subscribe_lifecycle(replica)
        self.nudge_poll()

    def remove_replica(self, name: str, *, close: bool = True) -> None:
        """Retire one replica at runtime (supervisor scale-in or
        stuck-catchup replacement). The caller is expected to have
        drained it (``begin_drain`` + ``flush``) so no acked ticket is
        lost; anything still in flight fails over through the normal
        reroute path. A router keeps at least one replica."""
        with self._table_lock:
            if name not in self._replicas:
                return
            if len(self._replicas) == 1:
                raise ValueError("a router needs at least one replica")
            replicas = dict(self._replicas)
            replica = replicas.pop(name)
            order = sorted(replicas)
            ring = self._ring_of_locked(order)
            self._replicas = replicas
            self._order = order
            self._ring = ring
            self._ring_keys = [h for h, _ in ring]
            self._states.pop(name, None)
            self._forced_drain.pop(name, None)
            self._needs_catchup.discard(name)
            self._catchup_since.pop(name, None)
            self._last_gen.pop(name, None)
            self._drop_versions_locked(name)
        self._routed_cells.pop(name, None)
        self._g_catchup_stuck.labels(
            router=self.obs_label, replica=name
        ).set(0)
        if close:
            try:
                replica.close()
            except Exception:
                pass
        self.nudge_poll()

    def submit(self, src: int, dst: int, graph: str | None = None,
               ctx=None) -> FleetTicket:
        """Route one query (hash + health + spill) and return its
        :class:`FleetTicket`. Submit-time replica refusals fail over
        immediately; client-invalid input raises ``ValueError`` to the
        caller unrerouted. The router is a trace ingress: with no
        upstream ``ctx``, the sampler may mint one here, and the
        context then rides the replica's wire protocol (stdin token /
        net frame fields) into the serving process."""
        if ctx is None:
            ctx = sample_ctx()
        ticket = FleetTicket(self, int(src), int(dst), graph, ctx)
        self._dispatch(ticket)
        return ticket

    def query(self, src: int, dst: int, graph: str | None = None):
        return self.submit(src, dst, graph).wait()

    def query_many(self, pairs, *, graph: str | None = None,
                   return_errors: bool = False) -> list:
        """Fleet-wide ``query_many``: same contract as the engines'
        (``return_errors=True`` yields per-pair
        ``BFSResult | QueryError``)."""
        tickets: list = []
        for s, d in pairs:
            try:
                tickets.append(self.submit(int(s), int(d), graph))
            except (ValueError, TypeError) as e:
                if not return_errors:
                    raise
                tickets.append(to_query_error(e, None, kind="invalid"))
            except QueryError as e:
                if not return_errors:
                    raise
                tickets.append(e)
        self.flush()
        out = []
        for t in tickets:
            if isinstance(t, QueryError):
                out.append(t)
                continue
            try:
                out.append(t.wait(timeout=120.0))
            except Exception as e:
                if not return_errors:
                    raise
                out.append(to_query_error(e, (t.src, t.dst)))
        return out

    def flush(self, timeout: float | None = None) -> None:
        """Resolve everything queued on every live replica."""
        for name in self._order:
            try:
                self._replicas[name].flush(timeout=timeout)
            except Exception:
                pass  # a dead replica's tickets fail; wait() reroutes

    def _dispatch(self, ticket: FleetTicket,
                  exclude: set | None = None,
                  is_reroute: bool = False) -> None:
        tried = set(exclude or ())
        last_err = None
        for _ in range(len(self._replicas) + 1):
            name = self._pick(ticket.graph, tried)
            replica = self._replicas.get(name)
            if replica is None:  # retired between table read and here
                tried.add(name)
                continue
            # version BEFORE submit: a rolling swap that lands while
            # this query sits in the replica's queue still resolves it
            # PRE-swap (the roll's drain flushes the queue before the
            # store rolls), so the pre-submit version is the one the
            # answer is exact for — reading after the submit could
            # attribute a v_k answer to v_k+1
            version = self._version_of(name, ticket.graph)
            try:
                if ticket.ctx is not None:
                    sp = dspan("route", ticket.ctx, replica=name,
                               reroute=is_reroute)
                    with sp:
                        inner = replica.submit(ticket.src, ticket.dst,
                                               ticket.graph, ctx=sp.ctx)
                    FLIGHT.note(
                        "route", trace=ticket.ctx.trace_id,
                        replica=name, reroute=is_reroute,
                        version=version,
                    )
                else:
                    inner = replica.submit(ticket.src, ticket.dst,
                                           ticket.graph)
            except (ValueError, TypeError):
                raise  # client-invalid: the caller's problem, no peer
                # can answer an out-of-range id differently
            except QueryError as e:
                last_err = e
                tried.add(name)
                self._c_reroutes.inc()
                continue  # draining/refusing: straight to a peer
            except Exception as e:  # ReplicaDead, closed-engine races
                last_err = e
                tried.add(name)
                self._mark_dead(name)  # eject ahead of the next poll
                self._c_reroutes.inc()
                continue
            if is_reroute:
                self._c_reroutes.inc()
            ticket._inner = inner
            ticket.replica = name
            ticket.attempts += 1
            ticket.tried.add(name)
            ticket.declared_version = version
            cell = self._routed_cells.get(name)
            if cell is not None:
                cell.inc()
            return
        raise QueryError(
            "no healthy replica accepted the query",
            kind="capacity", query=(ticket.src, ticket.dst),
            cause=last_err,
        )

    def _reroute(self, ticket: FleetTicket, err: BaseException,
                 blocking: bool) -> bool:
        """Failover one failed ticket to a peer. True = re-dispatched
        (caller keeps waiting/polling); False = terminal
        (``ticket.error`` set)."""
        kind = getattr(err, "kind", "internal")
        retryable = (
            isinstance(err, (ReplicaDead, RuntimeError))
            and not isinstance(err, QueryError)
        ) or kind in REROUTE_KINDS
        if not retryable or ticket.attempts >= self._retry.attempts:
            ticket.error = to_query_error(
                err, (ticket.src, ticket.dst)
            )
            return False
        if blocking:
            time.sleep(self._retry.delay_s(max(ticket.attempts - 1, 0)))
        try:
            with span("fleet_reroute", replica=ticket.replica):
                self._dispatch(
                    ticket, exclude=set(ticket.tried), is_reroute=True
                )
        except (QueryError, ValueError, TypeError) as e:
            ticket.error = to_query_error(e, (ticket.src, ticket.dst))
            return False
        return True

    # ---- routing policy ---------------------------------------------
    def owner(self, graph: str | None) -> str:
        """The graph's hash-ring owner over ALL replicas (health
        ignored) — the affinity introspection hook load generators shard
        by."""
        return self._ring_walk(str(graph or ""), set(self._order))

    def _ring_walk(self, key: str, avail: set) -> str:
        h = _hash64(key)
        i = bisect.bisect_right(self._ring_keys, h)
        for k in range(len(self._ring)):
            name = self._ring[(i + k) % len(self._ring)][1]
            if name in avail:
                return name
        return next(iter(avail))

    def _pick(self, graph: str | None, exclude: set) -> str:
        # hot path: plain dict reads are GIL-atomic and the poller only
        # assigns whole values — a lock here would put one more convoy
        # point on every routed query (the fleet's hit traffic is pure
        # Python, where lock handoffs ARE the cost)
        states = self._states
        for want in ROUTABLE_STATES:
            eligible = {n for n in self._order if states.get(n) == want}
            if eligible:
                break
        else:
            raise QueryError(
                f"no healthy replicas (table: {dict(states)})",
                kind="capacity",
            )
        avail = eligible - exclude or eligible
        target = self._ring_walk(str(graph or ""), avail)
        if self.spill_after and len(avail) > 1:
            tload = self._load_of(target)
            if tload >= self.spill_after:
                alt = min(avail, key=self._load_of)
                if alt != target and self._load_of(alt) < tload:
                    self._c_spills.inc()
                    return alt
        return target

    def _load_of(self, name: str) -> int:
        """A replica's queue depth for spill/scale decisions; a replica
        retired (or dying) mid-read reads as saturated."""
        replica = self._replicas.get(name)
        if replica is None:
            return 1 << 30
        try:
            return replica.load()
        except Exception:
            return 1 << 30

    def _graph_key(self, graph: str | None) -> str:
        return str(graph or "")

    def _version_of(self, name: str, graph: str | None):
        key = (name, self._graph_key(graph))
        v = self._versions.get(key)  # GIL-atomic read; the miss path
        # (first query per (replica, graph)) and rolling_swap write
        # under the table lock
        if v is not None:
            return v
        try:
            v = self._replicas[name].version(graph)
        except Exception:
            v = None
        with self._table_lock:
            self._versions[key] = v
        return v

    # ---- health table ------------------------------------------------
    def _mark_dead(self, name: str) -> None:
        with self._table_lock:
            self._states[name] = "dead"
            self._drop_versions_locked(name)
            self._needs_catchup.add(name)

    def _drop_versions_locked(self, name: str) -> None:
        """Forget a dead replica's cached declared versions: a restart
        may come back on different state (a subprocess respawn reloads
        its store from disk, losing in-memory rolls), and a stale cache
        would mis-attribute its answers. The next dispatch re-reads the
        version from the replica itself."""
        for key in [k for k in self._versions if k[0] == name]:
            del self._versions[key]

    def _set_state(self, name: str, state: str) -> None:
        with self._table_lock:
            self._states[name] = state

    def _poll_once(self) -> None:
        counts = {s: 0 for s in TABLE_STATES}
        # snapshot: membership may change under the supervisor mid-poll
        for name, replica in list(self._replicas.items()):
            try:
                state = replica.health()["state"]
                if state not in counts:
                    state = "degraded"
            except Exception:
                state = "dead"
            gen = getattr(replica, "generation", 0)
            with self._table_lock:
                if self._forced_drain.get(name):
                    state = "draining"  # mid-roll: keep traffic off
                if (state == "dead"
                        and self._states.get(name) != "dead"):
                    self._drop_versions_locked(name)
                    self._needs_catchup.add(name)
                if gen != self._last_gen.get(name):
                    # died and respawned between polls: same treatment
                    # as an observed death
                    self._last_gen[name] = gen
                    self._drop_versions_locked(name)
                    self._needs_catchup.add(name)
                check_catchup = (
                    state in ROUTABLE_STATES
                    and name in self._needs_catchup
                    and bool(self._committed)
                )
                if not check_catchup and state in ROUTABLE_STATES:
                    self._needs_catchup.discard(name)
            if check_catchup:
                # a replica coming back from dead with fleet-committed
                # versions on record: verify (and repair) its declared
                # versions BEFORE it becomes routable — gating EVERY
                # routable state (a recovering replica polled straight
                # into 'degraded' is still dispatchable and must not
                # bypass the version check)
                if not self._try_catchup(name):
                    state = "catchup"
            now = time.monotonic()
            with self._table_lock:
                if name not in self._replicas:
                    continue  # retired while we were polling it
                self._states[name] = state
                if state == "catchup":
                    since = self._catchup_since.setdefault(name, now)
                    stuck = now - since
                else:
                    self._catchup_since.pop(name, None)
                    stuck = 0.0
            self._g_catchup_stuck.labels(
                router=self.obs_label, replica=name
            ).set(round(stuck, 3))
            counts[state] += 1
        for s, c in counts.items():
            self._g_replicas.labels(
                router=self.obs_label, state=s
            ).set(c)

    def _try_catchup(self, name: str) -> bool:
        """Version-check (and repair) one recovering replica against
        every fleet-committed graph version. Returns True once every
        committed graph's declared version has caught up (the caller
        admits the replica under its polled state); False holds it in
        ``catchup`` (not routable). Lagging graphs are repaired by
        replaying the missed roll
        batches from the bounded history, in version order — a gap
        beyond the history leaves the replica in ``catchup`` visibly
        rather than re-admitting stale answers.

        The comparison is numeric, which is sound exactly because
        fleet-managed graphs mutate ONLY through rolls: every replica's
        store moves v -> v+1 per committed roll and nothing else bumps
        versions (fleet updates are staged and land with the roll, so
        no overlay accumulates to trigger an independent background
        compaction). Mutating a fleet replica's store out-of-band
        breaks that comparability — a locally-compacted replica could
        pass the check while missing a roll's content.

        A replica that crashed BETWEEN a roll's update acks and its
        swap respawns with the batch re-armed in its overlay: the
        replay's duplicate adds are refused and the replica stays held
        here. That is the deliberate trade — safe-but-unroutable
        (visible in ``stats()["pending_catchup"]``, repaired by an
        operator restart from clean state) over any automatic fold of
        partially-recovered pending state, which could re-admit a
        replica whose declared version matches the fleet while its
        content does not."""
        replica = self._replicas.get(name)
        if replica is None:  # retired mid-poll
            return False
        with self._table_lock:
            committed = dict(self._committed)
            history = {g: list(h) for g, h in self._roll_history.items()}
        for gkey, want in committed.items():
            graph = gkey or None
            try:
                have = replica.version(graph)
            except Exception:
                return False
            have = 0 if have is None else int(have)
            if have >= want:
                continue
            with span("fleet_catchup", replica=name, graph=gkey,
                      have=have, want=want):
                for ver, adds, dels in history.get(gkey, ()):
                    if ver <= have:
                        continue
                    if ver != have + 1:
                        # history gap: the batches that would bridge it
                        # were pruned — repairing from here would skip
                        # acked updates, so hold the replica instead
                        return False
                    try:
                        have = int(replica.roll(graph, adds=adds,
                                                dels=dels))
                    except Exception:
                        return False
                if have < want:
                    return False
        with self._table_lock:
            self._needs_catchup.discard(name)
        # the version cache was dropped at death; the next dispatch
        # re-reads the (now caught-up) declared version from the replica
        self._c_catchups.inc()
        return True

    def _poll_main(self) -> None:
        # the nudge event doubles as the tick timer: a kill/restart/
        # scale event wakes the poller NOW instead of waiting out
        # poll_interval_s (the documented re-admit latency floor)
        while True:
            self._poll_nudge.wait(self.poll_interval_s)
            self._poll_nudge.clear()
            if self._poll_stop.is_set():
                return
            try:
                self._poll_once()
            except Exception:
                pass  # a poll hiccup must not kill the poller

    def nudge_poll(self) -> None:
        """Wake the health poller immediately (replica lifecycle events,
        supervisor respawns) — an event, not a tighter interval, so the
        steady-state poll cost is unchanged."""
        self._poll_nudge.set()

    # ---- rolling swap ------------------------------------------------
    def rolling_swap(self, graph: str | None = None, adds=(), dels=(),
                     *, drain_timeout_s: float = 60.0,
                     ready_timeout_s: float = 30.0) -> dict:
        """Roll one edge-update batch across the fleet, one replica at
        a time (module docstring): demote -> drain -> flush ->
        ``replica.roll`` (apply + compact + hot-swap on that replica's
        store) -> ready-probe -> re-admit. Returns the per-replica
        rows; ``ok`` requires every replica rolled and re-probed."""
        adds = [tuple(e) for e in adds]
        dels = [tuple(e) for e in dels]
        rows = []
        for name in list(self._order):
            replica = self._replicas.get(name)
            if replica is None:  # retired mid-roll
                continue
            row = {"replica": name, "ok": False}
            with span("fleet_roll", replica=name,
                      graph=self._graph_key(graph)):
                with self._table_lock:
                    self._forced_drain[name] = True
                    self._states[name] = "draining"
                t0 = time.perf_counter()
                try:
                    row["engine_drain"] = bool(replica.begin_drain())
                    replica.flush(timeout=drain_timeout_s)
                    old_v = replica.version(graph)
                    new_v = replica.roll(graph, adds=adds, dels=dels)
                    replica.end_drain()
                    ready = self._probe_ready(
                        replica, graph, timeout=ready_timeout_s
                    )
                    row.update(
                        version=[old_v, new_v], ready=ready,
                        ok=bool(ready and (
                            not (adds or dels)
                            or (old_v is not None and new_v > old_v)
                        )),
                    )
                    with self._table_lock:
                        self._versions[
                            (name, self._graph_key(graph))
                        ] = new_v
                except Exception as e:
                    row["error"] = f"{type(e).__name__}: {e}"[:300]
                    try:
                        replica.end_drain()
                    except Exception:
                        pass
                finally:
                    row["roll_s"] = round(time.perf_counter() - t0, 3)
                    with self._table_lock:
                        self._forced_drain.pop(name, None)
                        if row.get("ok"):
                            self._states[name] = "ready"  # re-admit NOW
            rows.append(row)
        ok = all(r.get("ok") for r in rows)
        if ok:
            # the family is documented as rolling swaps COMPLETED: a
            # roll with failed replicas must not count as one
            self._c_rolls.inc()
        new_versions = [
            r["version"][1] for r in rows
            if r.get("ok") and r.get("version")
            and r["version"][1] is not None
        ]
        if new_versions and (adds or dels):
            # the fleet COMMITTED this version on every replica that
            # rolled; a replica that missed it (dead mid-roll, respawn
            # from stale state) must catch up before re-admission —
            # keep the batch in the bounded history so _try_catchup can
            # replay it
            key = self._graph_key(graph)
            newv = int(max(new_versions))
            with self._table_lock:
                self._committed[key] = max(
                    self._committed.get(key, 0), newv
                )
                hist = self._roll_history.setdefault(key, [])
                hist.append((newv, list(adds), list(dels)))
                del hist[:-ROLL_HISTORY_MAX]
        return {
            "graph": self._graph_key(graph),
            "adds": len(adds),
            "dels": len(dels),
            "replicas": rows,
            "ok": ok,
        }

    def _probe_ready(self, replica, graph, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if replica.probe(graph, timeout=5.0):
                    state = replica.health()["state"]
                    if state == "ready":
                        return True
            except Exception:
                pass
            time.sleep(0.05)
        return False

    # ---- introspection / lifecycle ----------------------------------
    def table(self) -> dict:
        with self._table_lock:
            return dict(self._states)

    def catchup_stuck(self) -> dict:
        """``{replica: seconds}`` for every replica currently held in
        the ``catchup`` table state — the supervisor's escape-hatch
        input and the stuck-gauge's source of truth."""
        now = time.monotonic()
        with self._table_lock:
            return {
                name: round(now - since, 3)
                for name, since in self._catchup_since.items()
            }

    def health_snapshot(self) -> dict:
        """The fleet's ``/healthz`` payload: ready while anything is
        routable and nothing is wedged; degraded (still 200 — the
        routable replicas ARE serving) with per-replica reasons when a
        replica is dead, draining or stuck in catchup; unready when
        nothing routes at all."""
        now = time.monotonic()
        with self._table_lock:
            states = dict(self._states)
            since = dict(self._catchup_since)
        reasons = []
        for name in sorted(states):
            s = states[name]
            if s == "catchup":
                stuck = now - since.get(name, now)
                reasons.append(
                    f"replica {name} catchup ({stuck:.1f}s stuck)"
                )
            elif s in ("dead", "draining"):
                reasons.append(f"replica {name} {s}")
        routable = any(s in ROUTABLE_STATES for s in states.values())
        if not routable:
            state = "unready"
        elif reasons:
            state = "degraded"
        else:
            state = "ready"
        return {"state": state, "reasons": reasons}

    def stats(self) -> dict:
        now = time.monotonic()
        replicas = self._replicas  # snapshot vs concurrent scale events
        order = self._order
        with self._table_lock:
            states = dict(self._states)
            versions = {
                f"{name}:{g}": v
                for (name, g), v in self._versions.items()
            }
            committed = dict(self._committed)
            # dict, not list (membership tests still work): each held
            # replica carries how long it has been stuck — 0.0 until
            # the poller has actually seen it in the catchup state
            pending_catchup = {
                name: {
                    "stuck_s": round(
                        now - self._catchup_since[name], 3
                    ) if name in self._catchup_since else 0.0,
                }
                for name in sorted(self._needs_catchup)
            }
        return {
            "replicas": {
                name: {
                    "state": states.get(name),
                    "kind": getattr(replicas[name], "kind", "?"),
                    "routed": (
                        self._routed_cells[name].value
                        if name in self._routed_cells else 0
                    ),
                    "load": self._load_of(name),
                }
                for name in order if name in replicas
            },
            "versions": versions,
            "committed": committed,
            "pending_catchup": pending_catchup,
            "reroutes": self._c_reroutes.value,
            "spills": self._c_spills.value,
            "rolls": self._c_rolls.value,
            "catchups": self._c_catchups.value,
            "spill_after": self.spill_after,
            "poll_interval_s": self.poll_interval_s,
        }

    def metrics_snapshot(self) -> dict:
        """Per-replica Prometheus text — the fleet-wide scrape's raw
        material. Out-of-process replicas (subprocess REPL, net child)
        answer over their control surface; in-process EngineReplicas
        mint into THIS process's registry already and return None (the
        aggregator must not double-count them). A dead replica's entry
        is None too — a scrape never fails because one replica is
        down."""
        out: dict = {}
        for name in list(self._order):
            fn = getattr(self._replicas.get(name), "metrics_render",
                         None)
            if fn is None:
                out[name] = None
                continue
            try:
                out[name] = fn()
            except Exception:
                out[name] = None
        return out

    def close(self, close_replicas: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        self._poll_stop.set()
        self._poll_nudge.set()  # wake the poller so it sees the stop
        self._poller.join(timeout=10.0)
        if close_replicas:
            for replica in list(self._replicas.values()):
                try:
                    replica.close()
                except Exception:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
