"""Replica adapters — one serving engine behind the Router's uniform
replica interface: the counterpart of ``bibfs_tpu/fleet/replica.py``.

The fleet router (:mod:`bibfs_tpu_torch.fleet.router`) is replica-agnostic:
anything that can *submit* a query, report *health*, *drain*, *roll*
its graph store, and be *killed/restarted* can serve in a fleet. Two
adapters implement that surface:

- :class:`EngineReplica` — an in-process
  :class:`~bibfs_tpu_torch.serve.engine.QueryEngine` /
  :class:`~bibfs_tpu_torch.serve.pipeline.PipelinedQueryEngine` over its OWN
  :class:`~bibfs_tpu_torch.store.GraphStore` (per-replica stores are what
  make per-replica versions meaningful: mid-rolling-swap the fleet
  serves mixed versions, each replica exact for the version it
  declares). The synchronous engine is not thread-safe by itself, so
  the replica serializes access with one lock; the pipelined engine
  brings its own thread-safety and the lock only brackets lifecycle
  transitions.
- :class:`ProcessReplica` — a spawned ``bibfs-torch-serve`` subprocess driven
  over its stdin/stdout REPL: queries as ``src dst`` lines, control via
  the ``health`` / ``stats`` / ``use`` / ``update`` / ``swap``
  commands (one shared control surface for routers and operators).
  ``kill()`` is a REAL process kill — in-flight queries die with the
  interpreter and surface as structured ``kind='internal'`` errors the
  router reroutes, which is the genuine crash chaos the in-process
  adapter can only approximate.

Both adapters' ``submit`` raises :class:`ReplicaDead` once the replica
is down (and :class:`~bibfs_tpu_torch.serve.resilience.QueryError`
``kind='capacity'`` while draining) — the two signals the router's
re-route path feeds on.

An in-process replica's engine runs where its factory puts it
(:func:`engine_replica` passes ``device=`` through); a subprocess
replica hands its ``device`` (default ``cuda``) to the child as
``--device``, and a child that cannot reach that device exits before
its first ``health`` reply, so the spawn raises :class:`ReplicaDead`
instead of serving anywhere else.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from collections import deque

from bibfs_tpu_torch.utils.annotations import guarded_by
from bibfs_tpu_torch.obs.dtrace import ctx_token
from bibfs_tpu_torch.serve.engine import QueryEngine
from bibfs_tpu_torch.serve.pipeline import PipelinedQueryEngine
from bibfs_tpu_torch.serve.resilience import ERROR_KINDS, QueryError
from bibfs_tpu_torch.solvers.api import BFSResult


class ReplicaDead(RuntimeError):
    """The replica cannot take work (killed, crashed, or closed) — the
    router treats this as an immediate re-route signal and marks the
    replica dead ahead of the next health poll."""


class LifecycleHooks:
    """kill/restart notification plumbing shared by the replica
    adapters: the router subscribes its poller nudge here so a chaos
    kill or a supervisor respawn is observed within one immediate poll
    tick instead of a full ``poll_interval_s``. Callbacks run on the
    event's own thread and must be cheap and non-raising (an
    ``Event.set``); failures are swallowed — a broken subscriber must
    not break the kill/restart it observes."""

    def on_lifecycle(self, cb) -> None:
        """Subscribe ``cb(name, event)`` to this replica's lifecycle
        events (``"kill"`` / ``"restart"``)."""
        if not hasattr(self, "_lifecycle_cbs"):
            self._lifecycle_cbs = []
        self._lifecycle_cbs.append(cb)

    def _notify_lifecycle(self, event: str) -> None:
        for cb in list(getattr(self, "_lifecycle_cbs", ())):
            try:
                cb(self.name, event)
            except Exception:
                pass


@guarded_by("_lock", "_engine")
class EngineReplica(LifecycleHooks):
    """An in-process serving engine behind the replica interface.

    Parameters
    ----------
    name : the replica's fleet-wide identity (routing table key and
        the ``replica=`` label on ``bibfs_fleet_routed_total``).
    make_engine : zero-arg factory building the engine — called at
        construction and again by :meth:`restart`, so a restarted
        replica comes back over the SAME store (its graphs, versions
        and pending deltas survive the crash; only the engine-local
        caches start cold, exactly like a restarted process).
    store : the replica's own :class:`~bibfs_tpu_torch.store.GraphStore`
        (None for an inline-graph engine; rolling swaps then have
        nothing to roll and :meth:`roll` raises).
    own_store : close the store with the replica (default True when a
        store is attached).
    """

    kind = "engine"

    def __init__(self, name: str, make_engine, *, store=None,
                 own_store: bool = True):
        self.name = str(name)
        self._make = make_engine
        self.store = store
        self._own_store = bool(own_store and store is not None)
        self._lock = threading.RLock()
        self._dead = False
        self._draining = False
        # incarnation counter: bumped on every restart so the router's
        # poller detects a death-and-return it never observed live (a
        # respawn faster than one poll tick) and still runs its
        # catch-up check before re-admission
        self.generation = 0
        self._engine = make_engine()

    # ---- serving -----------------------------------------------------
    @property
    def engine(self):
        return self._engine

    @property
    def alive(self) -> bool:
        return not self._dead and self._engine is not None

    def submit(self, src: int, dst: int, graph: str | None = None,
               ctx=None):
        """Queue one query; returns the engine's ticket. Fast-fails
        BEFORE the replica lock: a draining replica answers capacity
        (retryable on a peer) and a dead one raises
        :class:`ReplicaDead` — neither may block behind a drain's
        in-flight flush, or the router's re-route would stall on
        exactly the replica it is routing around. ``ctx`` is the
        router's sampled trace context, threaded into the engine
        ticket (None, the common case, costs nothing)."""
        if self._dead:
            raise ReplicaDead(f"replica {self.name} is dead")
        if self._draining:
            raise QueryError(
                f"replica {self.name} is draining", kind="capacity",
                query=(int(src), int(dst)),
            )
        with self._lock:
            eng = self._engine
            if self._dead or eng is None:
                raise ReplicaDead(f"replica {self.name} is dead")
            return eng.submit(src, dst, graph, ctx=ctx)

    def wait_ticket(self, ticket, timeout: float | None = None):
        """Resolve one of this replica's tickets: the pipelined ticket
        waits on its own future; a synchronous pending ticket flushes
        the engine (under the replica lock) to land its batch. Raises
        the ticket's structured error, which is what the router's
        failover path catches."""
        if ticket.result is None and ticket.error is None:
            if hasattr(ticket, "wait"):  # pipelined: its own condvar
                return ticket.wait(timeout=timeout)
            with self._lock:
                eng = self._engine
                if ticket.result is None and ticket.error is None:
                    if eng is None or self._dead:
                        raise QueryError(
                            "replica died with the query pending",
                            kind="internal",
                            query=(ticket.src, ticket.dst),
                        )
                    eng.flush()
        if ticket.error is not None:
            raise ticket.error
        if ticket.result is None:
            raise QueryError(
                "ticket unresolved after flush", kind="internal",
                query=(ticket.src, ticket.dst),
            )
        return ticket.result

    def flush(self, timeout: float | None = None) -> None:
        """Resolve everything queued (the drain step of a rolling swap;
        draining blocks new submits, not this)."""
        with self._lock:
            eng = self._engine
        if eng is None or self._dead:
            return
        if isinstance(eng, PipelinedQueryEngine):
            eng.flush(timeout=timeout)
        else:
            with self._lock:
                eng.flush()

    def load(self) -> int:
        """Queued-query depth — the router's spill input."""
        eng = self._engine
        if eng is None or self._dead:
            return 1 << 30
        try:
            return eng.pending
        except Exception:
            return 1 << 30

    # ---- control plane ----------------------------------------------
    def health(self) -> dict:
        """The engine's ``/healthz`` payload; raises
        :class:`ReplicaDead` when there is no engine to ask — the
        router's poller maps that onto the ``dead`` table state."""
        eng = self._engine
        if self._dead or eng is None:
            raise ReplicaDead(f"replica {self.name} is dead")
        return eng.health_snapshot()

    def stats(self) -> dict:
        eng = self._engine
        if eng is None:
            return {"dead": True}
        out = eng.stats()
        out["dead"] = self._dead
        return out

    def memory(self) -> dict:
        """Per-graph memory-tier stats (store-backed replicas only):
        tier, resident/mapped bytes, residency-budget headroom."""
        if self.store is None:
            raise ValueError(f"replica {self.name} has no store")
        return self.store.memory_stats()

    def version(self, graph: str | None = None) -> int | None:
        """The snapshot version this replica currently declares for
        ``graph`` — what makes a mid-roll answer attributable."""
        if self.store is not None:
            name = self.store.default_graph() if graph is None else graph
            return self.store.current(name).version
        eng = self._engine
        if eng is None:
            return None
        return eng.stats()["graph"]["version"]

    def begin_drain(self) -> bool:
        """Stop accepting submits (fast capacity refusals at BOTH the
        replica and the engine seam) while queued tickets still
        resolve. Returns True when the engine-level drain engaged."""
        self._draining = True
        with self._lock:
            eng = self._engine
            if eng is not None and not self._dead:
                eng.begin_drain()
                return True
        return False

    def end_drain(self) -> bool:
        self._draining = False
        with self._lock:
            eng = self._engine
            if eng is not None and not self._dead:
                eng.end_drain()
                return True
        return False

    def roll(self, graph: str | None = None, adds=(), dels=()) -> int:
        """Apply + fold one update batch on THIS replica's store
        (:meth:`GraphStore.roll`) and return the new declared version.
        The caller (``Router.rolling_swap``) owns the drain/probe
        choreography around it."""
        if self.store is None:
            raise ValueError(
                f"replica {self.name} serves an inline graph; rolling "
                "swaps need a store-backed replica"
            )
        name = self.store.default_graph() if graph is None else str(graph)
        return int(self.store.roll(name, adds=adds, dels=dels).version)

    def update(self, graph: str | None = None, adds=(), dels=()) -> None:
        """Apply one live edge-update batch on this replica's store
        WITHOUT folding it (the overlay answers exactly until the next
        compaction/roll). Returning IS the store's ack — on a durable
        store, the batch is WAL-logged first."""
        if self.store is None:
            raise ValueError(
                f"replica {self.name} serves an inline graph; live "
                "updates need a store-backed replica"
            )
        name = self.store.default_graph() if graph is None else str(graph)
        self.store.update(name, adds=adds, dels=dels)

    def probe(self, graph: str | None = None,
              timeout: float = 10.0) -> bool:
        """Ready probe: one trivial query end-to-end through the submit
        seam (resolves inline, proving admission + graph resolution
        without burning a solve)."""
        ticket = self.submit(0, 0, graph)
        return self.wait_ticket(ticket, timeout=timeout) is not None

    # ---- chaos / lifecycle ------------------------------------------
    def kill(self) -> None:
        """Crash the replica: queued tickets fail with structured
        ``kind='internal'`` errors (``engine.kill()``) for the router
        to reroute; the store survives for :meth:`restart`."""
        self._dead = True
        with self._lock:
            eng, self._engine = self._engine, None
        if eng is not None:
            eng.kill()
        self._notify_lifecycle("kill")

    def restart(self) -> None:
        """Bring the replica back over the same store (fresh engine,
        cold caches) — the router's poller re-admits it once health
        reads ready."""
        with self._lock:
            if self._engine is None:
                self._engine = self._make()
                self.generation += 1
            self._draining = False
            self._dead = False
        self._notify_lifecycle("restart")

    def close(self) -> None:
        self._dead = True
        with self._lock:
            eng, self._engine = self._engine, None
        if eng is not None:
            try:
                eng.close()
            except Exception:
                pass
        if self._own_store:
            self.store.close()


def engine_replica(name: str, store, *, pipelined: bool = False,
                   graph: str | None = None, own_store: bool = True,
                   **engine_kwargs) -> EngineReplica:
    """Build an :class:`EngineReplica` over ``store`` with a restart
    factory baked in. ``pipelined`` selects the engine flavor;
    ``engine_kwargs`` pass through to the engine ctor (and apply to
    every restart)."""
    cls = PipelinedQueryEngine if pipelined else QueryEngine

    def make():
        return cls(store=store, graph=graph, **engine_kwargs)

    return EngineReplica(name, make, store=store, own_store=own_store)


class _ProcTicket:
    """One in-flight subprocess query (FIFO-matched to result lines)."""

    __slots__ = ("src", "dst", "graph", "result", "error", "event")

    def __init__(self, src: int, dst: int, graph: str | None):
        self.src = src
        self.dst = dst
        self.graph = graph
        self.result: BFSResult | None = None
        self.error: BaseException | None = None
        self.event = threading.Event()


class _Reply:
    """One pending control-command reply (FIFO-matched).
    ``on_line`` optionally inspects the reply when it lands (the
    fire-and-forget ``use`` switch validates itself through it)."""

    __slots__ = ("line", "event", "on_line")

    def __init__(self, on_line=None):
        self.line: str | None = None
        self.event = threading.Event()
        self.on_line = on_line


#: stdout prefixes that are control replies, not query results (the
#: swap reply contains " -> " too, so prefixes are checked FIRST)
_CONTROL_PREFIXES = (
    "health ", "stats ", "memory ", "use ", "swap ", "update ",
    "graphs:", "oracle", "flightrec ",
)


# the reply-matching queues, the tracked stream state and the process
# handle are shared between submitters, the reader thread and restart;
# _draining stays un-annotated by design (lock-free fast-refusal read,
# re-checked inside the lock where it matters — submit's roll race)
@guarded_by("_lock", "_pending", "_control", "_current_graph", "_dead",
            "_proc")
class ProcessReplica(LifecycleHooks):
    """A spawned ``bibfs-torch-serve`` subprocess behind the replica
    interface (module docstring), serving on ``device`` (``--device``).
    The child runs ``--pipeline`` so
    queries resolve on its background flusher within ``max_wait_ms``;
    results print into stdout either as following lines arrive or at a
    ``health``/``stats`` control nudge (the CLI drains resolved tickets
    before every control reply), which is what :meth:`wait_ticket`
    leans on.

    Replies are FIFO-matched per stream: the REPL is strictly
    sequential, so query results arrive in submit order and control
    replies in command order; prefix routing separates the two.
    """

    kind = "process"

    def __init__(self, name: str, graph: str | None = None, *,
                 store_dir: str | None = None, max_wait_ms: float = 5.0,
                 durable: bool = False, fsync: str = "batch",
                 extra_args=(), spawn_timeout_s: float = 180.0,
                 device: str = "cuda"):
        if (graph is None) == (store_dir is None):
            raise ValueError("pass a .bin graph path OR store_dir")
        if durable and store_dir is None:
            raise ValueError("durable=True needs store_dir")
        self.name = str(name)
        self.store = None  # the store lives in the child
        self.device = str(device)
        self._graph_path = graph
        self._store_dir = store_dir
        self._durable = bool(durable)
        self._fsync = str(fsync)
        self._max_wait_ms = float(max_wait_ms)
        self._extra = list(extra_args)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._lock = threading.RLock()
        self._draining = False
        self.generation = -1  # bumped to 0 by the first _spawn
        self._spawn()

    # ---- process plumbing -------------------------------------------
    def _spawn(self) -> None:
        argv = [sys.executable, "-u", "-m", "bibfs_tpu_torch.serve.cli"]
        if self._graph_path is not None:
            argv.append(self._graph_path)
        else:
            argv += ["--store", self._store_dir]
            if self._durable:
                # the child write-ahead-logs every acked update and
                # RECOVERS manifest+WAL on spawn — a kill()ed replica
                # respawns at its latest acked state, not the v1 seed
                argv += ["--durable", "--fsync", self._fsync]
        argv += [
            "--pipeline", "--no-path",
            "--max-wait-ms", str(self._max_wait_ms),
            "--device", self.device,
        ] + self._extra
        env = dict(os.environ)
        env["PYTHONUNBUFFERED"] = "1"  # live pipes need live prints
        # tickets left over from a killed incarnation belong to IT:
        # fail them now, before the reset abandons them unresolvable
        # (the dead child's reader may not have seen its EOF yet)
        self._sweep_pending("replica restarted with the query pending")
        # reset + process swap in ONE locked section: the dead child's
        # reader EOF-sweeps through _fail_all, whose stale-incarnation
        # check compares against self._proc — a sweep interleaving a
        # half-reset respawn could otherwise mark the NEW replica dead
        with self._lock:
            self._pending: deque[_ProcTicket] = deque()
            self._control: deque[_Reply] = deque()
            self._current_graph: str | None = None
            self._dead = False
            self.generation += 1  # the incarnation bump (router catchup)
            self._proc = subprocess.Popen(
                argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True, env=env,
            )
            self._reader = threading.Thread(
                target=self._read_main, args=(self._proc,),
                name=f"bibfs-fleet-{self.name}-reader", daemon=True,
            )
        self._reader.start()
        # readiness barrier: the first health reply proves the child
        # imported, built its engine on its device, and is answering the
        # REPL (a child that cannot reach the device exits first: its
        # EOF sweep fails this command and the spawn raises ReplicaDead)
        self.health(timeout=self._spawn_timeout_s)

    def _read_main(self, proc) -> None:
        try:
            for raw in proc.stdout:
                line = raw.rstrip("\n")
                if not line:
                    continue
                if line.startswith(_CONTROL_PREFIXES):
                    self._pop_control(line)
                elif line.startswith("error"):
                    # query errors carry the pair ("error kind: s -> d:
                    # ..."); command usage errors don't
                    if " -> " in line:
                        self._pop_ticket(line)
                    else:
                        self._pop_control(line)
                elif " -> " in line:
                    self._pop_ticket(line)
                # anything else: stderr-style chatter on stdout; ignore
        except (ValueError, OSError):
            pass
        finally:
            self._fail_all("replica process exited", proc)

    def _pop_control(self, line: str) -> None:
        with self._lock:
            fut = self._control.popleft() if self._control else None
        if fut is not None:
            fut.line = line
            if fut.on_line is not None:
                try:
                    fut.on_line(line)
                except Exception:
                    pass
            fut.event.set()

    @staticmethod
    def _line_pair(line: str):
        """The ``(src, dst)`` a result/error line is about, or None.
        Lines look like ``"{src} -> {dst}: ..."`` or
        ``"error {kind}: {src} -> {dst}: ..."``."""
        head = line.split(": ", 2)[1 if line.startswith("error") else 0]
        try:
            s, d = head.split(" -> ")
            return int(s), int(d)
        except (ValueError, IndexError):
            return None

    def _pop_ticket(self, line: str) -> None:
        # match by PAIR, earliest first — NOT blind FIFO: the child
        # prints submit-time rejections ("error invalid: s -> d: ...")
        # immediately, ahead of earlier still-unresolved queries, so
        # reply order is not submit order the moment anything is
        # refused. Pair matching keeps every reply attributed to its
        # own query; a reply with no pending match (e.g. a query
        # removed by the bad-`use` sweep) is dropped harmlessly.
        pair = self._line_pair(line)
        t = None
        with self._lock:
            if pair is None:
                if self._pending:
                    t = self._pending.popleft()
            else:
                for cand in self._pending:
                    if (cand.src, cand.dst) == pair:
                        t = cand
                        self._pending.remove(cand)
                        break
        if t is None:
            return
        if line.startswith("error"):
            head = line.split(":", 1)[0].split()
            kind = head[1] if len(head) > 1 else "internal"
            if kind not in ERROR_KINDS:
                kind = "internal"
            # bibfs: allow(error-kind): deserializes the child's wire kind — validated against ERROR_KINDS on the line above, unknowns coerced to internal
            t.error = QueryError(line, kind=kind, query=(t.src, t.dst))
        elif "no path" in line:
            t.result = BFSResult(False, None, None, None, 0.0, 0, 0)
        else:
            try:
                hops = int(line.rsplit("length = ", 1)[1].split()[0])
            except (IndexError, ValueError):
                t.error = QueryError(
                    f"unparseable reply {line!r}", kind="internal",
                    query=(t.src, t.dst),
                )
                t.event.set()
                return
            t.result = BFSResult(True, hops, None, None, 0.0, 0, 0)
        t.event.set()

    def _sweep_pending(self, why: str) -> None:
        """Fail every outstanding ticket/control reply with ``why``
        (structured internal errors the router reroutes)."""
        with self._lock:
            pending = list(getattr(self, "_pending", ()))
            control = list(getattr(self, "_control", ()))
            if pending:
                self._pending.clear()
            if control:
                self._control.clear()
        for t in pending:
            if t.result is None and t.error is None:
                t.error = QueryError(
                    why, kind="internal", query=(t.src, t.dst)
                )
            t.event.set()
        for fut in control:
            fut.event.set()  # line stays None: caller sees ReplicaDead

    def _fail_all(self, why: str, proc=None) -> None:
        with self._lock:
            if proc is not None and proc is not self._proc:
                # a STALE reader (the killed incarnation's EOF sweep
                # racing a restart): its tickets were swept by _spawn —
                # it must not mark the respawned replica dead
                return
            self._dead = True
        self._sweep_pending(why)

    def _write(self, line: str) -> None:
        try:
            self._proc.stdin.write(line + "\n")
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError) as e:
            raise ReplicaDead(
                f"replica {self.name} pipe closed: {e}"
            ) from e

    # ---- serving -----------------------------------------------------
    @property
    def alive(self) -> bool:
        return not self._dead and self._proc.poll() is None

    def _use_failed(self, graph: str) -> None:
        """The ``use GRAPH`` switch was refused (unknown graph): reset
        the tracked current graph (the child kept its old one) and fail
        every pending ticket aimed at ``graph`` — their queries were
        (or will be) answered against the WRONG graph, and a silent
        wrong answer is the one outcome a fleet may never produce. The
        stray result lines the child still prints find no pair-matched
        pending ticket and drop harmlessly."""
        with self._lock:
            self._current_graph = None
            bad = [t for t in self._pending if t.graph == graph]
            for t in bad:
                self._pending.remove(t)
        for t in bad:
            if t.result is None and t.error is None:
                t.error = QueryError(
                    f"unknown graph {graph!r} on replica {self.name}",
                    kind="invalid", query=(t.src, t.dst),
                )
            t.event.set()

    def submit(self, src: int, dst: int, graph: str | None = None,
               ctx=None):
        src, dst = int(src), int(dst)
        if self._draining:  # fast refusal outside the lock
            raise QueryError(
                f"replica {self.name} is draining", kind="capacity",
                query=(src, dst),
            )
        t = _ProcTicket(src, dst, graph)
        # reply lines carry only the pair, so two PENDING tickets with
        # one pair are ambiguous the moment an error line jumps the
        # result FIFO (submit-time refusals print immediately) — and a
        # cross-graph duplicate could then take the other graph's
        # answer. Refuse the ambiguity structurally: wait out the
        # earlier duplicate before submitting this one (duplicates are
        # rare; the flush is bounded).
        for _ in range(2):
            with self._lock:
                dup = any(
                    (p.src, p.dst) == (src, dst) for p in self._pending
                )
            if not dup:
                break
            self.flush(timeout=60.0)
        with self._lock:
            if self._draining:
                # re-check INSIDE the lock: a submit that raced past
                # the fast check while rolling_swap engaged the drain
                # must not slip its query in after the roll's `swap`
                # line with a pre-roll declared version
                raise QueryError(
                    f"replica {self.name} is draining",
                    kind="capacity", query=(src, dst),
                )
            if self._dead or self._proc.poll() is not None:
                raise ReplicaDead(f"replica {self.name} is dead")
            if (graph is not None and self._store_dir is not None
                    and graph != self._current_graph):
                # `use` switches the stream's current graph; the reply
                # validates itself via the callback — a refused switch
                # sweeps this graph's pending tickets instead of
                # letting the child answer them on the old graph
                self._control.append(_Reply(
                    on_line=self._use_reply(graph)
                ))
                self._write(f"use {graph}")
                self._current_graph = graph
            self._pending.append(t)
            try:
                # sampled queries carry their trace context as the
                # line protocol's trailing '@t:' token — the child's
                # REPL adopts it instead of sampling its own
                if ctx is not None:
                    self._write(f"{src} {dst} {ctx_token(ctx)}")
                else:
                    self._write(f"{src} {dst}")
            except ReplicaDead:
                self._pending.remove(t)
                raise
        return t

    def _nudge(self) -> None:
        """Fire-and-forget ``health``: the CLI drains resolved tickets
        before every control reply, so this is the result-print pump
        for a quiet stream."""
        with self._lock:
            if self._dead or self._proc.poll() is not None:
                return
            self._control.append(_Reply())
            try:
                self._write("health")
            except ReplicaDead:
                pass

    def wait_ticket(self, ticket: _ProcTicket,
                    timeout: float | None = None):
        deadline = time.monotonic() + (60.0 if timeout is None
                                       else timeout)
        while not ticket.event.wait(0.05):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"query ({ticket.src}, {ticket.dst}) unresolved on "
                    f"replica {self.name}"
                )
            self._nudge()
        if ticket.error is not None:
            raise ticket.error
        return ticket.result

    def flush(self, timeout: float | None = None) -> None:
        deadline = time.monotonic() + (60.0 if timeout is None
                                       else timeout)
        while True:
            with self._lock:
                empty = not self._pending
            if empty or self._dead or time.monotonic() >= deadline:
                return
            self._nudge()
            time.sleep(0.05)

    def load(self) -> int:
        with self._lock:
            return len(self._pending) if not self._dead else 1 << 30

    # ---- control plane ----------------------------------------------
    def _use_reply(self, graph: str):
        """The validation callback every ``use`` switch carries."""
        return lambda line, g=graph: (
            self._use_failed(g) if line.startswith("error") else None
        )

    def _command_use(self, graph: str, timeout: float = 60.0) -> str:
        """Send ``use GRAPH`` with ``_current_graph`` updated in the
        SAME locked section as the pipe write: a concurrent submit
        either sees the new graph (its query line lands after the
        ``use`` line) or ran entirely before it — never a stale
        "already current" read that skips the re-switch while this
        ``use`` is in flight (that desync silently answers the
        submit's query on the wrong graph)."""
        fut = _Reply(on_line=self._use_reply(graph))
        with self._lock:
            if self._dead or self._proc.poll() is not None:
                raise ReplicaDead(f"replica {self.name} is dead")
            self._control.append(fut)
            self._write(f"use {graph}")
            self._current_graph = graph
        if not fut.event.wait(timeout):
            raise TimeoutError(
                f"replica {self.name}: no reply to use {graph!r} in "
                f"{timeout}s"
            )
        if fut.line is None:
            raise ReplicaDead(f"replica {self.name} died mid-command")
        return fut.line

    def _command(self, line: str, timeout: float = 60.0) -> str:
        fut = _Reply()
        with self._lock:
            if self._dead or self._proc.poll() is not None:
                raise ReplicaDead(f"replica {self.name} is dead")
            self._control.append(fut)
            self._write(line)
        if not fut.event.wait(timeout):
            raise TimeoutError(
                f"replica {self.name}: no reply to {line!r} in "
                f"{timeout}s"
            )
        if fut.line is None:
            raise ReplicaDead(f"replica {self.name} died mid-command")
        return fut.line

    def health(self, timeout: float | None = None) -> dict:
        line = self._command("health", timeout or 60.0)
        if not line.startswith("health "):
            raise ReplicaDead(
                f"replica {self.name}: bad health reply {line!r}"
            )
        return json.loads(line[len("health "):])

    def stats(self, timeout: float | None = None) -> dict:
        line = self._command("stats", timeout or 60.0)
        if not line.startswith("stats "):
            raise ReplicaDead(
                f"replica {self.name}: bad stats reply {line!r}"
            )
        return json.loads(line[len("stats "):])

    def metrics_render(self, timeout: float | None = None) -> str:
        """The child's Prometheus text exposition (it rides the stats
        reply — a subprocess replica has no HTTP port of its own).
        The fleet's aggregated /metrics re-labels and re-exposes it."""
        return self.stats(timeout).get("metrics_render", "")

    def flightrec(self, dump: bool = False,
                  timeout: float | None = None) -> dict:
        """The child's flight-recorder ring (``dump=True`` also writes
        its ``.flightrec.json`` next to the trace spool)."""
        cmd = "flightrec dump" if dump else "flightrec"
        line = self._command(cmd, timeout or 60.0)
        if not line.startswith("flightrec "):
            raise ValueError(
                f"replica {self.name}: bad flightrec reply {line!r}"
            )
        return json.loads(line[len("flightrec "):])

    def memory(self, timeout: float | None = None) -> dict:
        """The child's ``memory`` control reply: per-graph tier, mapped
        bytes and residency-budget headroom (``--store`` children
        only — a fixed-graph child answers with a usage error, raised
        here as :class:`ReplicaDead`-shaped ValueError)."""
        line = self._command("memory", timeout or 60.0)
        if not line.startswith("memory "):
            raise ValueError(
                f"replica {self.name}: bad memory reply {line!r}"
            )
        return json.loads(line[len("memory "):])

    def version(self, graph: str | None = None) -> int | None:
        if self._store_dir is not None and graph is not None:
            reply = self._command_use(graph)
            # "use NAME: vV digest ..."
            try:
                return int(reply.split(": v", 1)[1].split()[0])
            except (IndexError, ValueError):
                return None
        st = self.stats()
        return st.get("graph", {}).get("version")

    def begin_drain(self) -> bool:
        """Subprocess replicas drain at the ROUTER (stop routing +
        flush barrier): fast replica-side refusal only — the child's
        own engine keeps accepting the lines already in the pipe."""
        self._draining = True
        return False

    def end_drain(self) -> bool:
        self._draining = False
        return False

    def roll(self, graph: str | None = None, adds=(), dels=()) -> int:
        """Roll the CHILD's store over its stdin control surface:
        ``use`` + ``update add/del`` per edge + ``swap``, written in
        graph-pinned locked chunks (``_update_commands``: a concurrent
        submit's ``use`` can never redirect the batch, and the ``swap``
        goes out only once every update was acked). Needs the replica
        spawned with ``store_dir``."""
        if self._store_dir is None:
            raise ValueError(
                f"replica {self.name} serves a fixed .bin; rolling "
                "swaps need --store children"
            )
        reply = self._update_commands(graph, adds, dels, tail="swap")
        # "swap g: vA -> vB digest ..." | "swap g: no pending delta (vA)"
        if reply.startswith("error"):
            # a refused command on a live replica, not a dead one —
            # classifying it ReplicaDead would eject a healthy replica
            raise QueryError(
                f"replica {self.name}: {reply}", kind="invalid"
            )
        try:
            if "no pending delta" in reply:
                return int(reply.rsplit("(v", 1)[1].rstrip(")"))
            return int(reply.rsplit("-> v", 1)[1].split()[0])
        except (IndexError, ValueError):
            raise ReplicaDead(
                f"replica {self.name}: bad swap reply {reply!r}"
            ) from None

    def update(self, graph: str | None = None, adds=(), dels=()) -> None:
        """Apply live edge updates on the CHILD's store over its stdin
        control surface, one ``update`` command per edge, WITHOUT
        folding them. Lines land in graph-pinned locked chunks
        (``_update_commands``): the stream's current graph is global
        child state, and a concurrent routed submit slipping its own
        ``use`` into the batch would land updates on the WRONG graph —
        the silent corruption a fleet may never produce. Each reply is
        the child store's ack — on a ``durable=True`` child that means
        the WAL record is durable under its fsync policy before the
        reply line prints, which is what makes "acked before SIGKILL
        implies served after respawn" testable at this level. A refused
        update raises; edges already acked in earlier chunks stay
        applied (per-edge commands are per-edge acks), un-written later
        chunks are never sent."""
        if self._store_dir is None:
            raise ValueError(
                f"replica {self.name} serves a fixed .bin; live "
                "updates need --store children"
            )
        self._update_commands(graph, adds, dels)

    #: update lines written per locked chunk: one chunk's lines and
    #: replies sit far below the OS pipe capacity. Holding the replica
    #: lock across an UNBOUNDED batched write can deadlock three ways
    #: at once — the reader thread needs this same lock to drain
    #: replies, a full child-stdout pipe stops the child reading
    #: stdin, and a full stdin pipe then blocks our own locked write.
    _CHUNK_LINES = 128

    def _update_commands(self, graph, adds, dels,
                         tail: str | None = None) -> str | None:
        """Write ``use`` + per-edge ``update`` lines in CHUNKS: each
        chunk's lines land in ONE locked section headed by its own
        ``use`` switch — so a concurrent submit's ``use`` interleaving
        BETWEEN chunks can never redirect the rest of the batch to the
        wrong graph — and the chunk's replies are awaited before the
        next chunk is written, which bounds in-flight pipe data
        (deadlock-free at any batch size; see ``_CHUNK_LINES``). The
        optional ``tail`` command (``roll``'s ``swap``) goes as its own
        final ``use``+tail section only after EVERY update was acked: a
        refused edge aborts the batch with nothing folded. Returns the
        tail's reply line.

        ``graph=None`` is resolved to a concrete pin first (the tracked
        current graph, else the child's starred default from the
        ``graphs`` listing): an unpinned batch would mutate whatever
        graph a concurrent submit last switched the stream to."""
        if graph is None:
            graph = self._resolve_graph_pin()
        edges = [("add", e) for e in adds] + [("del", e) for e in dels]
        for lo in range(0, len(edges), self._CHUNK_LINES):
            futs = []
            with self._lock:
                if self._dead or self._proc.poll() is not None:
                    raise ReplicaDead(f"replica {self.name} is dead")
                if graph is not None:
                    fut = _Reply(on_line=self._use_reply(graph))
                    self._control.append(fut)
                    self._write(f"use {graph}")
                    self._current_graph = graph
                    futs.append(("use", fut))
                for kind, (u, v) in edges[lo: lo + self._CHUNK_LINES]:
                    fut = _Reply()
                    self._control.append(fut)
                    self._write(f"update {kind} {int(u)} {int(v)}")
                    futs.append((f"update {kind} {u} {v}", fut))
            self._await_replies(futs)
        if tail is None:
            return None
        futs = []
        with self._lock:
            if self._dead or self._proc.poll() is not None:
                raise ReplicaDead(f"replica {self.name} is dead")
            if graph is not None:
                fut = _Reply(on_line=self._use_reply(graph))
                self._control.append(fut)
                self._write(f"use {graph}")
                self._current_graph = graph
                futs.append(("use", fut))
            tail_fut = _Reply()
            self._control.append(tail_fut)
            self._write(tail)
        self._await_replies(futs)
        if not tail_fut.event.wait(120.0):
            raise TimeoutError(
                f"replica {self.name}: no reply to {tail!r}"
            )
        if tail_fut.line is None:
            raise ReplicaDead(f"replica {self.name} died mid-command")
        return tail_fut.line

    def _resolve_graph_pin(self) -> str | None:
        """The concrete graph name an unqualified update/roll batch
        must pin: the stream's tracked current graph, else the child's
        default (the ``*``-starred entry of its ``graphs`` listing)."""
        with self._lock:
            g = self._current_graph
        if g is not None:
            return g
        line = self._command("graphs")  # "graphs: *a(v1) b(v2)"
        for tok in line.partition(": ")[2].split():
            if tok.startswith("*"):
                return tok[1:].partition("(")[0]
        return None

    def _await_replies(self, futs) -> None:
        """Wait each (what, _Reply) in order; structured errors raise
        (a refused command must abort what depends on it, not sail
        past as a bad parse)."""
        for what, fut in futs:
            if not fut.event.wait(60.0):
                raise TimeoutError(
                    f"replica {self.name}: no reply to {what!r}"
                )
            if fut.line is None:
                raise ReplicaDead(
                    f"replica {self.name} died mid-command"
                )
            if fut.line.startswith("error"):
                raise QueryError(
                    f"replica {self.name}: {fut.line}", kind="invalid"
                )

    def probe(self, graph: str | None = None,
              timeout: float = 10.0) -> bool:
        ticket = self.submit(0, 0, graph)
        return self.wait_ticket(ticket, timeout=timeout) is not None

    @property
    def pid(self) -> int | None:
        """The child's OS pid — the memory-tier soak samples
        ``/proc/<pid>/smaps_rollup`` to prove M replicas share one
        page-cache copy of the mapped arrays."""
        proc = getattr(self, "_proc", None)
        return proc.pid if proc is not None else None

    # ---- chaos / lifecycle ------------------------------------------
    def kill(self) -> None:
        """SIGKILL the child: queries in its pipe die with it and fail
        as structured internal errors (the reader's EOF sweep) — real
        crash chaos, rerouted by the router."""
        with self._lock:
            self._dead = True
        try:
            self._proc.kill()
        except Exception:
            pass
        try:
            self._proc.wait(timeout=10.0)
        except Exception:
            pass
        self._notify_lifecycle("kill")

    def restart(self) -> None:
        if self._proc.poll() is None:
            self.kill()
        self._draining = False
        self._spawn()
        self._notify_lifecycle("restart")

    def close(self) -> None:
        """Graceful: EOF on stdin lets the child drain and exit 0
        (SIGTERM would too — the CLI's drain handler); SIGKILL only
        past the timeout."""
        with self._lock:
            self._dead = True
        try:
            self._proc.stdin.close()
        except Exception:
            pass
        try:
            self._proc.wait(timeout=30.0)
        except Exception:
            try:
                self._proc.kill()
                self._proc.wait(timeout=10.0)
            except Exception:
                pass
