"""NetReplica — a ``bibfs-torch-serve --port`` child behind the replica
interface, spoken over the network front door instead of stdin pipes:
the counterpart of ``bibfs_tpu/fleet/netreplica.py``.

Same spawn/kill/restart lifecycle as
:class:`~bibfs_tpu_torch.fleet.replica.ProcessReplica` (the child is still a
subprocess this adapter owns), but the serving conversation rides the
length-prefixed framed protocol of :mod:`bibfs_tpu_torch.serve.net`:

- **Correlation ids replace FIFO pair-matching.** Every submit carries
  its own id and the reply comes back addressed, so the ProcessReplica
  contortions this adapter does NOT need — pair-matched reply popping,
  the duplicate-pair flush dance, result-drain ``health`` nudges — are
  structurally absent. Replies arrive on completion order; the
  client's reader thread resolves tickets directly.
- **Control ops are framed requests**, not prefix-routed REPL lines:
  ``health``/``stats``/``memory``/``graphs``/``version`` round-trip as
  single frames, and ``update``/``roll`` ship the whole edge batch in
  ONE frame (the server applies it against its store atomically) —
  no ``use`` statefulness, no chunked locked pipe writes.
- **Readiness is the port file**: the child atomically writes
  ``host port`` once its listener is bound (``--port-file``), the
  adapter polls for it, connects, and confirms with a ``health``
  round-trip. ``kill()`` SIGKILLs the child; the client's reader sees
  the reset and fails every pending ticket as a structured
  ``kind='internal'`` error — the same crash surface the router
  already reroutes.

``generation`` bumps per spawn exactly like ProcessReplica's, so the
router's catch-up machinery (replaying missed rolls onto a respawned
replica) carries over unchanged. The child serves on the replica's
``device`` (``--device``, default ``cuda``); one that cannot reach it
exits before binding its port, and the spawn raises
:class:`~bibfs_tpu_torch.fleet.replica.ReplicaDead`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time

from bibfs_tpu_torch.utils.annotations import guarded_by
from bibfs_tpu_torch.fleet.replica import LifecycleHooks, ReplicaDead
from bibfs_tpu_torch.serve.net import NetClient, read_port_file
from bibfs_tpu_torch.serve.resilience import QueryError


@guarded_by("_lock", "_client", "_dead")
class NetReplica(LifecycleHooks):
    """A spawned ``bibfs-torch-serve --pipeline --port 0`` child driven
    over the framed TCP front door (module docstring), serving on
    ``device``."""

    kind = "net"

    def __init__(self, name: str, graph: str | None = None, *,
                 store_dir: str | None = None, max_wait_ms: float = 5.0,
                 durable: bool = False, fsync: str = "batch",
                 extra_args=(), spawn_timeout_s: float = 180.0,
                 tenant: str | None = None, device: str = "cuda"):
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
        self._tenant = tenant
        self._lock = threading.RLock()
        self._draining = False
        self._client: NetClient | None = None
        self._dead = False
        self.generation = -1  # bumped to 0 by the first _spawn
        self._spawn()

    # ---- process plumbing -------------------------------------------
    def _spawn(self) -> None:
        fd, port_file = tempfile.mkstemp(
            prefix=f"bibfs-net-{self.name}-", suffix=".port"
        )
        os.close(fd)
        os.unlink(port_file)  # the child's atomic write recreates it
        argv = [sys.executable, "-u", "-m", "bibfs_tpu_torch.serve.cli"]
        if self._graph_path is not None:
            argv.append(self._graph_path)
        else:
            argv += ["--store", self._store_dir]
            if self._durable:
                argv += ["--durable", "--fsync", self._fsync]
        argv += [
            "--pipeline", "--no-path",
            "--max-wait-ms", str(self._max_wait_ms),
            "--port", "0", "--port-file", port_file,
            "--device", self.device,
        ] + self._extra
        env = dict(os.environ)
        env["PYTHONUNBUFFERED"] = "1"
        proc = subprocess.Popen(
            argv, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=env,
        )
        with self._lock:
            old = self._client
            self._client = None
            self._dead = False
            self.generation += 1  # the incarnation bump (router catchup)
            self._proc = proc
        if old is not None:
            # the dead incarnation's client: closing it EOF-fails any
            # ticket still pending against the old child
            old.close()
        deadline = time.monotonic() + self._spawn_timeout_s
        addr = None
        while addr is None:
            if self._proc.poll() is not None:
                raise ReplicaDead(
                    f"replica {self.name}: child exited rc="
                    f"{self._proc.returncode} before binding its port"
                )
            if time.monotonic() >= deadline:
                raise ReplicaDead(
                    f"replica {self.name}: no port file within "
                    f"{self._spawn_timeout_s}s"
                )
            addr = read_port_file(port_file)
            if addr is None:
                time.sleep(0.05)
        try:
            os.unlink(port_file)
        except OSError:
            pass
        self._addr = (addr[0], int(addr[1]))
        client = NetClient(
            addr[0], addr[1],
            connect_timeout=max(5.0, deadline - time.monotonic()),
            tenant=self._tenant,
        )
        with self._lock:
            self._client = client
        # readiness barrier: the first health reply proves the child
        # built its engine and is answering frames
        self.health(timeout=max(5.0, deadline - time.monotonic()))

    def _require_client(self) -> NetClient:
        with self._lock:
            client = self._client
            if self._dead or client is None or not client.alive:
                raise ReplicaDead(f"replica {self.name} is dead")
        return client

    # ---- serving -----------------------------------------------------
    @property
    def alive(self) -> bool:
        with self._lock:
            client = self._client
            return (not self._dead and client is not None
                    and client.alive and self._proc.poll() is None)

    def submit(self, src: int, dst: int, graph: str | None = None,
               ctx=None):
        src, dst = int(src), int(dst)
        if self._draining:  # fast refusal outside the lock
            raise QueryError(
                f"replica {self.name} is draining", kind="capacity",
                query=(src, dst),
            )
        client = self._require_client()
        try:
            # the router's sampled trace context rides the query frame
            # (NetClient stamps the trace/span fields)
            return client.submit(src, dst, graph, ctx=ctx)
        except ConnectionError as e:
            raise ReplicaDead(
                f"replica {self.name} connection lost: {e}"
            ) from e

    def wait_ticket(self, ticket, timeout: float | None = None):
        try:
            return ticket.wait(60.0 if timeout is None else timeout)
        except TimeoutError:
            raise TimeoutError(
                f"query ({ticket.src}, {ticket.dst}) unresolved on "
                f"replica {self.name}"
            ) from None

    def flush(self, timeout: float | None = None) -> None:
        deadline = time.monotonic() + (60.0 if timeout is None
                                       else timeout)
        while True:
            with self._lock:
                client = self._client
            if (client is None or not client.alive
                    or client.pending_count() == 0
                    or time.monotonic() >= deadline):
                return
            time.sleep(0.02)

    def load(self) -> int:
        with self._lock:
            client = self._client
            if self._dead or client is None or not client.alive:
                return 1 << 30
        return client.pending_count()

    # ---- control plane ----------------------------------------------
    def _request(self, op: str, timeout: float | None = None,
                 **fields) -> dict:
        client = self._require_client()
        try:
            return client.request(op, timeout=timeout or 60.0, **fields)
        except ConnectionError as e:
            raise ReplicaDead(
                f"replica {self.name} connection lost: {e}"
            ) from e

    def health(self, timeout: float | None = None) -> dict:
        return self._request("health", timeout)

    def stats(self, timeout: float | None = None) -> dict:
        return self._request("stats", timeout)

    def memory(self, timeout: float | None = None) -> dict:
        """``--store`` children only — a fixed-graph child refuses
        with a structured invalid error, surfaced as ValueError (the
        ProcessReplica contract)."""
        try:
            return self._request("memory", timeout)
        except QueryError as e:
            raise ValueError(f"replica {self.name}: {e}") from e

    def metrics_render(self, timeout: float | None = None) -> str:
        """The child's Prometheus text exposition over the framed
        ``metrics`` op — the fleet's aggregated /metrics re-labels and
        re-exposes it (same contract as ProcessReplica)."""
        out = self._request("metrics", timeout)
        return out.get("render", "") if isinstance(out, dict) else ""

    def flightrec(self, dump: bool = False,
                  timeout: float | None = None) -> dict:
        """The child's flight-recorder ring over the framed
        ``flightrec`` op (``dump=True`` also writes its
        ``.flightrec.json`` server-side)."""
        return self._request(
            "flightrec", timeout, **({"dump": True} if dump else {})
        )

    def version(self, graph: str | None = None) -> int | None:
        out = self._request(
            "version", **({} if graph is None else {"graph": graph})
        )
        return out.get("version") if isinstance(out, dict) else None

    def begin_drain(self) -> bool:
        """Replica-side fast refusal only (the router owns the flush
        barrier) — same contract as ProcessReplica."""
        self._draining = True
        return False

    def end_drain(self) -> bool:
        self._draining = False
        return False

    def roll(self, graph: str | None = None, adds=(), dels=()) -> int:
        """Roll the child's store through ONE framed ``roll`` request
        (edge batch + synchronous compaction + hot-swap server-side).
        Needs a ``store_dir`` child."""
        if self._store_dir is None:
            raise ValueError(
                f"replica {self.name} serves a fixed .bin; rolling "
                "swaps need --store children"
            )
        out = self._request(
            "roll", timeout=120.0,
            adds=[[int(u), int(v)] for u, v in adds],
            dels=[[int(u), int(v)] for u, v in dels],
            **({} if graph is None else {"graph": graph}),
        )
        try:
            return int(out["version"])
        except (KeyError, TypeError, ValueError):
            raise ReplicaDead(
                f"replica {self.name}: bad roll reply {out!r}"
            ) from None

    def update(self, graph: str | None = None, adds=(), dels=()) -> None:
        """Apply live edge updates on the child's store in ONE framed
        request, without folding them."""
        if self._store_dir is None:
            raise ValueError(
                f"replica {self.name} serves a fixed .bin; live "
                "updates need --store children"
            )
        self._request(
            "update", timeout=120.0,
            adds=[[int(u), int(v)] for u, v in adds],
            dels=[[int(u), int(v)] for u, v in dels],
            **({} if graph is None else {"graph": graph}),
        )

    def probe(self, graph: str | None = None,
              timeout: float = 10.0) -> bool:
        ticket = self.submit(0, 0, graph)
        return self.wait_ticket(ticket, timeout=timeout) is not None

    @property
    def pid(self) -> int | None:
        proc = getattr(self, "_proc", None)
        return proc.pid if proc is not None else None

    @property
    def addr(self) -> tuple:
        """The child's bound ``(host, port)`` — extra connections (the
        loadgen's multi-connection load generator) dial it directly."""
        return self._addr

    # ---- chaos / lifecycle ------------------------------------------
    def kill(self) -> None:
        """SIGKILL the child: the connection resets, the client reader
        fails every pending ticket as a structured internal error —
        real crash chaos, rerouted by the router."""
        with self._lock:
            self._dead = True
            client = self._client
        try:
            self._proc.kill()
        except Exception:
            pass
        try:
            self._proc.wait(timeout=10.0)
        except Exception:
            pass
        if client is not None:
            client.close()
        self._notify_lifecycle("kill")

    def restart(self) -> None:
        if self._proc.poll() is None:
            self.kill()
        self._draining = False
        self._spawn()
        self._notify_lifecycle("restart")

    def close(self) -> None:
        """Graceful: SIGTERM lets the child drain its front door and
        exit 0 (the CLI's --port drain handler); SIGKILL only past the
        timeout."""
        with self._lock:
            self._dead = True
            client = self._client
        try:
            self._proc.terminate()
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
        if client is not None:
            client.close()
