"""A pool of mesh ranks that stay up across calls: the single-host
counterpart of ``bibfs_tpu/parallel/podmesh.py`` (its ``PodPrimary`` and
the descriptor loop of ``run_pod_worker``).

:func:`~bibfs_tpu_torch.parallel.mesh.launch` spawns its ranks for one
call and ends them with it; a serving engine cannot pay a spawn (seconds)
and a graph upload per flush. :class:`MeshPool` spawns ``ranks`` processes
once (the placement of :func:`~bibfs_tpu_torch.parallel.mesh.placement`:
NCCL with a card per rank, gloo on the CPU, staged gloo for ranks sharing
a card; the set-up of :func:`~bibfs_tpu_torch.parallel.mesh._join`) and
sends them descriptors, which every rank executes strictly in the order
the pool sent them:

- ``graph`` (a key and a host-graph directory, as ``solvers/sharded.py::
  save_host_graph`` or ``Sharded2DHost.save`` writes it): registered; the
  rank builds its 1D shard, data-parallel replica or 2D block from it on
  demand (:class:`~bibfs_tpu_torch.solvers.sharded.RankJobs`);
- ``release`` (a key): forgotten, and its directory removed once the
  ranks have done so;
- ``jobs``: :class:`~bibfs_tpu_torch.solvers.sharded.RankJobs`'s job
  kinds; rank 0 answers with the results, materialized (a
  :class:`~bibfs_tpu_torch.solvers.api.BFSResult` carries its path,
  never a parent row);
- ``counts`` (the ranks' kernel launch counts, summed) and ``shutdown``.

The caller's process is not a rank: :meth:`MeshPool.submit` only writes
the descriptor to each rank's pipe, and :meth:`MeshPool.wait` waits on the
answer with a timeout, so a thread of the caller never enters a
collective. A reader thread takes the ranks' answers and watches their
processes: a rank that dies, raises or outlasts the timeout fails every
pending descriptor with :class:`MeshError` and the pool kills the other
ranks; :meth:`MeshPool.ensure_up` spawns a fresh set (a new
``generation``, every graph to register again). :meth:`MeshPool.close`
leaves no child process behind.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import wait as _wait_any

DEFAULT_POOL_TIMEOUT_S = 600.0


class MeshError(RuntimeError):
    """A pool rank died, raised or outlasted its timeout; the pool is down
    until :meth:`MeshPool.ensure_up`."""


def _pool_rank_main(rank: int, size: int, tmp: str, devices: list,
                    backend: str, staged: bool, timeout_s: float,
                    conn) -> None:
    """One pool rank: join (the set-up :func:`~bibfs_tpu_torch.parallel.
    mesh.launch` uses), then execute descriptors in receipt order until
    ``shutdown``; any failure is sent back and ends the rank."""
    from bibfs_tpu_torch.parallel.mesh import _join, _leave
    from bibfs_tpu_torch.solvers.sharded import RankJobs, kernel_launches

    try:
        mesh = _join(rank, size, tmp, devices, backend, staged, timeout_s)
    except Exception:
        conn.send((0, "err", traceback.format_exc()))
        return
    state = RankJobs(mesh)
    try:
        while True:
            seq, kind, payload = conn.recv()
            try:
                val = None
                if kind == "hello":  # rank 0's placement and modules
                    val = {"rank": mesh.rank, "transport": mesh.transport,
                           "device": str(mesh.device), "pid": os.getpid(),
                           "modules": sorted({m.split(".")[0]
                                              for m in sys.modules})}
                elif kind == "graph":
                    state.add(*payload)
                elif kind == "release":
                    state.release(payload)
                elif kind == "jobs":
                    val = state.run(payload, info=False)
                    if staged:
                        # the ranks share a card: hand back what the jobs
                        # cached (the graphs stay resident); a card of
                        # its own keeps its cache for the next flush
                        import torch

                        torch.cuda.empty_cache()
                elif kind == "counts":
                    mine = kernel_launches()
                    val = {k: sum(d[k] for d in mesh.all_gather_object(mine))
                           for k in mine}
                    if payload:  # reset: the counts start from zero
                        _zero_launches()
                elif kind != "shutdown":
                    raise ValueError(f"unknown descriptor {kind!r}")
                conn.send((seq, "ok", val if mesh.rank == 0 else None))
            except Exception:
                conn.send((seq, "err", traceback.format_exc()))
                return
            if kind == "shutdown":
                return
    except (EOFError, OSError):
        return  # the pool went away
    finally:
        try:
            _leave()
        except Exception:
            pass


def _zero_launches() -> None:
    """Zero this process's launch counts of the mesh path's kernels."""
    from bibfs_tpu_torch.ops import fused_level as fl
    from bibfs_tpu_torch.ops import minor_level as ml
    from bibfs_tpu_torch.ops import pull_expand as pe

    for fn in (fl.fused_dual_round, fl.fold_round, pe.pull_dual,
               pe.pull_single):
        fn.launches = 0
    for key in ml.minor_level.launches:
        ml.minor_level.launches[key] = 0


class MeshPool:
    """``ranks`` spawned mesh ranks on ``device`` (``cuda`` or ``cpu``)
    that stay up until :meth:`close` (module docstring). ``timeout_s``
    bounds every wait and the ranks' process group."""

    def __init__(self, ranks: int, device="cuda", *,
                 timeout_s: float = DEFAULT_POOL_TIMEOUT_S):
        import torch

        from bibfs_tpu_torch.parallel.mesh import placement

        self.ranks = int(ranks)
        self.device = torch.device(device).type
        self.timeout_s = float(timeout_s)
        # raises here for a device the host does not have
        self.devices, self.backend, self.staged = placement(self.ranks,
                                                            self.device)
        self.workdir = tempfile.mkdtemp(prefix="bibfs-pool-")
        self.generation = 0
        self.spawns = 0
        self.spawn_s: float | None = None
        self.transport: str | None = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._send_lock = threading.Lock()
        self._procs: list = []
        self._conns: list = []
        self._reader = None
        self._rdv = None
        self._seq = 0
        self._replies: dict = {}  # seq -> {rank: value}
        self._done: dict = {}  # seq -> ("ok", value) | ("err", MeshError)
        self._on_done: dict = {}  # seq -> callback after success
        self._detached: set = set()  # seqs whose answers no one waits on
        self._down: str | None = "not started"
        self._closed = False
        self.ensure_up()

    # ---- lifecycle ---------------------------------------------------
    @property
    def up(self) -> bool:
        with self._lock:
            return self._down is None

    def ensure_up(self) -> dict | None:
        """Spawn the ranks if the pool is down (never started, or failed):
        the old ranks are reaped first. Returns rank 0's ``hello`` (None
        when the pool was up). Raises :class:`MeshError` when the new
        ranks do not join within the timeout."""
        with self._lock:
            if self._closed:
                raise MeshError("mesh pool is closed")
            if self._down is None:
                return None
        self._reap()
        t0 = time.perf_counter()
        self._spawn()
        hello = self.call("hello")
        with self._lock:
            self.spawn_s = time.perf_counter() - t0
            self.transport = ("gloo-staged" if self.staged else self.backend)
        return hello

    def _spawn(self) -> None:
        ctx = mp.get_context("spawn")
        self._rdv = tempfile.mkdtemp(prefix="rdv-", dir=self.workdir)
        procs, conns = [], []
        for r in range(self.ranks):
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_pool_rank_main, name=f"bibfs-mesh-rank-{r}",
                args=(r, self.ranks, self._rdv, self.devices, self.backend,
                      self.staged, self.timeout_s, child),
                daemon=True)
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
        with self._lock:
            self._procs, self._conns = procs, conns
            self._replies, self._done, self._on_done = {}, {}, {}
            self._detached = set()
            self._down = None
            self.generation += 1
            self.spawns += 1
            gen = self.generation
        self._reader = threading.Thread(
            target=self._reader_main, args=(gen, procs, conns),
            name="bibfs-mesh-pool-reader", daemon=True)
        self._reader.start()

    def _reap(self) -> None:
        """Kill and join the current ranks (a failed or closing pool)."""
        with self._lock:
            procs, conns = self._procs, self._conns
            self._procs, self._conns = [], []
            reader = self._reader
            self._reader = None
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        for c in conns:
            c.close()
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout=30)
        if self._rdv is not None:
            shutil.rmtree(self._rdv, ignore_errors=True)
            self._rdv = None

    def close(self) -> None:
        """Shut the ranks down (a ``shutdown`` descriptor, then a kill for
        any rank that outlasts a short wait), join them and remove the
        pool's directory. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            live = self._down is None
        if live:
            try:
                self.wait(self.submit("shutdown"), timeout=30)
            except MeshError:
                pass
            with self._lock:
                procs = list(self._procs)
            for p in procs:
                p.join(timeout=10)
        with self._lock:
            self._down = self._down or "closed"
        self._reap()
        shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def pids(self) -> list:
        with self._lock:
            return [p.pid for p in self._procs]

    # ---- descriptors -------------------------------------------------
    def submit(self, kind: str, payload=None, on_done=None,
               detached: bool = False) -> int:
        """Send one descriptor to every rank (in one order for all
        threads) and return its ticket for :meth:`wait` (``detached``: no
        one waits, the answer is dropped). ``on_done`` runs on the reader
        thread once every rank has answered it. Raises :class:`MeshError`
        when the pool is down."""
        with self._send_lock:
            with self._lock:
                if self._down is not None:
                    raise MeshError(f"mesh pool is down: {self._down}")
                self._seq += 1
                seq = self._seq
                self._replies[seq] = {}
                if detached:
                    self._detached.add(seq)
                if on_done is not None:
                    self._on_done[seq] = on_done
                conns = list(self._conns)
            try:
                for c in conns:
                    c.send((seq, kind, payload))
            except (OSError, ValueError) as e:
                self._fail(f"sending {kind!r} failed: {e}")
        return seq

    def wait(self, seq: int, timeout: float | None = None):
        """Rank 0's answer to descriptor ``seq``; :class:`MeshError` when a
        rank failed or the wait outlasted ``timeout`` (default the pool's),
        which takes the pool down."""
        limit = self.timeout_s if timeout is None else timeout
        deadline = time.monotonic() + limit
        with self._lock:
            while seq not in self._done:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(timeout=min(left, 1.0))
            got = self._done.pop(seq, None)
        if got is None:
            self._fail(f"descriptor {seq} outlasted {limit:.0f} s")
            with self._lock:
                got = self._done.pop(seq, ("err", MeshError(
                    f"descriptor {seq} outlasted {limit:.0f} s")))
        status, val = got
        if status == "err":
            raise val
        return val

    def call(self, kind: str, payload=None, timeout: float | None = None):
        """:meth:`submit` then :meth:`wait`."""
        return self.wait(self.submit(kind, payload), timeout)

    def graph(self, key: str, path: str) -> int:
        """Register a host-graph directory under ``key`` on every rank. The
        ranks map its arrays when a job first needs them, so the directory
        must stay as it is until the key is released."""
        return self.submit("graph", (key, path), detached=True)

    def release(self, key: str, path: str | None = None) -> None:
        """Forget ``key`` on every rank, then remove ``path`` (a directory
        of the pool's) once they have. A pool that is down has nothing to
        forget."""
        cleanup = None
        if path is not None:
            def cleanup():
                shutil.rmtree(path, ignore_errors=True)
        try:
            self.submit("release", key, on_done=cleanup, detached=True)
        except MeshError:
            if cleanup is not None:
                cleanup()

    def jobs(self, jobs: list) -> int:
        return self.submit("jobs", jobs)

    def counts(self, reset: bool = False) -> dict:
        """The ranks' kernel launch counts, summed (``reset`` zeroes them
        after the read)."""
        return self.call("counts", reset)

    # ---- failure -----------------------------------------------------
    def _fail(self, reason: str) -> None:
        """Take the pool down: every pending descriptor fails with
        :class:`MeshError`, the ranks are killed."""
        with self._lock:
            if self._down is not None:
                return
            self._down = reason
            for seq in list(self._replies):
                self._done[seq] = ("err", MeshError(
                    f"mesh pool failed: {reason}"))
            for seq in self._detached:
                self._done.pop(seq, None)
            self._replies.clear()
            self._on_done.clear()
            self._detached.clear()
            self._cv.notify_all()
            procs = list(self._procs)
        for p in procs:
            if p.is_alive():
                p.kill()

    def _reader_main(self, gen: int, procs: list, conns: list) -> None:
        index = {id(c): r for r, c in enumerate(conns)}
        sentinels = {p.sentinel: r for r, p in enumerate(procs)}
        while True:
            with self._lock:
                if self.generation != gen or self._down is not None:
                    return
            try:
                ready = _wait_any(list(conns) + list(sentinels), timeout=0.5)
            except (OSError, ValueError):
                return
            for obj in ready:
                if obj in sentinels:  # a rank exited: its last answers first
                    r = sentinels[obj]
                    try:
                        while conns[r].poll():
                            if not self._take(conns[r], r):
                                return
                    except (EOFError, OSError):
                        pass
                    procs[r].join(timeout=1)
                    self._fail(f"rank {r} exited (exit code "
                               f"{procs[r].exitcode})")
                    return
                r = index[id(obj)]
                try:
                    if not self._take(obj, r):
                        return
                except (EOFError, OSError):
                    self._fail(f"rank {r} closed its pipe")
                    return

    def _take(self, conn, rank: int) -> bool:
        """One answer of ``rank``; False when it reported a failure."""
        seq, status, val = conn.recv()
        if status == "err":
            self._fail(f"rank {rank} raised:\n{val}")
            return False
        self._reply(seq, rank, val)
        return True

    def _reply(self, seq: int, rank: int, val) -> None:
        hook = None
        with self._lock:
            got = self._replies.get(seq)
            if got is None:
                return
            got[rank] = val
            if len(got) < self.ranks:
                return
            del self._replies[seq]
            if seq in self._detached:
                self._detached.discard(seq)
            else:
                self._done[seq] = ("ok", got[0])
            hook = self._on_done.pop(seq, None)
            self._cv.notify_all()
        if hook is not None:
            hook()
