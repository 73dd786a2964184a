"""Pod-mesh serving plumbing — the control plane that lets ONE logical
replica span MULTIPLE ``torch.distributed`` processes: the counterpart of
``bibfs_tpu/parallel/podmesh.py``, copied with its imports re-pointed and
its port-only changes in named seams (``_build_worker_graph``,
``run_pod_worker``).

The data plane needs no help: once :func:`bibfs_tpu_torch.parallel.mesh.
init_multihost` has joined the job, the vertex-sharded batch
(:func:`bibfs_tpu_torch.solvers.sharded._batch_dispatch`) runs as one SPMD
program over the global mesh and its bitpacked dual-frontier all_gathers
(``parallel/collectives.all_gather_bits_dual``) cross the process
boundary on their own — ``tests/test_torch_podmesh.py`` holds that
exactness against the reference. What multi-process SERVING adds is a control
problem: every process must enter the same collectives in the same
order with the same operands, but only process 0 (the primary) sees
the query stream, the store, and the network front door. This module
is that missing lockstep:

- :class:`PodPrimary` (process 0) owns one TCP control connection per
  worker (the same length-prefixed JSON frames as
  :mod:`bibfs_tpu_torch.serve.net` — one wire format for both) and
  broadcasts ``graph`` / ``solve`` / ``shutdown`` descriptors;
- :func:`run_pod_worker` (process > 0) executes descriptors strictly
  in receipt order: rebuild the sharded graph on a ``graph``
  descriptor, dispatch the IDENTICAL padded batch program on a
  ``solve`` descriptor, ack each phase back;
- the reference's ``PodMeshRoute`` drives the primary side from inside
  the engine's mesh rung; the port has no such route yet, so its callers
  (the smoke's pod phase, the tests) drive the primary by hand.

**The join barrier (two-phase).** A ``solve`` launch is a
commit/abort protocol: the worker acks ``join`` once it has validated
the graph digest and built the dispatch, then PARKS until the primary
broadcasts a verdict — ``go`` (every worker joined ok: everyone,
primary included, enters the collective) or ``abort`` (some worker
refused, died, or timed out: the parked workers skip the batch and
return to the descriptor loop). The verdict phase is what makes the
failure story sound with >1 worker: without it, a worker that acked
would already be inside the collective when the primary aborted
on-host, wedging the pod until the process group's timeout.
After ``go``, each worker acks ``done`` once its
batch returned (carrying its replicated ``best``
vector so the primary can assert cross-process agreement). Any
refused/dead/timed-out join fails the launch as a :class:`PodError`
while every process is still on the host, and the engine's fallback
ladder re-runs the batch on the local single-device rungs — degraded
throughput, never a hang and never a wrong answer. (A process dying
INSIDE the collective — between ``go`` and ``done`` — is the one
fault this cannot catch; that is the process group's ``timeout_s``
job, exactly as it was ``MPI_Allreduce``'s.)

**Graph identity.** A ``graph`` descriptor ships the snapshot's
canonical pairs + content digest — as a header frame followed by
``chunks`` ``graph_chunk`` frames of :data:`GRAPH_CHUNK_EDGES` edges
each, because a realistically-sized graph (the reference's RMAT soaks) far
exceeds the 1 MiB frame bound as a single JSON frame. The worker
reassembles the stream and rebuilds the SAME
``GraphSnapshot -> bucketed ELL -> repad_rows -> ShardedGraph``
chain the primary's engine runtime built, verifying the digest over
the received pairs first. Same pairs + same mesh => bit-identical
shapes and content => the same collectives in the same order on every
process. A store hot-swap on the primary needs no special casing:
the next launch sees a new digest and re-broadcasts before solving —
the mid-traffic hot-swap the soak gates.

Thread discipline (lockgraph-checked): descriptor SENDS happen only
on the engine's flusher thread (launches are serialized by
construction; ``shutdown`` only after the engine is closed), so the
sockets have a single writer and no send lock. Acks are consumed by
one daemon reader thread per worker into a mailbox guarded by
``_lock``; waiters block on the mailbox condition, never on a socket.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import deque

import numpy as np

from bibfs_tpu_torch.obs.dtrace import ctx_fields, ctx_from_fields, dspan
from bibfs_tpu_torch.obs.metrics import REGISTRY, next_instance_label
from bibfs_tpu_torch.serve.net import (
    MAX_FRAME_BYTES,
    encode_frame,
    extract_frames,
)
from bibfs_tpu_torch.utils.annotations import guarded_by

#: default pod control port offset from the process group's coordinator
#: port — ``bibfs-serve --coordinator host:P`` listens for workers on
#: ``P + POD_PORT_OFFSET`` unless ``--pod-port`` overrides it
POD_PORT_OFFSET = 1

#: edges per ``graph_chunk`` frame. Worst case an int64 edge is two
#: 20-digit values + separators ≈ 42 JSON bytes, so 20k edges ≈ 840 KiB
#: — under the 1 MiB frame bound with envelope headroom.
GRAPH_CHUNK_EDGES = 20_000


class PodError(RuntimeError):
    """A pod control-plane failure (worker refused/died/timed out).
    Raised out of the mesh rung's launch/finish, where the engine's
    resilience ladder catches it and re-runs the batch on the local
    single-device rungs — exact answers, degraded throughput."""


def _recv_frames(sock, buf: bytearray):
    """Blocking read -> complete DECODED frames (empty list on a short
    read that completed no frame). Raises ConnectionError on EOF and
    ValueError on a frame that is not a JSON object."""
    data = sock.recv(1 << 16)
    if not data:
        raise ConnectionError("pod peer closed the control connection")
    buf.extend(data)
    out = []
    for raw in extract_frames(buf, MAX_FRAME_BYTES):
        msg = json.loads(raw.decode("utf-8"))
        if not isinstance(msg, dict):
            raise ValueError(f"pod frame is not an object: {msg!r}")
        out.append(msg)
    return out


@guarded_by("_lock", "_acks", "_dead", "_seq", "_workers", "_epochs",
            "_last_hb", "_fenced", "_regraph", "_graph_seq")
class PodPrimary:
    """Process 0's side of the pod control plane (module docstring).

    ``accept_workers`` blocks until every worker has connected and
    introduced itself, then starts one reader thread per connection.
    ``post_*`` broadcast a descriptor (single-writer by construction:
    the engine flusher); ``await_phase`` blocks on the ack mailbox.

    **Failure domains (epoch fencing).** Every worker's hello declares
    an incarnation ``epoch``, echoed on each of its acks/heartbeats.
    The reader fences any frame whose epoch is not the worker's
    CURRENT one — a zombie incarnation's late acks are dropped and
    counted (:attr:`fenced_frames`) instead of feeding
    ``await_phase``. A dead worker's replacement rejoins through
    :meth:`accept_rejoin` at a strictly higher epoch; the next launch
    re-broadcasts the graph through the existing chunk stream, so the
    mesh rung RECOVERS rather than degrading forever. Workers spawned
    with ``heartbeat_s`` send periodic ``hb`` frames;
    :meth:`check_heartbeats` (the supervisor's tick) marks a silent
    worker dead after ``heartbeat_timeout_s`` — the launch path then
    aborts pre-collective exactly like an observed death.

    Port seam (the mailbox sweep): every ``graph_chunk`` frame takes a
    seq, so a graph of more than 64 chunks (1.28M pairs) puts its
    header's ``done`` acks more than 64 seqs behind the current one by
    the time the workers can send them, and the reference's reader
    sweeps them on arrival: ``ensure_graph`` then times out with every
    worker rebuilt. The reader keeps the acks of the last broadcast
    graph header (``_graph_seq``) out of the sweep; the frames sent are
    unchanged.
    """

    def __init__(self, num_workers: int, *, host: str = "",
                 port: int = 0, accept_timeout_s: float = 120.0,
                 heartbeat_timeout_s: float | None = None):
        self.num_workers = int(num_workers)
        self._accept_timeout_s = float(accept_timeout_s)
        self._hb_timeout_s = (
            None if heartbeat_timeout_s is None
            else float(heartbeat_timeout_s)
        )
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._seq = 0
        self._workers: dict = {}       # process_index -> socket
        self._acks: dict = {}          # (seq, phase) -> {pidx: msg}
        self._dead: dict = {}          # process_index -> reason
        self._epochs: dict = {}        # process_index -> current epoch
        self._last_hb: dict = {}       # process_index -> monotonic
        self._fenced = 0               # stale-epoch frames dropped
        self._regraph = False          # rejoin -> re-broadcast graph
        self._graph_seq = None         # last graph header: never swept
        self._last_digest: str | None = None  # flusher-only state
        self._closed = False
        self._obs_label = next_instance_label("pod")
        self._g_epoch = REGISTRY.gauge(
            "bibfs_pod_worker_epoch",
            "Each pod worker's current incarnation epoch",
            ("pod", "worker"),
        )
        for pidx in range(1, self.num_workers + 1):  # render at zero
            self._g_epoch.labels(
                pod=self._obs_label, worker=str(pidx)
            ).set(0)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(self.num_workers or 1)
        self.port = self._listener.getsockname()[1]

    # ---- join --------------------------------------------------------
    def accept_workers(self) -> None:
        """Block until all ``num_workers`` workers connected and sent
        their hello; start their reader threads. Raises
        :class:`PodError` past the accept timeout."""
        deadline = time.monotonic() + self._accept_timeout_s
        joined: dict = {}
        epochs: dict = {}
        while len(joined) < self.num_workers:
            self._listener.settimeout(
                max(0.1, deadline - time.monotonic())
            )
            try:
                sock, _addr = self._listener.accept()
            except (socket.timeout, OSError):
                raise PodError(
                    f"pod: {len(joined)}/{self.num_workers} workers "
                    f"joined within {self._accept_timeout_s}s"
                ) from None
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = self._read_hello(sock, deadline)
            pidx = int(hello.get("process", -1))
            if pidx < 1:
                sock.close()
                continue
            joined[pidx] = sock
            epochs[pidx] = int(hello.get("epoch", 0))
        with self._lock:
            self._workers = joined
            self._epochs = epochs
        for pidx, epoch in epochs.items():
            self._g_epoch.labels(
                pod=self._obs_label, worker=str(pidx)
            ).set(epoch)
        for pidx, sock in joined.items():
            threading.Thread(
                target=self._reader, args=(pidx, sock, epochs[pidx]),
                name=f"bibfs-pod-ack-{pidx}", daemon=True,
            ).start()

    @staticmethod
    def _read_hello(sock, deadline: float) -> dict:
        buf = bytearray()
        while True:
            sock.settimeout(max(0.1, deadline - time.monotonic()))
            try:
                frames = _recv_frames(sock, buf)
            except (ConnectionError, socket.timeout, OSError,
                    ValueError) as e:
                raise PodError(f"pod: worker hello failed: {e}") from e
            if frames:
                return frames[0]

    # ---- ack plumbing ------------------------------------------------
    def _reader(self, pidx: int, sock, epoch: int = 0) -> None:
        buf = bytearray()
        why = "worker closed the control connection"
        try:
            while True:
                for msg in _recv_frames(sock, buf):
                    with self._lock:
                        # epoch fence: a frame from any incarnation
                        # other than the worker's CURRENT one (a
                        # zombie's late ack after a rejoin) is dropped
                        # and counted — it must never feed await_phase.
                        # An epoch-less frame defaults to THIS reader's
                        # connection epoch, so a zombie cannot dodge
                        # the fence by omitting the field.
                        cur = self._epochs.get(pidx, 0)
                        if int(msg.get("epoch", epoch)) != cur:
                            self._fenced += 1
                            continue
                        if msg.get("op") == "hb":
                            self._last_hb[pidx] = time.monotonic()
                            continue
                        key = (int(msg.get("seq", -1)),
                               str(msg.get("phase", "done")))
                        self._acks.setdefault(key, {})[pidx] = msg
                        # sweep acks that straggled in after their seq
                        # was abandoned (await_phase pops the key it
                        # waits on; a late ack re-creates it): launches
                        # are serialized, so nothing legitimately waits
                        # this far behind the current seq but the last
                        # graph header, whose chunks took seqs (the
                        # class's sweep seam)
                        stale = [k for k in self._acks
                                 if k[0] + 64 < self._seq
                                 and k[0] != self._graph_seq]
                        for k in stale:
                            del self._acks[k]
                        self._cv.notify_all()
        except (ConnectionError, OSError, ValueError) as e:
            why = str(e) or why
        with self._lock:
            # a fenced-out incarnation's reader exits SILENTLY: its
            # socket death says nothing about the current incarnation
            if self._epochs.get(pidx, 0) == epoch:
                self._dead[pidx] = why
                self._cv.notify_all()

    def await_phase(self, seq: int, phase: str,
                    timeout: float = 120.0) -> dict:
        """Block until EVERY worker acked ``(seq, phase)`` ok; returns
        ``{process_index: ack}``. Raises :class:`PodError` on a dead
        worker, a not-ok ack, or timeout."""
        deadline = time.monotonic() + timeout
        key = (int(seq), phase)
        with self._lock:
            # the key is popped on EVERY exit (success, dead worker,
            # timeout): an abandoned seq must not leave its partial
            # ack dict — worker `best` vectors included — in the
            # mailbox forever
            try:
                while True:
                    if self._dead:
                        pidx, why = next(iter(self._dead.items()))
                        raise PodError(f"pod worker {pidx} died: {why}")
                    got = self._acks.get(key, {})
                    if len(got) >= len(self._workers):
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise PodError(
                            f"pod: {len(got)}/{len(self._workers)} "
                            f"workers acked seq {seq} phase {phase!r} "
                            f"within {timeout}s"
                        )
                    self._cv.wait(left)
            finally:
                self._acks.pop(key, None)
        for pidx, msg in got.items():
            if not msg.get("ok", False):
                raise PodError(
                    f"pod worker {pidx} failed seq {seq} "
                    f"({phase}): {msg.get('error', 'unspecified')}"
                )
        return got

    # ---- failure domains --------------------------------------------
    @property
    def fenced_frames(self) -> int:
        """Stale-epoch frames dropped by the reader fence (zombie
        incarnations' late acks) — the soak's fence witness."""
        return self._fenced

    def worker_epoch(self, pidx: int) -> int:
        with self._lock:
            return int(self._epochs.get(int(pidx), 0))

    def dead_workers(self) -> dict:
        """``{process_index: reason}`` for every worker currently known
        dead — the supervisor's pod-heal input."""
        with self._lock:
            return dict(self._dead)

    def check_heartbeats(self) -> list:
        """Mark workers whose heartbeat went silent for longer than
        ``heartbeat_timeout_s`` as dead; returns the newly-dead
        process indexes. Only workers that have EVER heartbeat are
        judged (a worker spawned without ``heartbeat_s`` opted out),
        and a no-op when the primary was built without a timeout —
        so legacy pods keep their exact pre-heartbeat behavior."""
        if self._hb_timeout_s is None:
            return []
        now = time.monotonic()
        newly: list = []
        with self._lock:
            for pidx, last in list(self._last_hb.items()):
                if pidx in self._dead or pidx not in self._workers:
                    continue
                if now - last > self._hb_timeout_s:
                    self._dead[pidx] = (
                        f"heartbeat silent for {now - last:.1f}s"
                    )
                    newly.append(pidx)
            if newly:
                self._cv.notify_all()
        return newly

    def accept_rejoin(self, timeout_s: float = 30.0) -> int:
        """Admit ONE respawned worker back into the mesh: accept its
        connection, require a known process index at a STRICTLY higher
        epoch than the incarnation being replaced (the fence that
        keeps a zombie from re-admitting itself), swap the control
        socket, clear the death record, and flag the next launch to
        re-broadcast the graph through the existing chunk stream (the
        respawned process holds no graph). Returns the process index;
        raises :class:`PodError` past the timeout. The old incarnation's
        socket is deliberately LEFT OPEN: a zombie is by definition
        still alive, and closing its connection under it would discard
        its late acks unseen — instead its reader keeps draining them
        into the epoch fence (counted in :attr:`fenced_frames`) until
        the zombie's own EOF retires the reader silently, so the
        recovered incarnation is never re-marked dead by its
        predecessor's death."""
        deadline = time.monotonic() + timeout_s
        while True:
            if time.monotonic() >= deadline:
                raise PodError(
                    f"pod: no acceptable rejoin within {timeout_s}s"
                )
            self._listener.settimeout(
                max(0.1, deadline - time.monotonic())
            )
            try:
                sock, _addr = self._listener.accept()
            except (socket.timeout, OSError):
                raise PodError(
                    f"pod: no rejoin connection within {timeout_s}s"
                ) from None
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                hello = self._read_hello(sock, deadline)
            except PodError:
                sock.close()
                continue
            pidx = int(hello.get("process", -1))
            epoch = int(hello.get("epoch", 0))
            with self._lock:
                known = pidx in self._workers
                cur = self._epochs.get(pidx, 0)
            if pidx < 1 or not known or epoch <= cur:
                sock.close()
                continue
            with self._lock:
                self._workers[pidx] = sock
                self._epochs[pidx] = epoch
                self._dead.pop(pidx, None)
                self._last_hb.pop(pidx, None)
                self._regraph = True
                self._cv.notify_all()
            self._g_epoch.labels(
                pod=self._obs_label, worker=str(pidx)
            ).set(epoch)
            threading.Thread(
                target=self._reader, args=(pidx, sock, epoch),
                name=f"bibfs-pod-ack-{pidx}e{epoch}", daemon=True,
            ).start()
            return pidx

    # ---- broadcasts (engine-flusher thread only) ---------------------
    def _post(self, desc: dict) -> int:
        with self._lock:
            if self._closed:
                raise PodError("pod control plane is closed")
            if self._dead:
                pidx, why = next(iter(self._dead.items()))
                raise PodError(f"pod worker {pidx} died: {why}")
            self._seq += 1
            seq = self._seq
            workers = dict(self._workers)
        desc = dict(desc, seq=seq)
        try:
            data = encode_frame(desc)
        except ValueError as e:
            # the flusher's resilience ladder speaks PodError; a raw
            # encode ValueError would escape it
            raise PodError(f"pod descriptor encode failed: {e}") from e
        # single writer by construction (module docstring): sendall
        # happens OUTSIDE the lock, on the one broadcasting thread
        for pidx, sock in workers.items():
            try:
                sock.sendall(data)
            except OSError as e:
                with self._lock:
                    self._dead[pidx] = f"broadcast failed: {e}"
                    self._cv.notify_all()
                raise PodError(
                    f"pod worker {pidx}: broadcast failed: {e}"
                ) from e
        return seq

    def ensure_graph(self, snapshot, build=None,
                     timeout: float = 120.0):
        """Broadcast ``snapshot`` (canonical pairs + digest) if it is
        not the workers' current graph, run the primary's own ``build``
        callable, then await the workers' rebuild acks — in THAT order,
        because building the sharded graph (``jax.device_put`` onto the
        global mesh) is itself collective on the reference's
        multi-process backend: the primary building before the workers
        have the descriptor deadlocks in the transfer layer's rendezvous.
        A port shard is built without a collective, but the order is
        kept, so a caller written for either package holds. Returns
        ``build()``'s result. Flusher-thread only; the digest memo
        makes the steady-state cost one string compare per launch. A
        worker rejoin (:meth:`accept_rejoin`) voids the memo via the
        ``_regraph`` flag — the respawned incarnation holds no graph,
        so the next launch re-broadcasts even an unchanged digest."""
        with self._lock:
            regraph = self._regraph
        if not regraph and snapshot.digest == self._last_digest:
            return build() if build is not None else None
        seq = self.post_graph(snapshot)
        out = build() if build is not None else None
        self.await_phase(seq, "done", timeout)
        self._last_digest = snapshot.digest
        with self._lock:
            self._regraph = False
        return out

    def post_graph(self, snapshot) -> int:
        """Broadcast one graph descriptor as a chunked frame stream:
        a header frame (n/digest/version/chunk count) followed by that
        many ``graph_chunk`` frames of at most
        :data:`GRAPH_CHUNK_EDGES` edges each, keyed to the header by
        ``for`` — the frame bound is 1 MiB and realistic graphs are
        far bigger as JSON. Returns the header's seq (the one the
        workers ack ``done`` on after rebuilding)."""
        flat = np.asarray(snapshot.pairs, dtype=np.int64).ravel()
        step = 2 * GRAPH_CHUNK_EDGES
        chunks = [flat[i: i + step].tolist()
                  for i in range(0, len(flat), step)]
        seq = self._post({
            "op": "graph",
            "n": int(snapshot.n),
            "digest": snapshot.digest,
            "version": int(snapshot.version),
            "chunks": len(chunks),
        })
        with self._lock:
            self._graph_seq = seq
        for i, chunk in enumerate(chunks):
            self._post({
                "op": "graph_chunk", "for": seq, "i": i,
                "pairs": chunk,
            })
        return seq

    def post_solve(self, digest: str, mode: str, padded,
                   count: int, ctx=None) -> int:
        """Broadcast one padded solve batch; returns its seq. The
        caller awaits ``join`` before entering the collective and
        ``done`` (with per-worker ``best``) in finish. ``ctx`` is a
        sampled query's trace context: the broadcast span parents
        every worker's ``pod_worker_solve`` span, and the descriptor
        carries the context fields across the process boundary."""
        desc = {
            "op": "solve",
            "digest": digest,
            "mode": mode,
            "count": int(count),
            "pairs": np.asarray(padded, dtype=np.int64).ravel().tolist(),
        }
        if ctx is None:
            return self._post(desc)
        sp = dspan("pod_broadcast", ctx, count=int(count),
                   workers=self.num_workers)
        desc.update(ctx_fields(sp.ctx))
        try:
            return self._post(desc)
        finally:
            sp.finish()

    def commit_solve(self, seq: int) -> None:
        """Broadcast the ``go`` verdict for ``seq``: every worker
        acked ``join``, so every process (primary included) may enter
        the collective. Raises :class:`PodError` if a worker socket is
        gone mid-broadcast — the primary then aborts on-host without
        entering the collective (a worker that already got its ``go``
        is inside one short a participant, which is the dead-worker
        case the process group's timeout owns anyway)."""
        self._post({"op": "go", "for": int(seq)})

    def abort_solve(self, seq: int) -> None:
        """Best-effort ``abort`` verdict for ``seq`` after a failed
        join barrier: workers parked in their verdict wait skip the
        collective instead of entering it short the primary. Sends to
        every worker not known dead and never raises — the launch is
        already failing with its own :class:`PodError`."""
        with self._lock:
            if self._closed:
                return
            self._seq += 1
            vseq = self._seq
            workers = {p: s for p, s in self._workers.items()
                       if p not in self._dead}
        try:
            data = encode_frame(
                {"op": "abort", "for": int(seq), "seq": vseq}
            )
        except ValueError:
            return
        for pidx, sock in workers.items():
            try:
                sock.sendall(data)
            except OSError as e:
                with self._lock:
                    self._dead.setdefault(
                        pidx, f"broadcast failed: {e}"
                    )
                    self._cv.notify_all()

    # ---- lifecycle ---------------------------------------------------
    def shutdown(self, timeout: float = 30.0) -> None:
        """Broadcast shutdown and wait for the workers' goodbyes (best
        effort — a worker already gone is fine at this point)."""
        try:
            seq = self._post({"op": "shutdown"})
            self.await_phase(seq, "done", timeout)
        except PodError:
            pass
        self.close()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = dict(self._workers)
        for sock in workers.values():
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass


def _connect_retry(host: str, port: int, timeout_s: float):
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            return sock
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)


def _build_worker_graph(msg: dict, parts: list, mesh):
    """Rebuild the primary's sharded graph from a ``graph`` header and
    its reassembled ``graph_chunk`` pair lists: verify the content
    digest over the received pairs, then run the SAME snapshot ->
    bucketed ELL -> repad -> shard chain the engine runtime runs
    (``serve/engine._GraphRuntime.mesh_graph``) so shapes and content
    are bit-identical across processes.

    Port seam: the mesh's size is ``mesh.size`` (the reference's
    ``mesh.devices.size``), and the shard keeps this rank's rows only."""
    from bibfs_tpu_torch.serve.buckets import repad_rows
    from bibfs_tpu_torch.solvers.sharded import ShardedGraph
    from bibfs_tpu_torch.store.snapshot import GraphSnapshot, content_digest

    n = int(msg["n"])
    flat = (np.concatenate(
        [np.asarray(p, dtype=np.int64).ravel() for p in parts]
    ) if parts else np.zeros(0, dtype=np.int64))
    pairs = flat.reshape(-1, 2)
    digest = str(msg["digest"])
    got = content_digest(n, pairs)
    if got != digest:
        raise ValueError(
            f"pod graph digest mismatch: wire {digest} != rebuilt {got}"
        )
    snap = GraphSnapshot(n, pairs, digest=digest,
                         version=int(msg.get("version", 0)))
    ell = repad_rows(snap.ell(), int(mesh.size))
    return digest, ShardedGraph(ell, mesh)


def run_pod_worker(host: str, port: int, *, process_index: int,
                   connect_timeout_s: float = 120.0, log=None,
                   epoch: int = 0,
                   heartbeat_s: float | None = None) -> int:
    """The worker process's main loop (module docstring): connect to
    the primary's pod control port, then execute descriptors strictly
    in receipt order until ``shutdown`` (returns 0) or the primary
    closes the connection (returns 0 too — a vanished primary is a
    normal teardown, the process group owns crash detection).

    ``epoch`` is this incarnation's fencing identity: it rides the
    hello and every ack, so the primary can reject a previous
    incarnation's late frames after this worker rejoined at a higher
    epoch. ``heartbeat_s`` (None = off) starts a sender thread posting
    ``hb`` frames at that cadence — the primary's
    ``check_heartbeats`` marks this worker dead when they stop. The
    socket gains a second writer with heartbeats on, so sends
    serialize on a leaf write lock (the :class:`NetClient` pattern).

    Port seam: the process must have joined the job first
    (:func:`bibfs_tpu_torch.parallel.mesh.init_multihost`); the global
    mesh is :func:`~bibfs_tpu_torch.parallel.mesh.make_1d_mesh` over that
    group, on the device the join chose (the worker never picks the CPU
    itself), and the replicated ``best`` is read back with ``.cpu()``.
    """
    from bibfs_tpu_torch.parallel.mesh import make_1d_mesh
    from bibfs_tpu_torch.solvers import sharded as _sharded
    from bibfs_tpu_torch.solvers.timing import force_scalar

    def say(msg: str) -> None:
        if log is not None:
            log(msg)

    epoch = int(epoch)
    mesh = make_1d_mesh()  # the global mesh, spanning every process
    sock = _connect_retry(host, port, connect_timeout_s)
    wlock = threading.Lock()

    def send(data: bytes) -> None:
        with wlock:
            sock.sendall(data)

    send(encode_frame(
        {"op": "hello", "process": int(process_index), "epoch": epoch}
    ))
    say(f"[Pod] worker {process_index}: joined {host}:{port} "
        f"(epoch {epoch}, {mesh.size}-device global mesh)")
    hb_stop = threading.Event()
    if heartbeat_s is not None:
        def _hb_main() -> None:
            frame = encode_frame({
                "op": "hb", "process": int(process_index),
                "epoch": epoch,
            })
            while not hb_stop.wait(heartbeat_s):
                try:
                    send(frame)
                except OSError:
                    return

        threading.Thread(
            target=_hb_main,
            name=f"bibfs-pod-hb-{process_index}", daemon=True,
        ).start()
    graphs: dict = {}  # digest -> ShardedGraph (current only)
    buf = bytearray()
    pending: deque = deque()  # decoded frames not yet dispatched

    def next_msg() -> dict:
        while not pending:
            pending.extend(_recv_frames(sock, buf))
        return pending.popleft()

    def ack(seq, phase, ok, **extra):
        send(encode_frame(
            dict(extra, seq=seq, phase=phase, ok=ok, epoch=epoch)
        ))

    def await_verdict(seq: int) -> bool:
        """Park for the primary's commit/abort verdict on ``seq``
        (module docstring): True on ``go``, False on ``abort``.
        Verdicts for other seqs are stale (a late abort for a batch
        this worker already refused) and skipped. Any OTHER descriptor
        means the primary moved on without a verdict — impossible
        under the single-writer discipline, but a control-plane bug
        must degrade to a skipped batch, not a worker wedged inside a
        collective: push it back and treat the solve as aborted."""
        while True:
            m = next_msg()
            mop = m.get("op")
            if mop in ("go", "abort"):
                if int(m.get("for", -1)) == seq:
                    return mop == "go"
                continue
            pending.appendleft(m)
            return False

    try:
        while True:
            try:
                msg = next_msg()
            except (ConnectionError, ValueError):
                return 0
            op = msg.get("op")
            seq = int(msg.get("seq", -1))
            if op == "shutdown":
                ack(seq, "done", True)
                return 0
            if op in ("go", "abort"):
                # a verdict for a seq this worker already refused (or
                # never joined): stale, skip
                continue
            if op == "graph":
                nchunks = int(msg.get("chunks", 0))
                parts, bad = [], None
                for i in range(nchunks):
                    try:
                        m = next_msg()
                    except (ConnectionError, ValueError):
                        return 0
                    if (m.get("op") != "graph_chunk"
                            or int(m.get("for", -1)) != seq):
                        bad = (f"expected graph_chunk {i} for seq "
                               f"{seq}, got {m.get('op')!r}")
                        pending.appendleft(m)
                        break
                    parts.append(m.get("pairs", ()))
                if bad is not None:
                    ack(seq, "done", False, error=bad)
                    continue
                try:
                    digest, sg = _build_worker_graph(msg, parts, mesh)
                except (KeyError, TypeError, ValueError) as e:
                    ack(seq, "done", False, error=str(e))
                    continue
                graphs.clear()  # one served graph at a time
                graphs[digest] = sg
                ack(seq, "done", True, digest=digest)
                say(f"[Pod] worker {process_index}: graph "
                    f"{digest[:12]} n={sg.n}")
                continue
            if op == "solve":
                sg = graphs.get(str(msg.get("digest")))
                if sg is None:
                    # refuse BEFORE the join ack: the primary aborts
                    # on the host, nobody enters a collective short
                    # one participant
                    ack(seq, "join", False,
                        error="unknown graph digest "
                              f"{msg.get('digest')!r}")
                    continue
                try:
                    padded = np.asarray(
                        msg["pairs"], dtype=np.int64
                    ).reshape(-1, 2)
                    _p, dispatch = _sharded._batch_dispatch(
                        sg, padded, str(msg.get("mode", "sync"))
                    )
                except (KeyError, TypeError, ValueError) as e:
                    ack(seq, "join", False, error=str(e))
                    continue
                ack(seq, "join", True)
                try:
                    committed = await_verdict(seq)
                except (ConnectionError, ValueError):
                    return 0
                if not committed:
                    continue
                # sampled queries carry their trace context on the
                # descriptor: this worker's solve span lands in ITS
                # spool, parented by the primary's pod_broadcast span
                with dspan("pod_worker_solve", ctx_from_fields(msg),
                           worker=int(process_index),
                           count=int(msg.get("count", 0))):
                    out = dispatch()
                    force_scalar(out)
                # best/meet are REPLICATED outputs: the same on every
                # rank (the parent rows stay this rank's local ones)
                best = [int(b) for b in out[0].cpu()]
                ack(seq, "done", True, best=best)
                continue
            ack(seq, "done", False, error=f"unknown op {op!r}")
    finally:
        hb_stop.set()
        try:
            sock.close()
        except OSError:
            pass
