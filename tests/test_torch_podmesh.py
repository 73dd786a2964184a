"""The port's pod control plane (bibfs_tpu_torch/parallel/podmesh.py)
against the JAX package's on the CPU.

- Every case of the reference's ``tests/test_podmesh.py`` drives the
  reference's ``PodPrimary`` and the port's through one scripted sequence
  of fake workers on plain sockets. The frames each fake worker receives
  must be the same bytes, and so must the failure states: ``PodError``
  messages, ``dead_workers``, ``fenced_frames`` and ``worker_epoch``. A
  graph of more than 64 chunks is acked on the port's primary, where the
  reference's sweeps the ack (the port's seam).
- ``_build_worker_graph`` rebuilds the same digest and the same re-padded
  ELL from one chunk stream as the reference's.
- ``sharded._batch_dispatch`` answers as the reference's batch.
- ``init_multihost`` and ``init_distributed`` raise when unconfigured,
  take a card unless asked for the CPU, and raise without one.
- A real pod of processes (a primary and two workers, each a child that
  joins over ``tcp://127.0.0.1``) answers in four modes, refuses an
  unknown digest without entering a collective, swaps its graph, and
  fails a launch as ``PodError`` after a worker is killed, every child
  reaped.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bibfs_tpu_torch.serve.net import (
    MAX_FRAME_BYTES,
    encode_frame,
    extract_frames,
)

ROOT = Path(__file__).resolve().parent.parent


def _packages():
    from bibfs_tpu.obs import metrics as rm
    from bibfs_tpu.parallel import podmesh as rp
    from bibfs_tpu_torch.obs import metrics as pm
    from bibfs_tpu_torch.parallel import podmesh as pp

    return (SimpleNamespace(pod=rp, REGISTRY=rm.REGISTRY),
            SimpleNamespace(pod=pp, REGISTRY=pm.REGISTRY))


# ---- scripted workers ---------------------------------------------------

class _FakeWorker:
    """A worker's control socket driven from the test (the reference's
    ``_FakeWorker``), keeping the raw payload of every frame it receives."""

    def __init__(self, port: int, process_index: int = 1,
                 epoch: int | None = None):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.buf = bytearray()
        self.pending = deque()
        self.raw: list = []
        hello = {"op": "hello", "process": int(process_index)}
        if epoch is not None:
            hello["epoch"] = int(epoch)
        self.sock.sendall(encode_frame(hello))

    def _read(self) -> bool:
        data = self.sock.recv(1 << 16)
        if not data:
            return False
        self.buf += data
        for raw in extract_frames(self.buf):
            self.raw.append(bytes(raw))
            self.pending.append(json.loads(raw.decode()))
        return True

    def recv_msg(self, timeout: float = 10.0) -> dict:
        self.sock.settimeout(timeout)
        while not self.pending:
            assert self._read(), "primary closed the control connection"
        return self.pending.popleft()

    def ack(self, seq, phase, ok=True, **extra):
        self.sock.sendall(encode_frame(
            dict(extra, seq=seq, phase=phase, ok=ok)
        ))

    def drain(self) -> list:
        """Every frame received, once the primary is closed: read until EOF
        or a quiet loopback (a primary's ``close`` does not always reach a
        socket its reader thread still blocks on)."""
        if self.sock.fileno() < 0:
            return self.raw
        self.sock.settimeout(0.3)
        try:
            while self._read():
                pass
        except OSError:
            pass
        return self.raw

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class _Snap:
    """The four snapshot attributes post_graph/ensure_graph read."""

    def __init__(self, n, pairs, digest, version=1):
        self.n = n
        self.pairs = pairs
        self.digest = digest
        self.version = version


def _poll(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _masked(text: str) -> str:
    """A failure message with its measured seconds masked (a heartbeat's
    silence is read off the clock)."""
    return re.sub(r"silent for [0-9.]+s", "silent for <s>", str(text))


class _Run:
    """One scripted sequence against one package: its primary, its fake
    workers, and the record the two packages must share."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.mod = pkg.pod
        self.primaries: list = []
        self.workers: list = []
        self.rec: list = []

    def primary(self, num_workers, **kw):
        p = self.mod.PodPrimary(num_workers, host="127.0.0.1", **kw)
        self.primaries.append(p)
        return p

    def worker(self, port, pidx=1, epoch=None):
        fw = _FakeWorker(port, pidx, epoch)
        self.workers.append(fw)
        return fw

    def pod(self, num_workers):
        primary = self.primary(num_workers)
        workers = [self.worker(primary.port, i + 1)
                   for i in range(num_workers)]
        primary.accept_workers()
        return primary, workers

    def note(self, *what):
        self.rec.append(what)

    def raises(self, fn, match):
        with pytest.raises(self.mod.PodError, match=match) as e:
            fn()
        self.note("PodError", _masked(e.value))

    def state(self, primary):
        pidx = sorted(primary._workers) or [1]
        self.note("state", {k: _masked(v)
                            for k, v in primary.dead_workers().items()},
                  primary.fenced_frames,
                  {p: primary.worker_epoch(p) for p in pidx})

    def finish(self) -> list:
        for p in self.primaries:
            self.state(p)
            p.close()
        frames = [fw.drain() for fw in self.workers]
        for fw in self.workers:
            fw.close()
        return self.rec + [("frames", frames)]


def _parity(scenario):
    """Run ``scenario`` against both packages; the records must be equal."""
    ref, port = _packages()
    out = []
    for pkg in (ref, port):
        run = _Run(pkg)
        try:
            scenario(run)
        finally:
            out.append(run.finish())
    assert out[1] == out[0]
    return out[1]


# ---- the reference's cases, on both primaries ---------------------------

def _graph_broadcast(run):
    mod = run.mod
    rng = np.random.default_rng(7)
    pairs = rng.integers(10**11, 10**12, size=(3 * mod.GRAPH_CHUNK_EDGES
                                               + 123, 2), dtype=np.int64)
    assert len(json.dumps(pairs.ravel().tolist())) > MAX_FRAME_BYTES
    snap = _Snap(n=10**12, pairs=pairs, digest="d" * 16, version=3)
    primary, (fw,) = run.pod(1)
    got = {}

    def worker_main():
        header = fw.recv_msg()
        flat = []
        for i in range(header["chunks"]):
            c = fw.recv_msg()
            assert c["op"] == "graph_chunk"
            assert c["for"] == header["seq"]
            assert c["i"] == i
            flat.extend(c["pairs"])
        got["header"] = header
        got["flat"] = flat
        fw.ack(header["seq"], "done", True, digest=header["digest"])

    t = threading.Thread(target=worker_main, daemon=True)
    t.start()
    out = primary.ensure_graph(snap, build=lambda: "built", timeout=30.0)
    assert out == "built"
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert got["header"]["op"] == "graph"
    assert got["header"]["digest"] == snap.digest
    assert got["header"]["chunks"] == 4
    assert got["flat"] == pairs.ravel().tolist()
    assert primary.ensure_graph(snap, build=lambda: "again",
                                timeout=1.0) == "again"
    run.note("header", got["header"])


def test_graph_broadcast_chunked_past_frame_bound():
    _parity(_graph_broadcast)


def _join_then_go(run):
    primary, (fw,) = run.pod(1)
    padded = np.zeros((4, 2), dtype=np.int64)
    seq = primary.post_solve("d" * 16, "sync", padded, 4)
    msg = fw.recv_msg()
    assert msg["op"] == "solve" and msg["seq"] == seq
    fw.ack(seq, "join", True)
    run.note("join", primary.await_phase(seq, "join", timeout=10.0))
    primary.commit_solve(seq)
    verdict = fw.recv_msg()
    assert verdict["op"] == "go" and verdict["for"] == seq


def test_solve_join_then_go_verdict():
    _parity(_join_then_go)


def _refused_join(run):
    primary, (fw1, fw2) = run.pod(2)
    padded = np.zeros((4, 2), dtype=np.int64)
    seq = primary.post_solve("d" * 16, "sync", padded, 4)
    assert fw1.recv_msg()["op"] == "solve"
    assert fw2.recv_msg()["op"] == "solve"
    fw1.ack(seq, "join", False, error="digest mismatch")
    fw2.ack(seq, "join", True)
    run.raises(lambda: primary.await_phase(seq, "join", timeout=10.0),
               "digest mismatch")
    primary.abort_solve(seq)
    for fw in (fw1, fw2):
        verdict = fw.recv_msg()
        assert verdict["op"] == "abort" and verdict["for"] == seq


def test_refused_join_aborts_parked_workers():
    _parity(_refused_join)


def _join_timeout(run):
    primary, (fw1, fw2) = run.pod(2)
    padded = np.zeros((4, 2), dtype=np.int64)
    seq = primary.post_solve("d" * 16, "sync", padded, 4)
    fw1.ack(seq, "join", True)  # fw2 stays silent
    assert _poll(lambda: (seq, "join") in primary._acks)
    run.raises(lambda: primary.await_phase(seq, "join", timeout=0.4), "1/2")
    with primary._lock:
        assert (seq, "join") not in primary._acks
    primary.abort_solve(seq)
    fw1.recv_msg()  # the solve descriptor
    verdict = fw1.recv_msg()
    assert verdict["op"] == "abort" and verdict["for"] == seq


def test_join_timeout_aborts_and_leaves_no_ack_residue():
    _parity(_join_timeout)


def _sweeps_stale_acks(run):
    primary, (fw,) = run.pod(1)
    with primary._lock:
        primary._acks[(1, "join")] = {1: {"ok": True}}
        primary._seq = 100
    fw.ack(99, "done", True)
    assert _poll(lambda: (99, "done") in primary._acks)
    with primary._lock:
        assert (1, "join") not in primary._acks
        run.note("mailbox", sorted(primary._acks))


def test_reader_sweeps_stale_acks():
    _parity(_sweeps_stale_acks)


def _stale_epoch_fenced(run):
    primary, (fw_a,) = run.pod(1)
    fw_b = run.worker(primary.port, 1, epoch=1)
    assert primary.accept_rejoin(timeout_s=10.0) == 1
    assert primary.worker_epoch(1) == 1
    padded = np.zeros((4, 2), dtype=np.int64)
    seq = primary.post_solve("d" * 16, "sync", padded, 4)
    assert fw_b.recv_msg()["op"] == "solve"
    before = primary.fenced_frames
    fw_a.ack(seq, "join", epoch=0)   # the zombie's late ack
    fw_a.ack(seq, "join")            # epoch-less: same fate
    assert _poll(lambda: primary.fenced_frames >= before + 2)
    with primary._lock:
        assert (seq, "join") not in primary._acks
    fw_b.ack(seq, "join", epoch=1)
    got = primary.await_phase(seq, "join", timeout=10.0)
    assert got[1]["epoch"] == 1
    run.note("join", got)
    fw_a.close()
    time.sleep(0.3)
    assert primary.dead_workers() == {}
    run.state(primary)


def test_stale_epoch_ack_is_fenced_and_mailbox_stays_clean():
    _parity(_stale_epoch_fenced)


def _rejoin_rejects(run):
    primary, (_fw_a,) = run.pod(1)
    run.worker(primary.port, 1, epoch=0)   # a zombie: not higher
    run.worker(primary.port, 7, epoch=3)   # never joined
    run.raises(lambda: primary.accept_rejoin(timeout_s=0.8), "rejoin")
    assert primary.worker_epoch(1) == 0


def test_rejoin_rejects_stale_or_unknown_incarnations():
    _parity(_rejoin_rejects)


def _heartbeat_loss(run):
    primary = run.primary(1, heartbeat_timeout_s=0.3)
    fw = run.worker(primary.port, 1)
    primary.accept_workers()
    fw.sock.sendall(encode_frame({"op": "hb"}))
    assert _poll(lambda: 1 in primary._last_hb)
    with primary._lock:
        assert not primary._acks  # hb never enters the mailbox
    run.note("fresh", primary.check_heartbeats())
    padded = np.zeros((4, 2), dtype=np.int64)
    seq = primary.post_solve("d" * 16, "sync", padded, 4)
    time.sleep(0.45)  # silence past the timeout
    run.note("silent", primary.check_heartbeats())
    run.state(primary)
    run.raises(lambda: primary.await_phase(seq, "join", timeout=5.0), "died")
    run.raises(lambda: primary.post_solve("d" * 16, "sync", padded, 4),
               "died")


def test_heartbeat_loss_marks_dead_and_aborts_prelaunch():
    _parity(_heartbeat_loss)


def _rejoin_voids_memo(run):
    pairs = np.array([[i, i + 1] for i in range(9)], dtype=np.int64)
    snap = _Snap(n=10, pairs=pairs, digest="g" * 16, version=1)
    primary, (fw_a,) = run.pod(1)

    def serve_graph(fw, epoch):
        header = fw.recv_msg()
        assert header["op"] == "graph"
        for _ in range(header["chunks"]):
            assert fw.recv_msg()["op"] == "graph_chunk"
        fw.ack(header["seq"], "done", True, digest=header["digest"],
               epoch=epoch)

    t = threading.Thread(target=serve_graph, args=(fw_a, 0), daemon=True)
    t.start()
    assert primary.ensure_graph(snap, build=lambda: 1, timeout=10.0) == 1
    t.join(timeout=10.0)
    assert primary.ensure_graph(snap, build=lambda: 2, timeout=1.0) == 2
    fw_b = run.worker(primary.port, 1, epoch=1)
    assert primary.accept_rejoin(timeout_s=10.0) == 1
    t2 = threading.Thread(target=serve_graph, args=(fw_b, 1), daemon=True)
    t2.start()
    assert primary.ensure_graph(snap, build=lambda: 3, timeout=10.0) == 3
    t2.join(timeout=10.0)
    assert not t2.is_alive()  # the rebroadcast actually happened


def test_rejoin_voids_graph_memo_and_rebroadcasts():
    _parity(_rejoin_voids_memo)


def _epoch_gauge(run):
    primary, (_fw,) = run.pod(1)
    label = primary._obs_label
    lines = [line.replace(f'"{label}"', '"<pod>"')
             for line in run.pkg.REGISTRY.render().splitlines()
             if "bibfs_pod_worker_epoch" in line
             and (line.startswith("#") or f'"{label}"' in line)]
    assert any(line.startswith("bibfs_pod_worker_epoch{") for line in lines)
    run.note("render", lines)


def test_epoch_gauge_renders():
    _parity(_epoch_gauge)


def _oversize(run):
    primary, (_fw,) = run.pod(1)
    huge = np.full((MAX_FRAME_BYTES // 8, 2), 10**15, dtype=np.int64)
    run.raises(lambda: primary.post_solve("d" * 16, "sync", huge, len(huge)),
               "encode")


def test_oversize_descriptor_raises_poderror():
    _parity(_oversize)


def test_graph_of_more_than_64_chunks_is_acked(monkeypatch):
    """A graph broadcast of more than 64 chunks: the worker can ack the
    header only after the last chunk, more than 64 seqs later. The
    reference's reader sweeps that ack as stale on arrival, so its
    ``ensure_graph`` times out with the worker rebuilt; the port keeps
    the last graph header's acks out of the sweep (its seam) and sends
    the same frames."""
    pairs = np.array([[i, i + 1] for i in range(150)], dtype=np.int64)
    snap = _Snap(n=151, pairs=pairs, digest="c" * 16)
    out = []
    for pkg in _packages():
        monkeypatch.setattr(pkg.pod, "GRAPH_CHUNK_EDGES", 2)  # 75 chunks
        run = _Run(pkg)
        try:
            primary, (fw,) = run.pod(1)

            def worker_main(fw=fw):
                header = fw.recv_msg()
                for _ in range(header["chunks"]):
                    fw.recv_msg()
                fw.ack(header["seq"], "done", True, digest=header["digest"])

            t = threading.Thread(target=worker_main, daemon=True)
            t.start()
            try:
                out.append(primary.ensure_graph(snap, build=lambda: "built",
                                                timeout=2.0))
            except pkg.pod.PodError as e:
                out.append(str(e))
            t.join(timeout=10.0)
            assert not t.is_alive()
        finally:
            out.append(run.finish()[-1])
    ref_out, ref_frames, port_out, port_frames = out
    assert port_frames == ref_frames
    assert len(port_frames[1][0]) == 1 + 75
    assert "0/1 workers acked seq 1 phase 'done'" in ref_out
    assert port_out == "built"


# ---- the worker's graph, the batch seam, the join -----------------------

def _chunk_stream(n, pairs, step=2 * 37):
    from bibfs_tpu_torch.store.snapshot import content_digest

    flat = pairs.ravel().tolist()
    parts = [flat[i:i + step] for i in range(0, len(flat), step)]
    return {"n": n, "digest": content_digest(n, pairs), "version": 4}, parts


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_build_worker_graph_equals_reference(ndev):
    """One chunk stream rebuilds the same digest and the same re-padded
    host ELL (rows, degrees, ``n_pad``) in both packages: the port's shards
    of every rank put together equal the reference's global arrays. A
    digest that does not match the pairs raises ``ValueError`` in both."""
    from bibfs_tpu.parallel.mesh import make_1d_mesh as ref_mesh
    from bibfs_tpu.parallel.podmesh import _build_worker_graph as ref_build
    from bibfs_tpu_torch.graph.csr import canonical_pairs
    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.parallel.mesh import Mesh
    from bibfs_tpu_torch.parallel.podmesh import _build_worker_graph

    n = 301
    pairs = canonical_pairs(n, gnp_random_graph(n, 4.0 / n, seed=31))
    msg, parts = _chunk_stream(n, pairs)
    want_digest, want = ref_build(msg, parts, ref_mesh(ndev))
    shards = [_build_worker_graph(msg, parts, Mesh(r, ndev, "cpu", "gloo"))
              for r in range(ndev)]
    assert {d for d, _ in shards} == {want_digest} == {msg["digest"]}
    got = [sg for _, sg in shards]
    assert {(sg.n, sg.n_pad, sg.width) for sg in got} == {
        (want.n, want.n_pad, want.width)}
    assert want.n_pad % ndev == 0
    np.testing.assert_array_equal(
        np.concatenate([sg.nbr.numpy() for sg in got]), np.asarray(want.nbr))
    np.testing.assert_array_equal(
        np.concatenate([sg.deg.numpy() for sg in got]), np.asarray(want.deg))
    bad = dict(msg, digest="0" * 32)
    with pytest.raises(ValueError, match="digest mismatch"):
        ref_build(bad, parts, ref_mesh(ndev))
    with pytest.raises(ValueError, match="digest mismatch"):
        _build_worker_graph(bad, parts, Mesh(0, ndev, "cpu", "gloo"))


@pytest.mark.parametrize("mode", ["sync", "pallas", "pallas_alt", "fused"])
def test_batch_dispatch_equals_reference_batch(mode):
    """The batch seam on a one-rank mesh: its replicated fields equal the
    reference's ``solve_batch_sharded_graph`` on its 8-device mesh, its
    parent rows are the rank's local rows, and a pair out of range raises
    before anything runs."""
    from bibfs_tpu.parallel.mesh import make_1d_mesh as ref_mesh
    from bibfs_tpu.solvers.sharded import ShardedGraph as RefSharded
    from bibfs_tpu.solvers.sharded import solve_batch_sharded_graph
    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.parallel.mesh import Mesh
    from bibfs_tpu_torch.solvers import sharded as sh
    from bibfs_tpu_torch.solvers.dense import INF32

    n = 160
    edges = gnp_random_graph(n, 3.0 / n, seed=13)
    rng = np.random.default_rng(17)
    pairs = np.concatenate([rng.integers(0, n, size=(6, 2)),
                            [[5, 5], [0, n - 1]]])
    g = sh.ShardedGraph.build(n, edges, Mesh(0, 1, "cpu", "gloo"))
    got_pairs, thunk = sh._batch_dispatch(g, pairs, mode)
    np.testing.assert_array_equal(got_pairs, pairs)
    best, meet, par_s, par_t, levels, edges_scanned = thunk()
    assert tuple(par_s.shape) == tuple(par_t.shape) == (len(pairs), g.n_loc)
    want = solve_batch_sharded_graph(
        RefSharded.build(n, edges, ref_mesh(8)), pairs, mode=mode)
    found = [int(b) < INF32 for b in best]
    assert [int(b) if f else None for b, f in zip(best, found)] == [
        r.hops for r in want]
    assert [int(m) if f else None for m, f in zip(meet, found)] == [
        r.meet for r in want]
    assert [(int(a), int(b)) for a, b in zip(levels, edges_scanned)] == [
        (r.levels, r.edges_scanned) for r in want]
    # the port's batch, materialized a query at a time through ``each``
    single = sh.solve_batch_sharded_graph(g, pairs, mode=mode)
    assert [(r.hops, r.meet, r.levels, r.edges_scanned) for r in single] == [
        (r.hops, r.meet, r.levels, r.edges_scanned) for r in want]
    assert {r.mode for r in single} == {mode}
    assert all(r.host_syncs >= 1 for r in single)
    with pytest.raises(ValueError, match="out of range"):
        sh._batch_dispatch(g, [[0, n]], mode)


def test_init_multihost_fails_fast_unconfigured():
    """The port's counterpart of the reference's
    ``tests/test_harness.py::test_init_multihost_fails_fast_unconfigured``:
    a bare call raises at once; ``auto=True`` (JAX's cluster detection)
    is not ported and says so."""
    from bibfs_tpu_torch.parallel.mesh import init_multihost

    with pytest.raises(ValueError, match="coordinator_address"):
        init_multihost()
    with pytest.raises(ValueError, match="coordinator_address"):
        init_multihost("tcp://127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="auto"):
        init_multihost(auto=True)


class _Stop(Exception):
    pass


def _fake_join(monkeypatch, cards: int) -> dict:
    """Patch the card count and stop the join at ``init_process_group``,
    recording the card made current and the group's arguments."""
    import torch

    from bibfs_tpu_torch.parallel import mesh as m

    seen: dict = {}
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("card", str(d)))

    def init(backend, **kw):
        seen.update(backend=backend, **kw)
        raise _Stop

    monkeypatch.setattr(m.dist, "init_process_group", init)
    return seen


@pytest.mark.parametrize("cards,pid,card,backend", [
    (4, 3, "cuda:3", "nccl"),   # a card each
    (1, 2, "cuda:0", "gloo"),   # one shared card: staged gloo
    (2, 3, "cuda:1", "gloo"),   # fewer cards than processes
])
def test_init_distributed_takes_a_card_by_default(monkeypatch, cards, pid,
                                                  card, backend):
    """``device=None`` places process ``pid`` of 4 on card ``pid % cards``:
    NCCL when each process has its own, staged gloo when they share; the
    same through ``init_multihost``, which reads a bare ``host:port`` as
    ``tcp://``."""
    from bibfs_tpu_torch.parallel.mesh import (
        init_distributed,
        init_multihost,
        process_placement,
    )

    for join in (lambda: init_distributed("tcp://127.0.0.1:9", 4, pid),
                 lambda: init_multihost("127.0.0.1:9", 4, pid)):
        seen = _fake_join(monkeypatch, cards)
        assert process_placement(4, pid) == (card, backend,
                                              backend == "gloo")
        with pytest.raises(_Stop):
            join()
        assert seen["card"] == card and seen["backend"] == backend
        assert seen["init_method"] == "tcp://127.0.0.1:9"
        assert seen["world_size"] == 4 and seen["rank"] == pid
        assert ("device_id" in seen) == (backend == "nccl")


@pytest.mark.parametrize("procs,local,env,cards,pid,card,backend", [
    (8, 4, None, 4, 5, "cuda:1", "nccl"),   # two hosts of four cards
    (8, None, "4", 4, 6, "cuda:2", "nccl"),  # the same, from the launcher
    (4, 1, None, 1, 3, "cuda:0", "nccl"),   # one card on each of 4 hosts
    (8, 2, None, 1, 3, "cuda:0", "gloo"),   # two processes share a card
    (8, None, None, 4, 5, "cuda:1", "gloo"),  # unsaid: all on this host
])
def test_init_distributed_counts_this_hosts_processes(
        monkeypatch, procs, local, env, cards, pid, card, backend):
    """A job that spans hosts: NCCL when the processes on this host
    (``local_processes``, else ``LOCAL_WORLD_SIZE``, else the whole job)
    have a card each, staged gloo when they share one; the same through
    ``init_multihost``."""
    from bibfs_tpu_torch.parallel.mesh import (
        init_distributed,
        init_multihost,
        process_placement,
    )

    for join in (
            lambda: init_distributed("tcp://127.0.0.1:9", procs, pid,
                                     local_processes=local),
            lambda: init_multihost("127.0.0.1:9", procs, pid,
                                   local_processes=local)):
        seen = _fake_join(monkeypatch, cards)
        if env is not None:
            monkeypatch.setenv("LOCAL_WORLD_SIZE", env)
        assert process_placement(procs, pid, local) == (card, backend,
                                                         backend == "gloo")
        with pytest.raises(_Stop):
            join()
        assert seen["card"] == card and seen["backend"] == backend
        assert seen["world_size"] == procs and seen["rank"] == pid
        assert ("device_id" in seen) == (backend == "nccl")


def test_init_distributed_without_a_card_raises(monkeypatch):
    """With no card, ``device=None`` raises before any rendezvous; the host
    is used only when asked for, over gloo with no card made current."""
    from bibfs_tpu_torch.parallel.mesh import init_distributed, init_multihost

    seen = _fake_join(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_distributed("tcp://127.0.0.1:9", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_multihost("127.0.0.1:9", 2, 1)
    assert seen == {}
    with pytest.raises(_Stop):
        init_multihost("127.0.0.1:9", 2, 1, device="cpu")
    assert seen["backend"] == "gloo" and "card" not in seen


# ---- a real pod of processes ---------------------------------------------

POD_MODES = ("sync", "pallas", "pallas_alt", "fused")

WORKER = """
import json, os, sys
from bibfs_tpu_torch.parallel.mesh import init_multihost
from bibfs_tpu_torch.parallel.podmesh import run_pod_worker

idx = init_multihost("127.0.0.1:{coord}", {procs}, {pid}, device="cpu",
                     timeout_s=60)
rc = run_pod_worker("127.0.0.1", {pod_port}, process_index=idx,
                    connect_timeout_s=60, heartbeat_s=0.5,
                    log=lambda m: print(m, flush=True))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bibfs_tpu"))
print("POD_WORKER " + json.dumps({{"worker": idx, "rc": rc, "bad": bad}}),
      flush=True)
os._exit(rc)
"""

PRIMARY = """
import json, os, signal, sys, time
import numpy as np
from bibfs_tpu_torch.graph.csr import canonical_pairs
from bibfs_tpu_torch.parallel.mesh import init_multihost, make_1d_mesh
from bibfs_tpu_torch.parallel.podmesh import PodError, PodPrimary
from bibfs_tpu_torch.serve.buckets import repad_rows
from bibfs_tpu_torch.solvers import sharded as sh
from bibfs_tpu_torch.store.snapshot import GraphSnapshot

args = json.loads(sys.argv[1])
pod = PodPrimary(args["workers"], host="127.0.0.1", accept_timeout_s=60,
                 heartbeat_timeout_s=30)
print("POD_PORT", pod.port, flush=True)
init_multihost("127.0.0.1:%d" % args["coord"], args["workers"] + 1, 0,
               device="cpu", timeout_s=60)
mesh = make_1d_mesh()
pod.accept_workers()
out = {"transport": mesh.transport, "epochs":
       [pod.worker_epoch(p) for p in range(1, args["workers"] + 1)]}


def graph(snap):
    return pod.ensure_graph(snap, build=lambda: sh.ShardedGraph(
        repad_rows(snap.ell(), mesh.size), mesh), timeout=60)


def solve(sg, digest, mode, pairs):
    pairs = np.asarray(pairs, dtype=np.int64)
    seq = pod.post_solve(digest, mode, pairs, len(pairs))
    try:
        pod.await_phase(seq, "join", 60)
    except PodError:
        pod.abort_solve(seq)
        raise
    pod.commit_solve(seq)
    _p, thunk = sh._batch_dispatch(sg, pairs, mode)
    best = [int(b) for b in thunk()[0].cpu()]
    acks = pod.await_phase(seq, "done", 60)
    return {"best": best,
            "workers": {str(p): a["best"] for p, a in sorted(acks.items())}}


n = args["n"]
edges = np.load(args["edges"])
snap = GraphSnapshot.build(n, edges)
sg = graph(snap)
out["solve"] = {m: solve(sg, snap.digest, m, args["pairs"])
                for m in args["modes"]}
try:
    solve(sg, "0" * 32, "sync", args["pairs"][:2])
    out["refused"] = None
except PodError as e:
    out["refused"] = str(e)
out["after_refusal"] = solve(sg, snap.digest, "sync", args["pairs"][:4])
swapped = np.concatenate([edges, [args["swap_edge"]]])
snap2 = GraphSnapshot.build(n, swapped)
sg2 = graph(snap2)
out["swap"] = solve(sg2, snap2.digest, "fused", [args["swap_edge"]])
with open(args["victim"]) as f:  # the last worker's pid
    os.kill(int(f.read()), signal.SIGKILL)
t0 = time.monotonic()
try:
    solve(sg2, snap2.digest, "sync", args["pairs"][:2])
    out["death"] = None
except PodError as e:
    out["death"] = str(e)
out["notice_s"] = time.monotonic() - t0
pod.shutdown(timeout=20)
print("POD_RESULT " + json.dumps(out), flush=True)
os._exit(0)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child(code: str, *argv) -> subprocess.Popen:
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
           "OMP_NUM_THREADS": "1", "HOME": os.environ.get("HOME", "/tmp"),
           "TMPDIR": os.environ.get("TMPDIR", "/tmp")}
    return subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start_pod(tmp_path, n, edges, pairs, swap_edge, workers=2):
    """Start the primary, read its control port, then the workers; retry
    with fresh ports if the rendezvous port was taken meanwhile."""
    np.save(tmp_path / "edges.npy", edges)
    victim = tmp_path / "victim"
    for _attempt in range(3):
        coord = _free_port()
        # the workers' pids are known only once they run, so the primary
        # reads its victim's from a file after the solves
        primary = _child(PRIMARY, json.dumps(dict(
            n=n, edges=str(tmp_path / "edges.npy"), pairs=pairs,
            modes=list(POD_MODES), swap_edge=swap_edge, workers=workers,
            coord=coord, victim=str(victim))))
        line = primary.stdout.readline()
        if not line.startswith("POD_PORT"):
            out = line + primary.communicate(timeout=30)[0]
            if "address already in use" in out.lower():
                continue
            raise AssertionError(f"primary did not start:\n{out[-2000:]}")
        pod_port = int(line.split()[1])
        kids = [_child(WORKER.format(coord=coord, procs=workers + 1, pid=pid,
                                     pod_port=pod_port))
                for pid in range(1, workers + 1)]
        victim.write_text(str(kids[-1].pid))
        return primary, kids
    raise AssertionError("no free rendezvous port in 3 attempts")


def test_real_pod_of_processes_answers_and_fails_on_the_host(tmp_path):
    """One primary and two workers, each a child joined over gloo and
    ``tcp://127.0.0.1`` (G(160, 3/160), seed 13, the graph of the
    reference's ``tests/test_multihost.py``): every mode's ``best`` is the
    same on every process and equals the reference's sharded batch on its
    8-device mesh and the serial oracle; an unknown digest is refused at
    the join and the next solve answers; a swapped snapshot is
    re-broadcast and answers on the new graph; a worker killed before a
    launch fails it as ``PodError``; every child exits."""
    from bibfs_tpu.graph.generate import gnp_random_graph
    from bibfs_tpu.parallel.mesh import make_1d_mesh
    from bibfs_tpu.solvers.serial import solve_serial
    from bibfs_tpu.solvers.sharded import ShardedGraph, solve_batch_sharded_graph

    n = 160
    edges = gnp_random_graph(n, 3.0 / n, seed=13)
    rng = np.random.default_rng(13)
    pairs = [[0, 159], [7, 7]] + rng.integers(0, n, size=(6, 2)).tolist()
    far = max(range(1, n), key=lambda v: solve_serial(n, edges, 0, v).hops
              or -1)
    swap_edge = [0, far]
    primary, kids = _start_pod(tmp_path, n, edges, pairs, swap_edge)
    procs = [primary] + kids
    try:
        # the reference's answers while the children start
        g = ShardedGraph.build(n, edges, make_1d_mesh(8))
        want = {m: [r.hops for r in solve_batch_sharded_graph(
            g, np.asarray(pairs), mode=m)] for m in POD_MODES}
        oracle = [solve_serial(n, edges, s, d).hops for s, d in pairs]
        outs = [p.communicate(timeout=90)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert primary.returncode == 0, outs[0][-3000:]
    res = [line for line in outs[0].splitlines()
           if line.startswith("POD_RESULT ")]
    assert res, outs[0][-3000:]
    out = json.loads(res[-1].split(" ", 1)[1])
    assert out["transport"] == "gloo" and out["epochs"] == [0, 0]
    inf = 1 << 30
    for mode in POD_MODES:
        best = out["solve"][mode]["best"]
        assert [b if b < inf else None for b in best] == want[mode] == oracle
        assert out["solve"][mode]["workers"] == {"1": best, "2": best}
    assert "unknown graph digest" in out["refused"]
    assert out["after_refusal"]["best"] == out["solve"]["sync"]["best"][:4]
    assert out["after_refusal"]["workers"] == {
        "1": out["after_refusal"]["best"], "2": out["after_refusal"]["best"]}
    assert out["swap"]["best"] == [1] and out["swap"]["workers"]["1"] == [1]
    assert "pod worker 2" in out["death"]
    assert out["notice_s"] < 30
    # the survivor answered the shutdown and exited 0; the victim was killed
    assert kids[0].returncode == 0, outs[1][-3000:]
    assert kids[1].returncode == -signal.SIGKILL
    done = [json.loads(line.split(" ", 1)[1]) for line in outs[1].splitlines()
            if line.startswith("POD_WORKER ")]
    assert done == [{"worker": 1, "rc": 0, "bad": []}]
