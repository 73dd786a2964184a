"""The PyTorch port's network front door (``bibfs_tpu_torch.serve.net``)
against ``bibfs_tpu.serve.net`` on the CPU, exactly: the frame codec's
bytes and its partial-feed splits, ``FrameError`` on the same prefixes,
port files and token buckets across the packages; then one seeded query
stream, every control op (``analytics`` included), the error taxonomy,
capacity and quota refusals, deadline misses, drain and the brownout
rungs through both packages' ``NetServer`` s over CPU pipelined engines
on the same graph, reply dict for reply dict (the server clock stamps
``rx`` / ``stx`` and timings excepted); the wire across the packages
(either client against either server); the ``bibfs_net_*`` families at
zero; and ``bibfs-torch-serve --port 0`` as a child process.

Host code throughout, so every comparison is exact. Every wait has a
timeout."""

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

N = 400
WAIT_S = 30.0


def _skiplink_graph(n: int) -> np.ndarray:
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


EDGES = _skiplink_graph(N)


def _fresh_pairs():
    """Pairs the engines cannot answer inline from a cache: distinct
    sources, distinct destinations, no shared endpoint."""
    return iter((s, s + 7 * k) for k in range(1, 50)
                for s in range(0, N - 7 * k, 11))


def _pkgs():
    """(reference, port) modules: net, pipeline engine, resilience."""
    from bibfs_tpu.serve import net as rnet
    from bibfs_tpu.serve.pipeline import PipelinedQueryEngine as RPipe
    from bibfs_tpu_torch.serve import net as pnet
    from bibfs_tpu_torch.serve.pipeline import PipelinedQueryEngine as PPipe

    def rengine(**kw):
        return RPipe(N, EDGES, **kw)

    def pengine(**kw):
        return PPipe(N, EDGES, device="cpu", **kw)

    return (rnet, rengine), (pnet, pengine)


class _Raw:
    """A bare framed connection: send frames, collect replies by id (the
    exact dicts a server wrote)."""

    def __init__(self, net, server):
        self.net = net
        self.sock = socket.create_connection((server.host, server.port))
        self.sock.settimeout(WAIT_S)
        self.buf = bytearray()

    def send(self, frame) -> None:
        self.sock.sendall(self.net.encode_frame(frame))

    def send_raw(self, payload: bytes) -> None:
        self.sock.sendall(struct.pack(">I", len(payload)) + payload)

    def recv(self, k: int) -> list:
        out = []
        while len(out) < k:
            data = self.sock.recv(1 << 16)
            assert data, "server closed the connection"
            self.buf += data
            out += [json.loads(r.decode())
                    for r in self.net.extract_frames(self.buf)]
        return out

    def close(self) -> None:
        self.sock.close()


def _strip(reply: dict) -> dict:
    return {k: v for k, v in reply.items() if k not in ("rx", "stx")}


def _by_id(replies) -> dict:
    return {json.dumps(r.get("id")): _strip(r) for r in replies}


# ---- codec ------------------------------------------------------------

FRAMES = [
    {"op": "ping", "id": 0},
    {"op": "query", "id": 7, "src": 3, "dst": 250, "deadline_ms": 5.0},
    {"op": "query", "id": "x", "src": 0, "dst": 1, "tenant": "t",
     "kind": "kshortest", "trace": "ab" * 16, "span": "cd" * 8},
    {"op": "roll", "id": 9, "adds": [[0, 1], [2, 3]], "dels": []},
    {"op": "stats", "id": None, "unicode": "é中"},
    {},
]


def test_encode_frame_same_bytes():
    (rnet, _), (pnet, _) = _pkgs()
    for f in FRAMES:
        assert pnet.encode_frame(f) == rnet.encode_frame(f)
    assert pnet.MAX_FRAME_BYTES == rnet.MAX_FRAME_BYTES
    assert pnet.CONTROL_OPS == rnet.CONTROL_OPS
    assert pnet.REJECT_REASONS == rnet.REJECT_REASONS
    assert pnet.SHED_REASONS == rnet.SHED_REASONS
    for net in (rnet, pnet):
        with pytest.raises(ValueError):
            net.encode_frame({"blob": "x" * net.MAX_FRAME_BYTES})


@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
def test_extract_frames_same_partial_feed(chunk):
    """Fed the same wire in the same chunks, both extractors pop the same
    payloads at the same points and leave the same partial tail."""
    (rnet, _), (pnet, _) = _pkgs()
    wire = b"".join(rnet.encode_frame(f) for f in FRAMES)
    rbuf, pbuf = bytearray(), bytearray()
    for i in range(0, len(wire), chunk):
        piece = wire[i: i + chunk]
        rbuf += piece
        pbuf += piece
        assert pnet.extract_frames(pbuf) == rnet.extract_frames(rbuf)
        assert pbuf == rbuf
    assert not pbuf


@pytest.mark.parametrize("prefix", [
    struct.pack(">I", (1 << 20) + 1) + b"xx",
    b"\xff\xff\xff\xff",
    b"GET / HTTP/1.1\r\n",
    struct.pack(">I", 64) + b"short",
])
def test_frame_error_on_same_prefixes(prefix):
    (rnet, _), (pnet, _) = _pkgs()
    outs = []
    for net in (rnet, pnet):
        buf = bytearray(prefix)
        try:
            outs.append(("ok", net.extract_frames(buf), bytes(buf)))
        except net.FrameError as e:
            outs.append(("FrameError", str(e), bytes(buf)))
    assert outs[0] == outs[1]
    # a small max_frame refuses what the default admits, in both
    for net in (rnet, pnet):
        buf = bytearray(struct.pack(">I", 64) + b"x" * 64)
        with pytest.raises(net.FrameError):
            net.extract_frames(buf, max_frame=63)


def test_port_files_cross_package(tmp_path):
    (rnet, _), (pnet, _) = _pkgs()
    for w, r in ((rnet, pnet), (pnet, rnet)):
        path = str(tmp_path / f"{w.__name__}.port")
        assert r.read_port_file(path) is None
        w.write_port_file(path, "127.0.0.1", 4242)
        assert r.read_port_file(path) == ("127.0.0.1", 4242)
        with open(path) as f:
            assert f.read() == "127.0.0.1 4242\n"
    for junk in ("garbage", "a b c", "host port", ""):
        path = str(tmp_path / "junk.port")
        with open(path, "w") as f:
            f.write(junk)
        assert pnet.read_port_file(path) == rnet.read_port_file(path)


@pytest.mark.parametrize("rate,burst,seed", [
    (10.0, 2.0, 0), (1.0, 1.0, 1), (0.001, 1.0, 2), (250.0, 5.0, 3),
])
def test_token_bucket_same_allow_sequence(rate, burst, seed):
    """Under one injected clock (seeded steps, some backwards: a frame's
    arrival stamp may predate the bucket) both buckets make the same
    decisions and hold the same tokens."""
    (rnet, _), (pnet, _) = _pkgs()
    rb, pb = rnet.TokenBucket(rate, burst), pnet.TokenBucket(rate, burst)
    rb.stamp = pb.stamp = 100.0
    rng = np.random.default_rng(seed)
    now = 100.0
    seq_r, seq_p = [], []
    for _ in range(400):
        now += float(rng.choice([0.0, 0.0, 0.001, 0.05, 0.1, 1.0, -0.01]))
        seq_r.append(rb.allow(now))
        seq_p.append(pb.allow(now))
        assert pb.tokens == rb.tokens and pb.stamp == rb.stamp
    assert seq_p == seq_r
    assert any(seq_p) and not all(seq_p)


def test_brownout_policy_same_validation():
    (rnet, _), (pnet, _) = _pkgs()
    for kw in ({}, {"ladder": {"kshortest": 0.1}}, {"ladder": {"nope": 0.5}},
               {"min_samples": 0}, {"release": 0.0}, {"release": 1.0},
               {"headroom": 2.0, "retry_after_ms": 10}):
        outs = []
        for net in (rnet, pnet):
            try:
                pol = net.BrownoutPolicy(**kw)
                outs.append({k: getattr(pol, k) for k in pol.__slots__})
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], kw


# ---- one stream through both servers -------------------------------------

@pytest.fixture(scope="module")
def both():
    """A pipelined engine and its front door in each package, on the same
    graph (the admission, deadline and drain tests build their own)."""
    (rnet, rengine), (pnet, pengine) = _pkgs()
    reng, peng = rengine(max_wait_ms=5.0), pengine(max_wait_ms=5.0)
    rsrv, psrv = rnet.NetServer(reng), pnet.NetServer(peng)
    yield (rnet, reng, rsrv), (pnet, peng, psrv)
    for x in (rsrv, psrv, reng, peng):
        x.close()


def _stream(frames, sides) -> list:
    out = []
    for net, _eng, srv in sides:
        conn = _Raw(net, srv)
        try:
            for f in frames:
                conn.send(f)
            out.append(_by_id(conn.recv(len(frames))))
        finally:
            conn.close()
    return out


def test_seeded_query_stream_same_replies(both):
    rng = np.random.default_rng(23)
    pairs = rng.integers(0, N, size=(96, 2)).tolist()
    pairs += [[5, 5], [0, N - 1], [N - 1, 0], [3, 250], [3, 250]]
    frames = [{"op": "query", "id": i, "src": s, "dst": d}
              for i, (s, d) in enumerate(pairs)]
    # deadline-carrying and tenant-tagged queries admitted as any other
    frames += [{"op": "query", "id": f"t{i}", "src": i, "dst": 3 * i + 1,
                "tenant": "t", "deadline_ms": 60_000}
               for i in range(1, 9)]
    ref, port = _stream(frames, both)
    assert port == ref
    assert sum(r["ok"] for r in ref.values()) == len(frames)


def test_error_taxonomy_same_replies(both):
    frames = [
        {"op": "query", "id": 1, "src": 0, "dst": N + 5},
        {"op": "query", "id": 2, "src": -1, "dst": 3},
        {"op": "query", "id": 3, "dst": 3},
        {"op": "query", "id": 4, "src": "x", "dst": 3},
        {"op": "query", "id": 5, "src": [1], "dst": 3},
        {"op": "query", "id": 6, "src": 0, "dst": 399, "deadline_ms": "abc"},
        {"op": "query", "id": 7, "src": 0, "dst": 399, "deadline_ms": [5.0]},
        {"op": "query", "id": 8, "src": 0, "dst": 399,
         "deadline_ms": {"ms": 5}},
        {"op": "frobnicate", "id": 9},
        {"id": 10},
        {"op": "query", "id": 11, "src": 0, "dst": 3, "graph": "nope"},
    ]
    ref, port = _stream(frames, both)
    assert port == ref
    assert {r["kind"] for r in ref.values() if not r["ok"]} == {"invalid"}


@pytest.mark.parametrize("payload", [
    b"not json at all", b"[1, 2, 3]", b"\xff\xfe", b'"a string"', b"17",
])
def test_malformed_payload_same_reply_connection_survives(both, payload):
    outs = []
    for net, _eng, srv in both:
        conn = _Raw(net, srv)
        try:
            conn.send_raw(payload)
            conn.send({"op": "ping", "id": 1})
            outs.append(conn.recv(2))
        finally:
            conn.close()
    assert outs[0] == outs[1]
    assert outs[1][0]["kind"] == "invalid" and outs[1][1]["ok"]


def test_oversize_prefix_same_goodbye_then_close(both):
    outs = []
    for net, _eng, srv in both:
        sock = socket.create_connection((srv.host, srv.port))
        try:
            sock.settimeout(WAIT_S)
            sock.sendall(struct.pack(">I", net.MAX_FRAME_BYTES + 1))
            buf = bytearray()
            while True:
                data = sock.recv(1 << 16)
                if not data:
                    break
                buf += data
            outs.append(bytes(buf))
        finally:
            sock.close()
    assert outs[0] == outs[1]
    (raw,) = _pkgs()[1][0].extract_frames(bytearray(outs[1]))
    assert "closing connection" in json.loads(raw.decode())["error"]


def _control_frames():
    return [
        {"op": "ping", "id": "ping"},
        {"op": "version", "id": "version"},
        {"op": "version", "id": "version-g", "graph": "g"},
        {"op": "memory", "id": "memory"},
        {"op": "graphs", "id": "graphs"},
        {"op": "update", "id": "update", "adds": [[0, 1]]},
        {"op": "roll", "id": "roll", "adds": [[0, 1]]},
        {"op": "analytics", "id": "tri", "kind": "triangles"},
        {"op": "analytics", "id": "cc", "kind": "components"},
        {"op": "analytics", "id": "pr", "kind": "pagerank",
         "params": {"damping": "0.9", "max_iters": "50"}},
        {"op": "analytics", "id": "sssp", "kind": "sssp",
         "params": {"source": 3}},
        {"op": "analytics", "id": "bogus", "kind": "bogus"},
        {"op": "analytics", "id": "nosrc", "kind": "sssp"},
        {"op": "analytics", "id": "badp", "kind": "sssp",
         "params": {"source": 3, "x": 1}},
    ]


def test_control_ops_same_replies(both):
    """Every deterministic control reply is equal, ``analytics`` included
    (its ``time_s`` aside); the ones that carry timings or this process's
    own state (``health``, ``stats``, ``metrics``, ``flightrec``) have the
    same structure and the same deterministic fields."""
    frames = _control_frames() + [
        {"op": op, "id": op} for op in ("health", "stats", "metrics",
                                        "flightrec")
    ]
    ref, port = _stream(frames, both)
    assert port.keys() == ref.keys()
    # an inline graph's version is numbered per process: each package's
    # reply names its own engine's version
    for replies, (_net, eng, _srv) in zip((ref, port), both):
        for key in ('"version"', '"version-g"'):
            assert (replies[key]["result"].pop("version")
                    == eng.stats()["graph"]["version"])
    for key in ref:
        r, p = ref[key], port[key]
        if key.strip('"') in ("health", "stats", "metrics", "flightrec"):
            continue
        if r.get("ok") and isinstance(r["result"], dict):
            r["result"].pop("time_s", None)
            p["result"].pop("time_s", None)
        assert p == r, key
    h_r, h_p = ref['"health"']["result"], port['"health"']["result"]
    assert h_p.keys() == h_r.keys() and h_p["state"] == h_r["state"]
    s_r, s_p = ref['"stats"']["result"], port['"stats"']["result"]
    # the port's stats add the engine's device
    assert set(s_r) <= set(s_p) and set(s_p) - set(s_r) == {"device"}
    for g in (s_r["graph"], s_p["graph"]):
        g.pop("version")
    assert s_p["graph"] == s_r["graph"]
    f_r, f_p = ref['"flightrec"']["result"], port['"flightrec"']["result"]
    assert f_p.keys() == f_r.keys() and f_p["capacity"] == f_r["capacity"]
    assert f_p["pid"] == os.getpid()
    from bibfs_tpu_torch.obs.names import NET_METRIC_FAMILIES

    for fam in NET_METRIC_FAMILIES:
        assert fam in port['"metrics"']["result"]["render"], fam


def test_flightrec_dump_op(both, tmp_path):
    from bibfs_tpu_torch.obs.dtrace import FLIGHT

    (_r, (pnet, _eng, psrv)) = both
    client = pnet.NetClient(psrv.host, psrv.port)
    path = str(tmp_path / "demand.flightrec.json")
    FLIGHT.configure(dump_path=path)
    try:
        snap = client.request("flightrec", dump=True)
        assert snap["dumped_to"] == path
        with open(path) as f:
            assert json.load(f)["reason"] == "demand"
    finally:
        FLIGHT._dump_path = None
        client.close()


# ---- admission, deadlines, drain, brownout ------------------------------

def _pair_run(make_server, drive, engine_kw=None):
    """Run ``drive(net, server, client, fresh)`` against a fresh engine and
    server in each package; returns both results."""
    outs = []
    for net, engine in _pkgs():
        eng = engine(**(engine_kw or {"max_wait_ms": 5.0}))
        srv = make_server(net, eng)
        client = net.NetClient(srv.host, srv.port)
        try:
            outs.append(drive(net, srv, client, _fresh_pairs()))
        finally:
            client.close()
            srv.close()
            eng.close()
    return outs


def _outcome(t):
    try:
        r = t.wait(timeout=WAIT_S)
        return ("ok", r.found, r.hops)
    except Exception as e:
        return (type(e).__name__, getattr(e, "kind", None), str(e),
                getattr(e, "retry_after_ms", None))


def test_capacity_refusal_same_and_spares_quota_token():
    from bibfs_tpu.obs.metrics import MetricsRegistry as RReg
    from bibfs_tpu_torch.obs.metrics import MetricsRegistry as PReg

    regs = iter((RReg(), PReg()))

    def make(net, eng):
        return net.NetServer(eng, max_inflight=1, quota_qps=0.001,
                             quota_burst=1.0, registry=next(regs))

    def drive(net, srv, client, fresh):
        first = client.submit(*next(fresh), tenant="filler")
        refused = client.submit(*next(fresh), tenant="t")
        out = [_outcome(refused), _outcome(first)]
        # the refusal spared t's single token: it still buys a query,
        # and then the bucket is empty
        out.append(_outcome(client.submit(*next(fresh), tenant="t")))
        out.append(_outcome(client.submit(*next(fresh), tenant="t")))
        text = srv._registry.render()
        out.append(sorted(ln for ln in text.splitlines()
                          if ln.startswith("bibfs_net_rejections_total{")))
        return out

    ref, port = _pair_run(make, drive, {"max_wait_ms": 300.0})
    assert port == ref
    assert ref[0][1] == "capacity" and ref[2][0] == "ok"
    assert "quota" in ref[3][2]
    assert 'bibfs_net_rejections_total{reason="capacity"} 1' in ref[4]
    assert 'bibfs_net_rejections_total{reason="quota"} 1' in ref[4]


def test_quota_same_decisions():
    def make(net, eng):
        return net.NetServer(eng, quota_qps=1.0, quota_burst=2.0)

    def drive(net, srv, client, fresh):
        greedy = [client.submit(0, 399, tenant="greedy") for _ in range(6)]
        out = [_outcome(t)[:2] for t in greedy]
        out.append(_outcome(client.submit(3, 250, tenant="polite")))
        return out

    ref, port = _pair_run(make, drive)
    # a refill may land between two greedy submits on a slow box: both
    # packages admit the burst and refuse the rest the same way
    assert port[:2] == ref[:2] == [("ok", True)] * 2
    assert port[-1] == ref[-1]
    assert sum(o == ("QueryError", "capacity") for o in port[:6]) >= 3


def test_deadline_miss_same_and_counted_once():
    from bibfs_tpu.obs.metrics import MetricsRegistry as RReg
    from bibfs_tpu_torch.obs.metrics import MetricsRegistry as PReg

    regs = iter((RReg(), PReg()))

    def make(net, eng):
        return net.NetServer(eng, registry=next(regs))

    def drive(net, srv, client, fresh):
        # the 300 ms flush SLO cannot beat a 5 ms deadline
        missed = [client.submit(*next(fresh), deadline_ms=5.0)
                  for _ in range(3)]
        out = [_outcome(t) for t in missed]
        s, d = next(fresh)
        out.append(_outcome(client.submit(s, d, deadline_ms=30_000.0)))
        # a late result after the timeout reply adds no second reply or
        # count: wait past the flush, then read the counter
        time.sleep(0.5)
        out.append([ln for ln in srv._registry.render().splitlines()
                    if ln.startswith("bibfs_net_deadline_misses_total")])
        out.append(client.pending_count())
        return out

    ref, port = _pair_run(make, drive, {"max_wait_ms": 300.0})
    assert port == ref
    assert [o[1] for o in ref[:3]] == ["timeout"] * 3
    assert ref[3][0] == "ok"
    assert ref[4] == ["bibfs_net_deadline_misses_total 3"]
    assert ref[5] == 0


def test_default_deadline_applies():
    def make(net, eng):
        return net.NetServer(eng, default_deadline_ms=5.0)

    def drive(net, srv, client, fresh):
        return [_outcome(client.submit(*next(fresh))),
                _outcome(client.submit(*next(fresh), deadline_ms=30_000))]

    ref, port = _pair_run(make, drive, {"max_wait_ms": 300.0})
    assert port == ref and ref[0][1] == "timeout" and ref[1][0] == "ok"


def test_drain_same_replies():
    def make(net, eng):
        return net.NetServer(eng)

    def drive(net, srv, client, fresh):
        out = [_outcome(client.submit(0, 399))]
        out.append(srv.drain(timeout=10.0))
        out.append(_outcome(client.submit(3, 250)))
        out.append(client.request("ping"))
        out.append(srv.pending_count())
        return out

    ref, port = _pair_run(make, drive)
    assert port == ref
    assert ref[2][1] == "capacity" and "draining" in ref[2][2]


def test_brownout_feasibility_same_shed():
    def make(net, eng):
        return net.NetServer(eng, brownout=net.BrownoutPolicy(
            min_samples=5, headroom=1e9, ladder={}))

    def drive(net, srv, client, fresh):
        eng = srv._engine
        for _ in range(6):  # arm the estimate
            client.submit(*next(fresh)).wait(timeout=WAIT_S)
        deadline = time.monotonic() + 10.0
        while eng.latency.count < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        t = client.submit(*next(fresh), deadline_ms=50.0)
        try:
            t.wait(timeout=WAIT_S)
            shed = None
        except Exception as e:
            shed = (e.kind, "infeasible" in str(e),
                    float(e.retry_after_ms) >= 250.0)
        s, d = next(fresh)
        ok = _outcome(client.submit(s, d))
        text = srv._registry.render()
        return [shed, ok, 'bibfs_admission_shed_total{reason="infeasible"} 1'
                in text]

    ref, port = _pair_run(make, drive)
    assert port == ref == [("capacity", True, True), port[1], True]
    assert port[1][0] == "ok"


def test_brownout_ladder_same_shed_and_point_spared():
    def make(net, eng):
        return net.NetServer(eng, brownout=net.BrownoutPolicy(
            feasibility=False, ladder={"kshortest": 0.0}),
            quota_qps=0.001, quota_burst=1.0)

    def drive(net, srv, client, fresh):
        out = [_outcome(client.submit(*next(fresh), kind="kshortest",
                                      tenant="t"))]
        # the shed spared t's single quota token
        out.append(_outcome(client.submit(*next(fresh), tenant="t")))
        out.append(_outcome(client.submit(*next(fresh), kind="msbfs")))
        return out

    ref, port = _pair_run(make, drive)
    assert port == ref
    assert ref[0][1] == "capacity" and ref[0][3] == 250.0
    assert ref[1][0] == "ok" and ref[2][0] == "ok"


def test_brownout_three_rungs_same_hysteresis():
    """The three ladder rungs engage and release at the same occupancies
    in both packages, swept up and down through their bands."""
    occs = list(range(0, 11)) + list(range(10, -1, -1)) + [5, 7, 6, 8, 4, 9]
    outs = []
    for net, engine in _pkgs():
        eng = engine(max_wait_ms=5.0)
        srv = net.NetServer(eng, max_inflight=10, brownout=net.BrownoutPolicy(
            feasibility=False, release=0.2))
        try:
            seq = []
            for occ in occs:
                with srv._lock:
                    srv._submitting = occ
                    seq.append(tuple(srv._shed_locked(k, None)
                                     for k in net.BROWNOUT_LADDER + ("point",)))
                    seq.append(tuple(sorted(srv._shed_engaged)))
                    srv._submitting = 0
            outs.append(seq)
        finally:
            srv.close()
            eng.close()
    assert outs[0] == outs[1]
    assert ("kshortest", 250.0) in outs[1][10]  # engaged at the top


# ---- the wire across the packages ------------------------------------------

@pytest.mark.parametrize("direction", ["ref-client/port-server",
                                       "port-client/ref-server"])
def test_cross_package_wire(both, direction):
    (rnet, _reng, rsrv), (pnet, _peng, psrv) = both
    client_net, srv = ((rnet, psrv) if direction.startswith("ref")
                       else (pnet, rsrv))
    from bibfs_tpu_torch.solvers.serial import solve_serial

    client = client_net.NetClient(srv.host, srv.port)
    try:
        pairs = [(0, 399), (3, 250), (11, 11), (5, 100), (399, 2)]
        tickets = [client.submit(s, d) for s, d in pairs]
        for (s, d), t in zip(pairs, tickets):
            res = t.wait(timeout=WAIT_S)
            ref = solve_serial(N, EDGES, s, d)
            assert (res.found, res.hops) == (ref.found, ref.hops)
        assert client.request("ping") == {"pong": True}
        assert client.request("stats")["graph"]["n"] == N
        r = client.request("analytics", kind="components")
        assert r["count"] == 1
        t = client.submit(0, N + 5)
        with pytest.raises(Exception) as exc:
            t.wait(timeout=WAIT_S)
        assert exc.value.kind == "invalid"
        with pytest.raises(Exception) as exc:
            client.request("memory")
        assert exc.value.kind == "invalid"
    finally:
        client.close()


def test_client_fails_pending_on_disconnect():
    outs = []
    for net, engine in _pkgs():
        eng = engine(max_wait_ms=300.0)
        srv = net.NetServer(eng)
        client = net.NetClient(srv.host, srv.port)
        try:
            t = client.submit(*next(_fresh_pairs()))
            srv.close()
            outs.append(_outcome(t)[:3])
            outs.append(client.alive)
        finally:
            client.close()
            eng.close()
    assert outs[:2] == outs[2:]


# ---- metric families --------------------------------------------------------

def test_net_metric_families_render_at_zero_as_reference():
    from bibfs_tpu.obs.metrics import MetricsRegistry as RReg
    from bibfs_tpu_torch.obs.metrics import MetricsRegistry as PReg
    from bibfs_tpu_torch.obs.names import NET_METRIC_FAMILIES

    texts = []
    for (net, engine), reg in zip(_pkgs(), (RReg(), PReg())):
        eng = engine(max_wait_ms=5.0)
        srv = net.NetServer(eng, registry=reg, brownout=net.BrownoutPolicy())
        try:
            texts.append(sorted(
                ln for ln in reg.render().splitlines()
                if "bibfs_net_" in ln or "bibfs_admission_shed" in ln))
        finally:
            srv.close()
            eng.close()
    assert texts[0] == texts[1]
    text = "\n".join(texts[1])
    for family in NET_METRIC_FAMILIES:
        assert family in text, family
    assert 'bibfs_net_requests_total{op="query"} 0' in text
    assert 'bibfs_net_rejections_total{reason="quota"} 0' in text
    assert 'bibfs_admission_shed_total{reason="infeasible"} 0' in text


def test_brownout_off_mints_no_shed_counter():
    from bibfs_tpu_torch.obs.metrics import MetricsRegistry

    (_r, (pnet, pengine)) = _pkgs()
    reg = MetricsRegistry()
    eng = pengine(max_wait_ms=5.0)
    srv = pnet.NetServer(eng, registry=reg)
    client = pnet.NetClient(srv.host, srv.port)
    try:
        assert client.submit(3, 250, kind="kshortest").wait(
            timeout=WAIT_S).found
        assert "bibfs_admission_shed_total" not in reg.render()
    finally:
        client.close()
        srv.close()
        eng.close()


def test_names_match_reference_and_net_families_minted_by_port():
    from bibfs_tpu.obs import names as rnames
    from bibfs_tpu_torch.obs import names as pnames

    for attr in dir(rnames):
        if attr.isupper():
            assert getattr(pnames, attr) == getattr(rnames, attr), attr
    for tok in ("bibfs_stage_seconds_bucket", "bibfs_net_bytes_total",
                "bibfs_nope", "bibfs_stage_seconds_sum", "bibfs_tpu"):
        assert pnames.canonical_family(tok) == rnames.canonical_family(tok)
    for name in sorted(pnames.ALL_METRIC_NAMES):
        assert pnames.exposition_names(name) == rnames.exposition_names(name)


# ---- the CLI ----------------------------------------------------------------

def test_serve_port_cli_child(tmp_path):
    """``bibfs-torch-serve g.bin --pipeline --port 0 --port-file F``: the
    port file appears, a client round-trips queries and control ops, and
    SIGTERM drains the door and exits 0."""
    from bibfs_tpu_torch.graph.io import write_graph_bin
    from bibfs_tpu_torch.serve.net import NetClient, read_port_file
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n = 80
    edges = _skiplink_graph(n)
    gpath = tmp_path / "g.bin"
    write_graph_bin(str(gpath), n, edges)
    port_file = str(tmp_path / "net.port")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "bibfs_tpu_torch.serve.cli",
         str(gpath), "--pipeline", "--no-path", "--device", "cpu",
         "--max-wait-ms", "5", "--port", "0", "--port-file", port_file],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1", "PYTHONPATH": root},
    )
    client = None
    try:
        deadline = time.monotonic() + 120.0
        addr = None
        while addr is None:
            assert proc.poll() is None, "child died before binding"
            assert time.monotonic() < deadline, "no port file"
            addr = read_port_file(port_file)
            if addr is None:
                time.sleep(0.05)
        client = NetClient(addr[0], addr[1])
        pairs = [(0, 50), (3, 40), (0, n - 1), (7, 7)]
        tickets = [client.submit(s, d) for s, d in pairs]
        for (s, d), t in zip(pairs, tickets):
            assert t.wait(timeout=60.0).hops == solve_serial(
                n, edges, s, d).hops
        assert client.request("ping") == {"pong": True}
        assert client.request("stats")["graph"]["n"] == n
        assert client.request("health")["state"] == "ready"
        assert client.request("flightrec")["pid"] == proc.pid
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60.0) == 0
        err = proc.stderr.read()
        assert "[Net] serving on" in err and "SIGTERM: draining" in err
    finally:
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10.0)


def test_cli_port_flag_checks(capsys):
    from bibfs_tpu_torch.serve.cli import main

    assert main(["g.bin", "--port", "0", "--device", "cpu"]) == 2
    assert "--port needs --pipeline" in capsys.readouterr().err
    assert main(["g.bin", "--port", "0", "--pipeline", "--pairs", "p.txt",
                 "--device", "cpu"]) == 2
    assert "does not combine with --pairs" in capsys.readouterr().err
