"""The PyTorch port's blocked serving route and adaptive routing
(``serve/routes/blocked.py``, ``serve/policy.py``, the engines'
``blocked=`` and ``adaptive=``, ``bibfs-torch-serve --blocked
--adaptive``) against ``bibfs_tpu``'s on the CPU: both engines' answers
and counters equal the JAX package's engines on the same queries, the
route stands aside below the crossover and on a sparse graph as the
reference's does, the ``blocked`` and ``blocked_finish`` faults degrade
with the reference's accounting, a CUDA engine fails its tickets on any
other blocked failure, and the :class:`AdaptiveRouter` makes the
reference's decisions (explore, learned, the explore cap, unknown
digests, the sidecar round trip). Every comparison is exact. The
policy's round trip through a durable store is in
``test_torch_durable.py``."""

import json

import numpy as np
import pytest

from bibfs_tpu.graph.generate import gnp_random_graph

N = 700
DEG = 30.0  # dense-ish: the compact-tile regime the route exists for
FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _graph(n=N, deg=DEG, seed=1):
    from bibfs_tpu.graph.csr import build_csr, canonical_pairs

    edges = gnp_random_graph(n, deg / n, seed=seed)
    pairs = canonical_pairs(n, edges)
    return edges, pairs, build_csr(n, pairs=pairs)


def _pairs(rng, n, count):
    qp = np.unique(rng.integers(0, n, size=(3 * count, 2)), axis=0)
    qp = qp[qp[:, 0] != qp[:, 1]]
    rng.shuffle(qp)
    return qp[:count]


def _fields(r):
    return tuple(getattr(r, f) for f in FIELDS)


def _check_exact(n, csr, qp, results):
    from bibfs_tpu.solvers.serial import solve_serial_csr

    for (s, d), res in zip(qp, results):
        ref = solve_serial_csr(n, *csr, int(s), int(d))
        assert (res.found, res.hops) == (ref.found, ref.hops), (s, d)


def _engines(kind, n, edges, pairs, **kw):
    """The reference's and the port's engine of one kind, same options."""
    from bibfs_tpu.serve.engine import QueryEngine as JQ
    from bibfs_tpu.serve.pipeline import PipelinedQueryEngine as JP

    from bibfs_tpu_torch.serve import PipelinedQueryEngine as TP
    from bibfs_tpu_torch.serve import QueryEngine as TQ

    if kind == "pipelined":
        # no deadline and a threshold above the wave: query_many's drain
        # pops the whole wave as one flush in both packages
        kw = dict(kw, max_wait_ms=None, flush_threshold=4096)
        return (JP(n, edges, pairs=pairs, **kw),
                TP(n, edges, pairs=pairs, device="cpu", **kw))
    return (JQ(n, edges, pairs=pairs, **kw),
            TQ(n, edges, pairs=pairs, device="cpu", **kw))


_COUNTERS = ("queries", "trivial", "cache_served", "device_queries",
             "host_queries", "blocked_queries", "device_batches")


@pytest.mark.parametrize("kind", ["sync", "pipelined"])
def test_blocked_route_matches_reference_both_engines(kind):
    """180 queries on a dense-ish graph: one blocked flush in both
    packages, every answer (paths, meets, levels, edges) and the route
    counters equal, hops equal to the oracle's."""
    rng = np.random.default_rng(11)
    edges, pairs, csr = _graph()
    kw = dict(blocked=True, cache_entries=0)
    if kind == "sync":
        kw["flush_threshold"] = 4
    ref, port = _engines(kind, N, edges, pairs, **kw)
    try:
        qp = _pairs(rng, N, 180)
        want = ref.query_many(qp)
        got = port.query_many(qp)
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
        assert all(r.mode == "blocked" for r in got)
        _check_exact(N, csr, qp, got)
        sr, sp = ref.stats(), port.stats()
        for c in _COUNTERS:
            assert sp[c] == sr[c], c
        assert sp["blocked_queries"] == len(qp)
        assert sp["routes"]["blocked"]["batches"] == 1
        assert sp["routes"]["blocked"]["crossover"] == \
            sr["routes"]["blocked"]["crossover"]
        assert sp["ladder"] == sr["ladder"] == ["blocked", "device", "host"]
        assert sp["exec_cache"]["misses"] >= 1
    finally:
        ref.close()
        port.close()


def test_blocked_metric_families_render_at_zero():
    from bibfs_tpu.obs.names import (
        ADAPTIVE_METRIC_FAMILIES,
        BLOCKED_METRIC_FAMILIES,
    )

    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.serve import QueryEngine

    edges, pairs, _csr = _graph(seed=2)
    eng = QueryEngine(N, edges, pairs=pairs, blocked=True, adaptive=True,
                      device="cpu")
    try:
        render = REGISTRY.render()
        for fam in BLOCKED_METRIC_FAMILIES + ADAPTIVE_METRIC_FAMILIES:
            assert fam in render, fam
        res = eng.stats()["resilience"]
        for edge in ("blocked->device", "blocked->host"):
            assert res["fallbacks"][edge] == 0
    finally:
        eng.close()


def test_blocked_stands_aside_below_crossover_and_on_sparse():
    """Below the 128-query crossover the flush goes to the host, and on a
    sparse random graph the candidate-waste gate refuses the route, in
    both packages alike; the options' validation."""
    from bibfs_tpu_torch.serve import QueryEngine
    from bibfs_tpu_torch.serve import engine as engine_mod
    from bibfs_tpu_torch.serve.routes import BlockedConfig

    rng = np.random.default_rng(12)
    edges, pairs, csr = _graph()
    ref, port = _engines("sync", N, edges, pairs, blocked=True,
                         cache_entries=0, flush_threshold=4)
    try:
        qp = _pairs(rng, N, 40)
        got = port.query_many(qp)
        assert [_fields(r) for r in got] == [_fields(r) for r in ref.query_many(qp)]
        assert port.stats()["blocked_queries"] == 0
        assert port.stats()["host_queries"] == ref.stats()["host_queries"] == 40
    finally:
        ref.close()
        port.close()
    n2 = 4000
    edges2 = gnp_random_graph(n2, 2.2 / n2, seed=3)
    from bibfs_tpu.graph.csr import canonical_pairs

    pairs2 = canonical_pairs(n2, edges2)
    ref2, port2 = _engines("sync", n2, edges2, pairs2, blocked=True,
                           cache_entries=0, flush_threshold=4)
    try:
        rt, rt2 = port._current_rt(), port2._current_rt()
        for b in (64, 128, 256, 1024):
            batch = [(0, 1)] * b
            assert not port2.routes["blocked"].eligible(rt2, batch)
            assert port.routes["blocked"].eligible(rt, batch) == (
                ref.routes["blocked"].eligible(ref._graph_rt(None), batch))
        assert port2.routes["blocked"].eligible(rt2, [(0, 1)] * 256) \
            == ref2.routes["blocked"].eligible(ref2._graph_rt(None),
                                               [(0, 1)] * 256)
    finally:
        ref2.close()
        port2.close()
    # every constructor option is ported: no table of unported ones is left
    assert not hasattr(engine_mod, "_UNPORTED")
    with pytest.raises(ValueError, match="blocked="):
        QueryEngine(N, edges, pairs=pairs, blocked="yes", device="cpu")
    with pytest.raises(ValueError, match="adaptive="):
        QueryEngine(N, edges, pairs=pairs, adaptive="yes", device="cpu")
    eng = QueryEngine(N, edges, pairs=pairs, device="cpu",
                      blocked=BlockedConfig(min_batch=8, waste_cap=1e9))
    try:
        st = eng.stats()["routes"]["blocked"]["crossover"]
        assert st == {"min_batch": 8, "waste_cap": 1e9,
                      "plane_dtype": "float32"}
    finally:
        eng.close()


@pytest.mark.parametrize("kind", ["sync", "pipelined"])
def test_blocked_fault_degrades_like_reference(kind):
    """``blocked:times=4``: two faulted flushes burn the retries and open
    the route's own breaker; every answer is exact and equal to the
    reference's, and so are the fallback, retry and breaker counts."""
    from bibfs_tpu.serve.faults import FaultPlan as JPlan

    from bibfs_tpu_torch.serve.faults import FaultPlan as TPlan

    edges, pairs, csr = _graph(seed=4)
    ref, port = _engines(kind, N, edges, pairs, blocked=True,
                         cache_entries=0, flush_threshold=4)
    ref._faults = JPlan.parse("blocked:times=4")
    port._faults = TPlan.parse("blocked:times=4")
    try:
        rng = np.random.default_rng(13)
        for _ in range(2):
            qp = _pairs(rng, N, 160)
            got = port.query_many(qp)
            assert [_fields(r) for r in got] == [
                _fields(r) for r in ref.query_many(qp)]
            _check_exact(N, csr, qp, got)
        sr, sp = ref.stats(), port.stats()
        assert sp["blocked_queries"] == sr["blocked_queries"] == 0
        assert sp["resilience"]["fallbacks"] == sr["resilience"]["fallbacks"]
        assert sp["resilience"]["retries"] == sr["resilience"]["retries"]
        bj = sr["routes"]["blocked"]["breaker"]
        bt = sp["routes"]["blocked"]["breaker"]
        assert bt["opens"] == bj["opens"] >= 1 and bt["state"] == bj["state"]
        from bibfs_tpu_torch.obs.metrics import REGISTRY

        assert "bibfs_blocked_breaker_state" in REGISTRY.render()
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("kind", ["sync", "pipelined"])
def test_blocked_finish_fault_degrades(kind):
    """The finish-stage seam: the launch lands, the finish fails; the
    batch degrades (sync: down the ladder; pipelined: recovered on the
    host by the finish worker), answers exact, counts the reference's."""
    from bibfs_tpu.serve.faults import FaultPlan as JPlan

    from bibfs_tpu_torch.serve.faults import FaultPlan as TPlan

    edges, pairs, csr = _graph(seed=11)
    ref, port = _engines(kind, N, edges, pairs, blocked=True,
                         cache_entries=0, flush_threshold=4)
    ref._faults = JPlan.parse("blocked_finish:times=2")
    port._faults = TPlan.parse("blocked_finish:times=2")
    try:
        qp = _pairs(np.random.default_rng(14), N, 160)
        got = port.query_many(qp)
        assert [_fields(r) for r in got] == [_fields(r) for r in ref.query_many(qp)]
        _check_exact(N, csr, qp, got)
        fb = port.stats()["resilience"]["fallbacks"]
        assert fb == ref.stats()["resilience"]["fallbacks"]
        assert fb["blocked->device"] + fb["blocked->host"] >= 1
    finally:
        ref.close()
        port.close()


def _cuda_typed_engine(monkeypatch, n, edges, pairs, **kw):
    """A port engine whose device reads as ``cuda`` (no card needed: the
    kernel build is stubbed and no flush here reaches a tensor on the
    card; the device rung is off)."""
    import torch

    from bibfs_tpu_torch.ops import _cuda
    from bibfs_tpu_torch.serve import ExecutableCache, QueryEngine
    from bibfs_tpu_torch.serve import engine as engine_mod

    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(_cuda, "lib", lambda name: None)
    return QueryEngine(n, edges, pairs=pairs, mode="sync",
                       host_backend="serial", exec_cache=ExecutableCache(),
                       device_batches=False, blocked=True, cache_entries=0,
                       flush_threshold=4, **kw)


def test_cuda_engine_blocked_failure_fails_tickets(monkeypatch):
    """On a CUDA engine the blocked rung degrades only an injected fault:
    a failed launch fails the chunk's tickets with ``kind='internal'``,
    unretried, with no fallback and a closed breaker."""
    from bibfs_tpu_torch.serve import QueryError
    from bibfs_tpu_torch.serve.faults import InjectedFault

    edges, pairs, csr = _graph(seed=5)
    eng = _cuda_typed_engine(monkeypatch, N, edges, pairs)
    route = eng.routes["blocked"]
    assert route.dt.itemsize == 1  # int8 planes on the card
    exc = RuntimeError("bibfs_blocked_level: CUDA launch failed (719)")

    def broken(rt, pairs):
        raise exc

    route.launch = broken
    rng = np.random.default_rng(15)
    out = eng.query_many(_pairs(rng, N, 150), return_errors=True)
    assert all(isinstance(r, QueryError) and r.kind == "internal"
               and r.cause is exc for r in out)
    st = eng.stats()
    assert not any(st["resilience"]["fallbacks"].values())
    assert st["resilience"]["retries"] == 0
    assert st["routes"]["blocked"]["breaker"]["state"] == "closed"

    def injected(rt, pairs):
        raise InjectedFault("blocked")

    route.launch = injected
    qp = _pairs(rng, N, 150)
    got = eng.query_many(qp)
    _check_exact(N, csr, qp, got)
    st = eng.stats()
    assert st["resilience"]["fallbacks"]["blocked->host"] == 1
    assert st["host_queries"] == len(qp)
    eng.close()


def test_cuda_blocked_engine_build_failure_raises(monkeypatch, tmp_path):
    """No fallback hides the blocked kernel: a CUDA engine with the
    blocked rung builds ``csrc/blocked_expand.cu`` in its constructor (a
    torch-composed mode needs no other source), and a failed build raises
    there."""
    import shutil

    import torch

    from bibfs_tpu_torch.ops import _cuda
    from bibfs_tpu_torch.serve import QueryEngine
    from bibfs_tpu_torch.serve import engine as engine_mod

    for p in _cuda.CSRC.glob("*.cu*"):
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "_libs", {})
    monkeypatch.setattr(_cuda, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    asked = []
    real_lib = _cuda.lib
    monkeypatch.setattr(_cuda, "lib", lambda name: (asked.append(name),
                                                    real_lib(name))[1])
    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    edges, pairs, _csr = _graph(seed=8)
    with pytest.raises(RuntimeError, match="nvcc"):
        QueryEngine(N, edges, pairs=pairs, mode="sync", blocked=True)
    assert asked == ["blocked_expand"]
    assert engine_mod._mode_sources("auto", blocked=True) == (
        "batch_minor", "blocked_expand")
    assert "blocked_expand" in _cuda.SOURCES
    assert "bibfs_blocked_level" in _cuda.SIGNATURES["blocked_expand"]


# ---- the AdaptiveRouter ------------------------------------------------
def _routers(**kw):
    from bibfs_tpu.serve.policy import AdaptiveRouter as JR

    from bibfs_tpu_torch.serve.policy import AdaptiveRouter as TR

    return JR(label="ref", **kw), TR(label="port", **kw)


def test_policy_decisions_match_reference():
    """A scripted stream of decisions and measurements through both
    routers: every ``order`` (ladder and reason) and the final stats
    (digests, first decision, the learned crossover) equal."""
    ladder = ("blocked", "device", "host")
    ref, port = _routers(routes=ladder)
    rng = np.random.default_rng(16)
    lat = {"blocked": 0.002, "device": 0.009, "host": 0.03}
    for step in range(40):
        digest = f"d{step % 3}"
        batch = int(rng.choice([4, 130, 256, 700]))
        assert port.order(digest, batch, ladder) == ref.order(digest, batch,
                                                              ladder)
        route = ladder[step % 3] if step % 7 else "device"
        secs = lat[route] * batch * float(rng.uniform(0.5, 1.5))
        assert port.note(digest, route, batch, secs) == ref.note(
            digest, route, batch, secs)
        if step % 5 == 0:
            port.sample_done()
            ref.sample_done()
    sr, sp = ref.stats(), port.stats()
    assert sp["digests"] == sr["digests"]
    assert sp["first_decision"] == sr["first_decision"]
    assert sp["notes"] == sr["notes"] == 40
    for d in ("d0", "d1", "d2"):
        assert port.batch_crossover(d, 32) == ref.batch_crossover(d, 32)


def test_adaptive_engine_explores_then_learns():
    """The engine's learning arc: the first flush explores the rung the
    static ladder would try last (device), later flushes ride the measured
    order (reason ``learned``, fastest measured rung first); every answer
    exact."""
    from bibfs_tpu_torch.serve import QueryEngine

    edges, pairs, csr = _graph(seed=6)
    eng = QueryEngine(N, edges, pairs=pairs, blocked=True, adaptive=True,
                      device_batches=True, cache_entries=0,
                      flush_threshold=4, device="cpu")
    try:
        rng = np.random.default_rng(17)
        for _ in range(6):
            qp = _pairs(rng, N, 160)
            _check_exact(N, csr, qp, eng.query_many(qp))
        st = eng.stats()["adaptive"]
        first = st["first_decision"]
        entry = st["digests"][first["digest"]]
        assert first["digest"] == eng._current_rt().snapshot.digest
        assert (first["route"], first["reason"]) == ("device", "explore")
        assert entry["last"]["reason"] == "learned"
        lat = {r: entry["routes"][r]["256"]["lat_us"]
               for r in ("blocked", "device")}
        assert entry["last"]["route"] == min(lat, key=lat.get)
        assert st["path"] is None and not st["loaded"]
    finally:
        eng.close()


def test_policy_sidecar_round_trip_and_merge(tmp_path):
    from bibfs_tpu_torch.serve.policy import AdaptiveRouter

    path = str(tmp_path / "policy.json")
    p1 = AdaptiveRouter(label="t1", routes=("blocked", "device", "host"),
                        path=path)
    for _ in range(3):
        p1.note("digA", "blocked", 256, 0.01)
        p1.note("digA", "device", 256, 0.05)
        p1.note("digA", "host", 256, 0.2)
    p1.observe_levels("digA", {"levels": [
        {"level": 1, "side": "s", "dir": "push", "frontier": 40,
         "edges": 200},
        {"level": 2, "side": "t", "dir": "pull", "frontier": 200,
         "edges": 900},
    ]}, 700)
    p1.save()
    p2 = AdaptiveRouter(label="t2", routes=("blocked", "device", "host"),
                        path=path)
    assert p2.loaded
    order, reason = p2.order("digA", 256, ("blocked", "device", "host"))
    assert reason == "learned" and order[0] == "blocked"
    assert order[-1] == "host"
    stats = p2.stats()["digests"]["digA"]
    assert stats["levels"]["push_frontier_max"] == 40
    assert p2.batch_crossover("digA", 9999) == 256
    # the reference's router reads the port's sidecar alike
    from bibfs_tpu.serve.policy import AdaptiveRouter as JR

    pj = JR(label="tj", routes=("blocked", "device", "host"), path=path)
    assert pj.order("digA", 256, ("blocked", "device", "host")) == (
        order, reason)
    p2.note("digB", "device", 128, 0.01)
    p2.note("digB", "device", 128, 0.01)
    p2.save()
    with open(path) as f:
        data = json.load(f)
    assert set(data["digests"]) == {"digA", "digB"}
    with open(path, "w") as f:
        f.write("{not json")
    p3 = AdaptiveRouter(label="t3", routes=("blocked",), path=path)
    assert not p3.loaded


def test_policy_explore_cap_unblocks_learning():
    """A rung that never yields a sample (ineligible for the graph) stops
    pinning the policy in explore after EXPLORE_CAP promotions: the
    measured order engages with the unmeasurable rung behind."""
    from bibfs_tpu_torch.serve.policy import EXPLORE_CAP, AdaptiveRouter

    p = AdaptiveRouter(label="t-cap", routes=("blocked", "device", "host"))
    reasons = []
    for _ in range(10):
        reasons.append(p.order("dig", 256, ("blocked", "device", "host"))[1])
        p.note("dig", "device", 256, 0.01)
        p.note("dig", "host", 256, 0.05)
    assert reasons[0] == "explore" and reasons.count("explore") <= EXPLORE_CAP + 1
    order, reason = p.order("dig", 256, ("blocked", "device", "host"))
    assert reason == "learned"
    assert order[0] == "device"
    assert order.index("blocked") > order.index("device")


def test_policy_unknown_digest_defaults():
    from bibfs_tpu_torch.serve.policy import AdaptiveRouter

    p = AdaptiveRouter(label="t4", routes=("blocked", "device", "host"))
    order, reason = p.order("nope", 256, ("blocked", "device", "host"))
    assert reason == "explore" and order[-1] == "host"
    assert order[:2] == ("device", "blocked")
    assert p.batch_crossover("nope", 32) == 32
    assert p.order("nope", 256, ("device", "host")) == (
        ("device", "host"), "default")


@pytest.mark.parametrize("extra", [[], ["--pipeline", "--max-wait-ms",
                                        "60000"]])
def test_cli_blocked_adaptive_prints_reference_lines(tmp_path, capsys, extra):
    """``bibfs-torch-serve --blocked --adaptive`` on the CPU prints the
    reference CLI's lines for the same graph and pairs, and its stats show
    the flush on the blocked route."""
    from bibfs_tpu.graph.io import write_graph_bin
    from bibfs_tpu.serve.cli import main as ref_main

    from bibfs_tpu_torch.serve.cli import main as port_main

    edges, _pairs_c, _csr = _graph(seed=7)
    gpath, ppath = tmp_path / "g.bin", tmp_path / "p.txt"
    write_graph_bin(gpath, N, edges)
    np.savetxt(ppath, _pairs(np.random.default_rng(18), N, 150), fmt="%d")
    argv = [str(gpath), "--pairs", str(ppath), "--blocked", "--adaptive",
            "--threshold", "4096", *extra]
    assert ref_main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    stats = tmp_path / "stats.json"
    assert port_main(argv + ["--device", "cpu", "--stats-json",
                             str(stats)]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) == 150
    with open(stats) as f:
        st = json.load(f)
    assert st["blocked_queries"] == 150
    assert st["adaptive"]["notes"] >= 1
