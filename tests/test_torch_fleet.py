"""The PyTorch port's fleet (``bibfs_tpu_torch.fleet``) on the CPU: every
case of the JAX package's ``tests/test_fleet.py`` and the three
``NetReplica`` cases of ``tests/test_serve_net.py`` run against the port
(the router's policy over stub replicas; in-process engines over
per-replica stores on ``device="cpu"``; spawned ``bibfs-torch-serve``
children with ``--device cpu``), then both packages side by side on the
same seeded inputs: the hash ring's owner of 200 names for fleets of
1-5, one scripted sequence of stub replicas (health flips, a dead
replica, failing tickets, spills, a rolling swap with a mid-roll crash,
a respawn between polls and a respawn whose catch-up is refused) read
step by step, an engine fleet's answers before, during and after a
rolling swap for their declared versions, and ``run_fleet`` in its quick
shape. Last, a child asked for ``--device cuda`` on a box without a card
fails its spawn instead of serving on the CPU.

Every wait has a timeout; a spawned child has ``spawn_timeout_s`` and
each replica's close its own."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from bibfs_tpu_torch.fleet import ReplicaDead, Router, engine_replica
from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.serve.resilience import QueryError, RetryPolicy
from bibfs_tpu_torch.solvers.api import BFSResult
from bibfs_tpu_torch.solvers.serial import solve_serial
from bibfs_tpu_torch.store import GraphStore

SPAWN_S = 120.0  # a child's spawn bound (import, graph read, engine build)


def _skiplink_graph(n: int) -> np.ndarray:
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


N = 80
EDGES = _skiplink_graph(N)


def _pkg(which: str) -> SimpleNamespace:
    """One package's fleet surface: the reference (``ref``) or the port."""
    if which == "ref":
        from bibfs_tpu.fleet import ReplicaDead as RD
        from bibfs_tpu.fleet import Router as R
        from bibfs_tpu.fleet import engine_replica as er
        from bibfs_tpu.obs.metrics import REGISTRY as REG
        from bibfs_tpu.serve.engine import QueryEngine as QE
        from bibfs_tpu.serve.resilience import QueryError as QErr
        from bibfs_tpu.serve.resilience import RetryPolicy as RP
        from bibfs_tpu.solvers.api import BFSResult as BR
        from bibfs_tpu.store import GraphStore as GS

        dev = {}
    else:
        RD, R, er, REG, QErr, RP, BR, GS = (
            ReplicaDead, Router, engine_replica, REGISTRY, QueryError,
            RetryPolicy, BFSResult, GraphStore,
        )
        from bibfs_tpu_torch.serve.engine import QueryEngine as QE

        dev = {"device": "cpu"}
    return SimpleNamespace(
        ReplicaDead=RD, Router=R, engine_replica=er, REGISTRY=REG,
        QueryError=QErr, RetryPolicy=RP, BFSResult=BR, GraphStore=GS,
        QueryEngine=QE, dev=dev, name=which,
    )


PORT = _pkg("port")


class _StubTicket:
    def __init__(self, src, dst, result=None, error=None):
        self.src, self.dst = src, dst
        self.result = result
        self.error = error


class StubReplica:
    """Replica-shaped test double: resolves every query inline with a
    recognizable result (hops = src + dst), scriptable health/load and
    failure modes, a version ledger (lost on a non-durable restart) and
    an incarnation counter. ``pkg`` supplies the exception and result
    classes of the router under test."""

    kind = "stub"

    def __init__(self, name, pkg=PORT, *, durable=True):
        self.name = name
        self.pkg = pkg
        self.durable = durable
        self.state = "ready"
        self._load = 0
        self.fail_submits = False
        self.fail_tickets = False
        self.fail_roll = False
        self.refuse_replay = False
        self.dead = False
        self.generation = 0
        self.submitted = []
        self.events = []
        self.versions: dict = {}
        self.rolled: list = []

    @property
    def _version(self):
        return self.versions.get("g", 1)

    @_version.setter
    def _version(self, v):
        self.versions["g"] = v

    def submit(self, src, dst, graph=None):
        if self.dead:
            raise self.pkg.ReplicaDead(self.name)
        if self.fail_submits:
            raise self.pkg.QueryError("stub refusing", kind="capacity",
                                      query=(src, dst))
        self.submitted.append((graph, src, dst))
        if self.fail_tickets:
            return _StubTicket(src, dst, error=self.pkg.QueryError(
                "stub ticket failure", kind="internal",
                query=(src, dst),
            ))
        return _StubTicket(
            src, dst,
            result=self.pkg.BFSResult(True, src + dst, None, None, 0.0, 0, 0),
        )

    def wait_ticket(self, t, timeout=None):
        if t.error is not None:
            raise t.error
        return t.result

    def flush(self, timeout=None):
        self.events.append("flush")

    def load(self):
        return self._load

    def health(self):
        if self.dead:
            raise self.pkg.ReplicaDead(self.name)
        return {"state": self.state}

    def stats(self):
        return {}

    def version(self, graph=None):
        if self.dead:
            raise self.pkg.ReplicaDead(self.name)
        return self.versions.get(str(graph or ""), 1)

    def begin_drain(self):
        self.events.append("begin_drain")
        return True

    def end_drain(self):
        self.events.append("end_drain")
        return True

    def roll(self, graph=None, adds=(), dels=()):
        self.events.append(("roll", graph, len(adds), len(dels)))
        if self.dead:
            raise self.pkg.ReplicaDead(self.name)
        if self.fail_roll:
            # the mid-roll crash: the process dies between acks and swap
            self.dead = True
            raise self.pkg.ReplicaDead(f"{self.name} died mid-roll")
        if self.refuse_replay:
            raise ValueError("duplicate adds refused")
        key = str(graph or "")
        self.versions[key] = self.version(graph) + (1 if adds or dels else 0)
        self.rolled.append((key, tuple(map(tuple, adds)),
                            tuple(map(tuple, dels))))
        return self.versions[key]

    def probe(self, graph=None, timeout=5.0):
        self.events.append("probe")
        return not self.dead

    def kill(self):
        self.dead = True

    def restart(self):
        self.dead = False
        self.generation += 1
        if not self.durable:
            self.versions = {}

    def close(self):
        self.events.append("close")


def _stub_router(k=3, **kw):
    stubs = [StubReplica(f"s{i}") for i in range(k)]
    kw.setdefault("poll_interval_s", 0.05)
    return Router(stubs, **kw), stubs


def test_hash_affinity_is_stable():
    router, stubs = _stub_router()
    try:
        owners = {g: router.owner(g) for g in ("a", "b", "c", "d")}
        for g, owner in owners.items():
            for _ in range(5):
                t = router.submit(1, 2, g)
                assert t.replica == owner  # idle fleet: pure affinity
    finally:
        router.close(close_replicas=False)


def test_degraded_demoted_dead_ejected_readmitted():
    router, stubs = _stub_router(2)
    try:
        owner = router.owner("g")
        other = next(s for s in stubs if s.name != owner)
        owner_stub = next(s for s in stubs if s.name == owner)
        owner_stub.state = "degraded"
        router._poll_once()
        assert router.submit(1, 2, "g").replica == other.name
        owner_stub.state = "ready"
        owner_stub.dead = True
        router._poll_once()
        assert router.table()[owner] == "dead"
        assert router.submit(1, 2, "g").replica == other.name
        owner_stub.dead = False
        router._poll_once()
        assert router.table()[owner] == "ready"
        assert router.submit(1, 2, "g").replica == owner
    finally:
        router.close(close_replicas=False)


def test_submit_failure_reroutes_and_counts():
    router, stubs = _stub_router(3)
    try:
        owner = router.owner("g")
        owner_stub = next(s for s in stubs if s.name == owner)
        owner_stub.fail_submits = True
        before = router.stats()["reroutes"]
        t = router.submit(3, 4, "g")
        assert t.replica != owner
        assert t.wait(timeout=5.0).hops == 7
        assert router.stats()["reroutes"] > before
    finally:
        router.close(close_replicas=False)


def test_ticket_failure_reroutes_on_wait():
    router, stubs = _stub_router(2, retry=RetryPolicy(attempts=3))
    try:
        owner = router.owner("g")
        owner_stub = next(s for s in stubs if s.name == owner)
        owner_stub.fail_tickets = True
        t = router.submit(3, 4, "g")
        assert t.replica == owner
        res = t.wait(timeout=10.0)
        assert res.hops == 7 and t.replica != owner
        assert t.attempts == 2
    finally:
        router.close(close_replicas=False)


def test_invalid_never_reroutes():
    router, stubs = _stub_router(2)
    try:
        owner = router.owner("g")
        owner_stub = next(s for s in stubs if s.name == owner)
        orig = owner_stub.submit

        def bad_submit(src, dst, graph=None):
            raise ValueError("src/dst out of range")

        owner_stub.submit = bad_submit
        with pytest.raises(ValueError):
            router.submit(999, 999, "g")
        owner_stub.submit = orig
    finally:
        router.close(close_replicas=False)


def test_all_dead_raises_capacity():
    router, stubs = _stub_router(2)
    try:
        for s in stubs:
            s.dead = True
        router._poll_once()
        with pytest.raises(QueryError) as exc:
            router.submit(1, 2, "g")
        assert exc.value.kind == "capacity"
    finally:
        router.close(close_replicas=False)


def test_spill_to_least_loaded():
    router, stubs = _stub_router(3, spill_after=4)
    try:
        owner = router.owner("hot")
        for s in stubs:
            s._load = 0 if s.name != owner else 100
        before = router.stats()["spills"]
        t = router.submit(1, 2, "hot")
        assert t.replica != owner
        assert router.stats()["spills"] == before + 1
    finally:
        router.close(close_replicas=False)


def test_rolling_swap_choreography_and_metrics():
    router, stubs = _stub_router(2)
    try:
        out = router.rolling_swap("g", adds=[(0, 1)], dels=[])
        assert out["ok"], out
        assert router.stats()["rolls"] == 1
        for s in stubs:
            # drain -> flush -> roll -> end_drain -> probe, in order
            assert s.events[0] == "begin_drain"
            assert "flush" in s.events
            roll_i = s.events.index(("roll", "g", 1, 0))
            assert s.events.index("end_drain") > roll_i
            assert "probe" in s.events
            assert s._version == 2
        for row in out["replicas"]:
            assert row["version"] == [1, 2]
        text = REGISTRY.render()
        for fam in ("bibfs_fleet_replicas", "bibfs_fleet_routed_total",
                    "bibfs_fleet_reroutes_total",
                    "bibfs_fleet_rolls_total",
                    "bibfs_fleet_spills_total"):
            assert fam in text, fam
    finally:
        router.close(close_replicas=False)


# ---- real in-process replicas ---------------------------------------

def _make_engine_replica(idx, graphs=("a",), pkg=PORT, **kw):
    store = pkg.GraphStore(compact_threshold=None)
    for g in graphs:
        store.add(g, N, EDGES)
    kw.setdefault("cache_entries", 8)
    kw.setdefault("max_batch", 16)
    return pkg.engine_replica(f"r{idx}", store, **pkg.dev, **kw)


def test_engine_fleet_serves_correctly():
    router = Router(
        [_make_engine_replica(i, ("a", "b")) for i in range(3)],
        poll_interval_s=0.1,
    )
    try:
        pairs = [(0, 50), (3, 40), (11, 70), (2, 2)]
        for g in ("a", "b"):
            results = router.query_many(pairs, graph=g)
            for (s, d), res in zip(pairs, results):
                ref = solve_serial(N, EDGES, s, d)
                assert res.found == ref.found
                assert res.hops == ref.hops, (g, s, d)
    finally:
        router.close()


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_engine_fleet_kill_restart_reroute():
    router = Router(
        [_make_engine_replica(i) for i in range(3)],
        poll_interval_s=0.1,
    )
    try:
        owner = router.owner("a")
        t = router.submit(0, 50, "a")
        assert t.replica == owner
        router.replica(owner).kill()
        ref = solve_serial(N, EDGES, 0, 50)
        assert t.wait(timeout=30.0).hops == ref.hops
        assert t.replica != owner
        assert router.stats()["reroutes"] > 0
        assert _wait(lambda: router.table()[owner] == "dead", 5.0)
        assert router.submit(3, 40, "a").replica != owner
        router.replica(owner).restart()
        assert _wait(lambda: router.table()[owner] == "ready", 5.0)
        assert router.query(5, 60, "a").hops == solve_serial(
            N, EDGES, 5, 60
        ).hops
    finally:
        router.close()


def test_engine_fleet_rolling_swap_mixed_versions():
    router = Router(
        [_make_engine_replica(i) for i in range(2)],
        poll_interval_s=0.1,
    )
    try:
        ref_v1 = solve_serial(N, EDGES, 0, N - 1)
        t0 = router.submit(0, N - 1, "a")
        assert t0.wait(timeout=30.0).hops == ref_v1.hops
        assert t0.declared_version == 1
        out = router.rolling_swap("a", adds=[(0, N - 1)], dels=[])
        assert out["ok"], out
        for name in router.replica_names:
            assert router.replica(name).version("a") == 2
        t1 = router.submit(0, N - 1, "a")
        assert t1.wait(timeout=30.0).hops == 1  # the added shortcut
        assert t1.declared_version == 2
    finally:
        router.close()


def test_engine_fleet_drain_reroutes_live_traffic():
    router = Router(
        [_make_engine_replica(i) for i in range(2)],
        poll_interval_s=0.05,
    )
    try:
        owner = router.owner("a")
        router.replica(owner).begin_drain()
        for _ in range(4):
            t = router.submit(0, 50, "a")
            assert t.replica != owner
            assert t.wait(timeout=30.0) is not None
        router.replica(owner).end_drain()
    finally:
        router.close()


QUICK_FLEET = dict(
    replicas=3, graphs=4, grid=(16, 16), queries=120, qps_repeats=1,
    chaos_queries=120, chaos_span_s=2.0, hot_pool=8, cache_entries=16,
    qps_factor=None, recovery_bound_s=30.0, burst_queries=60, seed=0,
)


@pytest.mark.slow
def test_run_fleet_harness_end_to_end():
    """A miniature fleet soak through the port's harness on CPU engines:
    qps phases (ratio reported), kill/restart with recovery, a rolling
    swap under load, a spill burst, live /metrics — zero lost, all
    verified."""
    from bibfs_tpu_torch.serve.loadgen import run_fleet

    out = run_fleet(
        replicas=3, graphs=6, grid=(24, 24), queries=300,
        chaos_queries=240, chaos_span_s=6.0, hot_pool=12,
        cache_entries=16, qps_factor=None, recovery_bound_s=30.0,
        burst_queries=90, device="cpu",
    )
    assert out["zero_lost"], out["tickets"]
    assert out["zero_failed"], out["failed_sample"]
    assert out["verified_vs_truth"], out["mismatches"]
    assert out["recovery_ok"], out["chaos"]
    assert out["roll_ok"], out["roll"]
    assert out["reroutes_ok"] and out["spill_ok"]
    assert out["metrics_ok"], out["metrics"]
    assert out["ok"]


# ---- subprocess replicas --------------------------------------------

@pytest.mark.slow
def test_process_replica_fleet(tmp_path):
    """Real ``bibfs-torch-serve --device cpu`` children behind the
    router: routing, the control surface, a REAL process kill, restart
    and re-admission."""
    from bibfs_tpu_torch.fleet import ProcessReplica
    from bibfs_tpu_torch.graph.io import write_graph_bin

    gpath = tmp_path / "g.bin"
    write_graph_bin(gpath, N, EDGES)
    router = Router(
        [ProcessReplica(f"p{i}", str(gpath), device="cpu",
                        spawn_timeout_s=SPAWN_S) for i in range(2)],
        poll_interval_s=0.2,
    )
    try:
        pairs = [(0, 50), (3, 40), (0, N - 1)]
        for (s, d), res in zip(pairs, router.query_many(pairs)):
            assert res.hops == solve_serial(N, EDGES, s, d).hops
        st = router.replica(router.owner(None)).stats()
        assert st["queries"] >= 1
        t = router.submit(5, 60)
        victim = t.replica
        router.replica(victim).kill()
        assert t.wait(timeout=60.0).hops == solve_serial(
            N, EDGES, 5, 60
        ).hops
        assert t.replica != victim
        router.replica(victim).restart()
        assert _wait(lambda: router.table()[victim] == "ready", 30.0)
    finally:
        router.close()


@pytest.mark.slow
def test_process_replica_store_rolling_swap(tmp_path):
    """A rolling swap across ``--store`` children: the batch lands
    through each child's stdin (``use``/``update``/``swap``), versions
    advance, and a refused ``use`` fails its query instead of answering
    it on the previous graph."""
    from bibfs_tpu_torch.fleet import ProcessReplica
    from bibfs_tpu_torch.graph.io import write_graph_bin

    store_dir = tmp_path / "store"
    store_dir.mkdir()
    write_graph_bin(store_dir / "a.bin", N, EDGES)
    router = Router(
        [ProcessReplica(f"p{i}", store_dir=str(store_dir), device="cpu",
                        spawn_timeout_s=SPAWN_S) for i in range(2)],
        poll_interval_s=0.2,
    )
    try:
        ref = solve_serial(N, EDGES, 0, N - 1)
        assert router.query(0, N - 1, "a").hops == ref.hops
        out = router.rolling_swap("a", adds=[(0, N - 1)], dels=[])
        assert out["ok"], out
        for row in out["replicas"]:
            assert row["version"] == [1, 2]
        assert router.query(0, N - 1, "a").hops == 1
        rep = router.replica("p0")
        bad = rep.submit(0, 5, "nope")
        with pytest.raises(QueryError) as exc:
            rep.wait_ticket(bad, timeout=30.0)
        assert exc.value.kind == "invalid"
        edges_v2 = np.vstack([EDGES, [[0, N - 1]]])
        assert rep.wait_ticket(
            rep.submit(0, 50, "a"), timeout=30.0
        ).hops == solve_serial(N, edges_v2, 0, 50).hops
    finally:
        router.close()


# ---- NetReplica children (the counterparts of test_serve_net.py) -----

def test_net_replica_fleet(tmp_path):
    """``NetReplica`` children (``bibfs-torch-serve --port 0 --device
    cpu``) behind the router: routing exactness, the framed control
    surface, a REAL SIGKILL (pending tickets fail structured and
    re-route), restart and re-admission."""
    from bibfs_tpu_torch.fleet import NetReplica
    from bibfs_tpu_torch.graph.io import write_graph_bin

    gpath = tmp_path / "g.bin"
    write_graph_bin(gpath, N, EDGES)
    router = Router(
        [NetReplica(f"n{i}", str(gpath), device="cpu",
                    spawn_timeout_s=SPAWN_S) for i in range(2)],
        poll_interval_s=0.2,
    )
    try:
        pairs = [(0, 50), (3, 40), (0, N - 1)]
        for (s, d), res in zip(pairs, router.query_many(pairs)):
            assert res.hops == solve_serial(N, EDGES, s, d).hops
        owner = router.replica(router.owner(None))
        assert owner.stats()["queries"] >= 1
        assert owner.health()["state"] in ("ready", "degraded")
        gen0 = owner.generation
        with pytest.raises(ValueError):
            owner.memory()  # a fixed-graph child has no store
        t = router.submit(5, 60)
        victim = t.replica
        router.replica(victim).kill()
        assert t.wait(timeout=60.0).hops == solve_serial(
            N, EDGES, 5, 60
        ).hops
        assert t.replica != victim
        router.replica(victim).restart()
        assert _wait(lambda: router.table()[victim] == "ready", 60.0)
        assert router.replica(victim).generation >= 1
        assert owner.generation == gen0 or owner.name == victim
    finally:
        router.close()


def test_net_replica_store_rolling_swap(tmp_path):
    """A rolling swap across ``--store`` NetReplica children: one framed
    ``roll`` a child, versions advance, a bad graph name fails
    structured, and a live update lands through one framed request."""
    from bibfs_tpu_torch.fleet import NetReplica
    from bibfs_tpu_torch.graph.io import write_graph_bin

    store_dir = tmp_path / "store"
    store_dir.mkdir()
    write_graph_bin(store_dir / "a.bin", N, EDGES)
    router = Router(
        [NetReplica(f"n{i}", store_dir=str(store_dir), device="cpu",
                    spawn_timeout_s=SPAWN_S) for i in range(2)],
        poll_interval_s=0.2,
    )
    try:
        ref = solve_serial(N, EDGES, 0, N - 1)
        assert router.query(0, N - 1, "a").hops == ref.hops
        out = router.rolling_swap("a", adds=[(0, N - 1)], dels=[])
        assert out["ok"], out
        for row in out["replicas"]:
            assert row["version"] == [1, 2]
        assert router.query(0, N - 1, "a").hops == 1
        rep = router.replica("n0")
        bad = rep.submit(0, 5, "nope")
        with pytest.raises(QueryError) as exc:
            rep.wait_ticket(bad, timeout=30.0)
        assert exc.value.kind == "invalid"
        edges_v2 = np.vstack([EDGES, [[0, N - 1]]])
        assert rep.wait_ticket(
            rep.submit(0, 50, "a"), timeout=30.0
        ).hops == solve_serial(N, edges_v2, 0, 50).hops
        rep.update("a", adds=[(1, 70)], dels=[])
        edges_v3 = np.vstack([edges_v2, [[1, 70]]])
        assert rep.wait_ticket(
            rep.submit(1, 70, "a"), timeout=30.0
        ).hops == solve_serial(N, edges_v3, 1, 70).hops
    finally:
        router.close()


def test_net_replica_close_is_graceful(tmp_path):
    """``close()`` SIGTERMs the child and it exits 0 after answering."""
    from bibfs_tpu_torch.fleet import NetReplica
    from bibfs_tpu_torch.graph.io import write_graph_bin

    gpath = tmp_path / "g.bin"
    write_graph_bin(gpath, N, EDGES)
    rep = NetReplica("g0", str(gpath), device="cpu", spawn_timeout_s=SPAWN_S)
    try:
        res = rep.wait_ticket(rep.submit(0, 50), timeout=60.0)
        assert res.hops == solve_serial(N, EDGES, 0, 50).hops
    finally:
        rep.close()
    assert rep._proc.returncode == 0


def test_children_without_a_card_fail_their_spawn(tmp_path):
    """A child asked for ``--device cuda`` where there is no card exits
    before its readiness reply: the spawn raises ``ReplicaDead`` (it
    never serves on the CPU), for both subprocess replica classes."""
    import torch

    from bibfs_tpu_torch.fleet import NetReplica, ProcessReplica
    from bibfs_tpu_torch.graph.io import write_graph_bin

    if torch.cuda.is_available():
        pytest.skip("a card is present: the child would serve on it")
    gpath = tmp_path / "g.bin"
    write_graph_bin(gpath, N, EDGES)
    for cls in (ProcessReplica, NetReplica):
        with pytest.raises(ReplicaDead):
            cls("c0", str(gpath), spawn_timeout_s=SPAWN_S)  # device cuda


# ---- the two packages side by side ----------------------------------

BOTH = ("ref", "port")


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_owner_parity_200_names(k):
    """The hash ring gives every one of 200 seeded graph names the same
    owner in both packages, and the same ring walk with replicas out."""
    rng = np.random.default_rng(k)
    names = [f"g{int(x)}" for x in rng.integers(0, 10**9, size=200)]
    names[0] = ""  # the default graph's key
    routers = [
        _pkg(p).Router([StubReplica(f"r{i}", _pkg(p)) for i in range(k)],
                       poll_interval_s=3600.0)
        for p in BOTH
    ]
    try:
        owners = [[r.owner(g or None) for g in names] for r in routers]
        assert owners[0] == owners[1]
        avail = {f"r{i}" for i in range(0, k, 2)}
        walks = [[r._ring_walk(g, avail) for g in names] for r in routers]
        assert walks[0] == walks[1]
    finally:
        for r in routers:
            r.close(close_replicas=False)


def _scripted_run(which: str) -> list:
    """One scripted sequence of stub replicas through a router of the
    given package, read after every step: the routing table, the
    reroute, spill, roll and catch-up counts, the committed versions,
    the replicas held for catch-up, where each query went, and which
    batches each stub replayed. The background poller is parked, so
    every poll is the script's own."""
    pkg = _pkg(which)
    stubs = [StubReplica(f"s{i}", pkg, durable=(i != 2)) for i in range(4)]
    router = pkg.Router(stubs, poll_interval_s=3600.0, spill_after=8,
                        retry=pkg.RetryPolicy(attempts=3, base_ms=0.1,
                                              max_ms=0.2, seed=0))
    by = {s.name: s for s in stubs}
    names = [f"g{i}" for i in range(10)]
    trail: list = []

    def snap(tag, routed=()):
        st = router.stats()
        trail.append({
            "tag": tag,
            "table": router.table(),
            "reroutes": st["reroutes"],
            "spills": st["spills"],
            "rolls": st["rolls"],
            "catchups": st["catchups"],
            "committed": st["committed"],
            "pending": sorted(st["pending_catchup"]),
            "routed": list(routed),
            "rolled": {s.name: list(s.rolled) for s in stubs},
            "versions": {s.name: dict(s.versions) for s in stubs},
        })

    def send(tag, k=20):
        out = []
        for i in range(k):
            g = names[i % len(names)]
            try:
                t = router.submit(i, i + 1, g)
                res = t.wait(timeout=10.0)
                out.append((g, t.replica, t.attempts, res.hops,
                            t.declared_version))
            except Exception as e:  # noqa: BLE001 - the outcome is compared
                out.append((g, type(e).__name__, getattr(e, "kind", None)))
        snap(tag, out)

    try:
        send("start")
        by["s0"].state = "degraded"
        by["s1"].state = "draining"
        router._poll_once()
        send("degraded+draining")
        by["s0"].state = by["s1"].state = "ready"
        router._poll_once()
        by["s3"].dead = True  # ejected at submit, ahead of the poll
        send("dead at submit")
        router._poll_once()
        snap("dead polled")
        by["s3"].dead = False
        router._poll_once()
        by["s0"].fail_tickets = True
        send("failing tickets")
        by["s0"].fail_tickets = False
        for s in stubs:
            s._load = 100 if s.name == "s1" else 3
        send("spill")
        for s in stubs:
            s._load = 0
        out = router.rolling_swap("g", adds=[(0, 1)], dels=[(2, 3)])
        snap("roll", [(r["replica"], r["ok"], r.get("version"),
                       r.get("error")) for r in out["replicas"]])
        by["s1"].fail_roll = True
        out = router.rolling_swap("g", adds=[(4, 5)])
        snap("mid-roll crash", [(r["replica"], r["ok"], r.get("version"),
                                 r.get("error")) for r in out["replicas"]])
        by["s1"].fail_roll = False
        router._poll_once()
        snap("crash polled")
        # s2 (non-durable) dies and respawns between two polls: its
        # versions are lost, the generation moved, the poll replays
        by["s2"].kill()
        by["s2"].restart()
        router._poll_once()
        snap("respawn between polls")
        # s1 comes back with the crashed batch re-armed: the replay is
        # refused and it stays held
        by["s1"].restart()
        by["s1"].refuse_replay = True
        router._poll_once()
        router._poll_once()
        snap("refused replay")
        by["s1"].refuse_replay = False
        router._poll_once()
        send("after repair")
    finally:
        router.close(close_replicas=False)
    return trail


def test_scripted_sequence_parity():
    """The same scripted sequence of stub replicas gives the same
    routing-table states, reroutes, spills, rolls, catch-up decisions and
    replays in both packages, step by step."""
    ref, port = _scripted_run("ref"), _scripted_run("port")
    assert [s["tag"] for s in ref] == [s["tag"] for s in port]
    for a, b in zip(ref, port):
        assert a == b, a["tag"]
    # the script reached what it is for
    tags = {s["tag"]: s for s in port}
    assert tags["dead at submit"]["table"]["s3"] == "dead"
    assert tags["spill"]["spills"] > tags["failing tickets"]["spills"]
    assert tags["refused replay"]["table"]["s1"] == "catchup"
    assert tags["respawn between polls"]["rolled"]["s2"]
    assert tags["after repair"]["table"]["s1"] == "ready"


def _fresh(rng, k: int, used: set) -> list:
    """``k`` seeded pairs whose endpoints no earlier pair used."""
    out = []
    while len(out) < k:
        s, d = (int(x) for x in rng.integers(0, N, size=2))
        if s != d and s not in used and d not in used:
            used.update((s, d))
            out.append((s, d))
    return out


FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")


def _fields(r) -> tuple:
    return tuple(getattr(r, f) for f in FIELDS)


#: every flush on the host route: the same solver behind every answer
HOST_ONLY = {"cache_entries": 0, "flush_threshold": 1 << 20}


def _swap_fleet_run(which: str, before, during, after, adds, dels):
    """An engine fleet of the given package (3 replicas over their own
    stores, no distance cache, so every answer is a solve, and every
    flush on the host route): answers of
    ``before``, of ``during`` submitted from a thread while a rolling
    swap runs, and of ``after``, with each ticket's declared version;
    and the answers of single engines over the graph at each version."""
    pkg = _pkg(which)
    router = pkg.Router(
        [_make_engine_replica(i, ("a",), pkg, **HOST_ONLY)
         for i in range(3)],
        poll_interval_s=0.05,
    )
    out = {}
    try:
        def answers(pairs):
            ts = [router.submit(s, d, "a") for s, d in pairs]
            return [(t.declared_version, _fields(t.wait(timeout=60.0)))
                    for t in ts]

        out["before"] = answers(before)
        got: list = []
        stop = threading.Event()

        def traffic():
            for s, d in during:
                if stop.is_set():
                    break
                t = router.submit(s, d, "a")
                got.append((t.declared_version, _fields(t.wait(timeout=60.0))))

        th = threading.Thread(target=traffic)
        th.start()
        roll = router.rolling_swap("a", adds=adds, dels=dels)
        th.join(timeout=120.0)
        stop.set()
        assert not th.is_alive()
        assert roll["ok"], roll
        out["during"] = got
        out["after"] = answers(after)
    finally:
        router.close()
    truth = {}
    for v in (1, 2):
        store = pkg.GraphStore(compact_threshold=None)
        store.add("a", N, EDGES)
        if v == 2:
            store.roll("a", adds=adds, dels=dels)
        eng = pkg.QueryEngine(store=store, **HOST_ONLY, **pkg.dev)
        try:
            truth[v] = [_fields(r) for r in eng.query_many(during)]
        finally:
            eng.close()
            store.close()
    out["truth"] = truth
    return out


def test_engine_fleet_answers_parity_across_rolling_swap():
    """Both packages' engine fleets answer the same seeded pairs with the
    same found, hops, path, meet, levels and edges_scanned before, during
    and after a rolling swap: each answer equals the other package's
    answer for the version its replica declared."""
    rng = np.random.default_rng(25)
    used: set = set()
    before, after = _fresh(rng, 6, used), _fresh(rng, 6, used)
    during = [(int(s), int(d)) for s, d in rng.integers(0, N, size=(60, 2))]
    adds, dels = [(0, N - 1), (3, 60)], [(10, 11)]
    runs = {p: _swap_fleet_run(p, before, during, after, adds, dels)
            for p in BOTH}
    ref, port = runs["ref"], runs["port"]
    assert port["before"] == ref["before"]
    assert {v for v, _ in port["before"]} == {1}
    assert port["after"] == ref["after"]
    assert {v for v, _ in port["after"]} == {2}
    assert port["truth"] == ref["truth"]
    assert port["truth"][1] != port["truth"][2]  # the roll changed answers
    for mine, other in (("port", "ref"), ("ref", "port")):
        assert len(runs[mine]["during"]) == len(during)
        for i, (v, fields) in enumerate(runs[mine]["during"]):
            assert v in (1, 2)
            assert fields == runs[other]["truth"][v][i], (mine, during[i], v)


def test_run_fleet_quick_parity():
    """``run_fleet`` in its quick shape on the same seed in both packages
    (the port on CPU engines): every correctness and recovery gate holds
    in both, and the correctness sections are equal (lost and failed
    tickets, answers exact for their declared versions, the roll's
    outcome per replica, the answers the roll changed)."""
    from bibfs_tpu.serve.loadgen import run_fleet as ref_run
    from bibfs_tpu_torch.serve.loadgen import run_fleet as port_run

    outs = [ref_run(**QUICK_FLEET), port_run(**QUICK_FLEET, device="cpu")]

    def section(o):
        return {
            "lost": o["tickets"]["lost"],
            "failed": o["tickets"]["failed"],
            "stranded": o["tickets"]["stranded_outstanding"],
            "submitted": o["tickets"]["submitted"],
            "mismatches": o["mismatches"],
            "audit": o["truth_audit_mismatches"],
            "roll": [(r["replica"], r["ok"], r["version"])
                     for r in o["roll"]["replicas"]],
            "roll_ok": o["roll"]["ok"],
            "changed": o["roll"]["changed_answers"],
            "post_versions": o["roll"]["post_versions"],
            "victim": o["chaos"]["victim"],
            "gates": {k: o[k] for k in (
                "zero_lost", "zero_failed", "verified_vs_truth",
                "recovery_ok", "roll_ok", "reroutes_ok", "spill_ok",
                "metrics_ok", "ok")},
        }

    ref, port = section(outs[0]), section(outs[1])
    assert port == ref
    assert all(port["gates"].values()), outs[1]
    assert port["changed"] > 0
