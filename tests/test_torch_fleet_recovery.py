"""The PyTorch port's fleet catch-up re-admission and durable replica
respawn on the CPU, every case of the JAX package's
``tests/test_fleet_recovery.py``: the router holds a recovering replica
out of the table until its declared version reaches the fleet's
committed one (replaying missed rolls from its bounded history), and a
durable ``ProcessReplica`` (a ``bibfs-torch-serve --store DIR --durable
--device cpu`` child) respawns at its latest acked state instead of the
stale v1 seed. Every wait has a timeout; a spawned child has its
``spawn_timeout_s``."""

import time

import numpy as np
import pytest

from bibfs_tpu_torch.fleet import ReplicaDead, Router, engine_replica
from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.solvers.api import BFSResult
from bibfs_tpu_torch.solvers.serial import solve_serial
from bibfs_tpu_torch.store import GraphStore

SPAWN_S = 120.0  # a child's spawn bound (import, store recovery, engine)


def _skiplink_graph(n: int) -> np.ndarray:
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


N = 80
EDGES = _skiplink_graph(N)


class _Ticket:
    def __init__(self, src, dst):
        self.src, self.dst = src, dst
        self.result = BFSResult(True, src + dst, None, None, 0.0, 0, 0)
        self.error = None


class VersionedStub:
    """Replica double with a real per-graph version ledger and an
    incarnation counter — ``kill``/``restart`` optionally LOSES the
    versions (the non-durable respawn) so the catch-up path has
    something to repair."""

    kind = "stub"

    def __init__(self, name, *, durable=True):
        self.name = name
        self.durable = durable
        self.generation = 0
        self.dead = False
        self.versions: dict = {}
        self.rolled: list = []

    def _v(self, graph):
        return self.versions.get(str(graph or ""), 1)

    def submit(self, src, dst, graph=None):
        if self.dead:
            raise ReplicaDead(self.name)
        return _Ticket(src, dst)

    def wait_ticket(self, t, timeout=None):
        return t.result

    def flush(self, timeout=None):
        pass

    def load(self):
        return 0

    def health(self):
        if self.dead:
            raise ReplicaDead(self.name)
        return {"state": "ready"}

    def stats(self):
        return {}

    def version(self, graph=None):
        if self.dead:
            raise ReplicaDead(self.name)
        return self._v(graph)

    def begin_drain(self):
        return True

    def end_drain(self):
        return True

    def roll(self, graph=None, adds=(), dels=()):
        if self.dead:
            raise ReplicaDead(self.name)
        key = str(graph or "")
        self.versions[key] = self._v(graph) + (1 if adds or dels else 0)
        self.rolled.append((key, tuple(adds), tuple(dels)))
        return self.versions[key]

    def probe(self, graph=None, timeout=5.0):
        return not self.dead

    def kill(self):
        self.dead = True

    def restart(self):
        self.dead = False
        self.generation += 1
        if not self.durable:
            self.versions = {}  # the stale-v1 respawn

    def close(self):
        pass


def _router(stubs, **kw):
    kw.setdefault("poll_interval_s", 0.05)
    return Router(stubs, **kw)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_catchup_replays_missed_roll_before_readmission():
    """A non-durable replica killed after a committed roll respawns at
    v1: the poller must hold it in ``catchup`` and replay the missed
    batch from the roll history before re-admitting it."""
    stubs = [VersionedStub(f"s{i}", durable=False) for i in range(3)]
    router = _router(stubs)
    try:
        out = router.rolling_swap("a", adds=[(0, 1)], dels=[])
        assert out["ok"]
        assert router.stats()["committed"] == {"a": 2}
        victim = stubs[0]
        victim.kill()
        assert _wait(lambda: router.table()["s0"] == "dead")
        pre_rolls = len(victim.rolled)
        victim.restart()  # versions lost: back at v1
        assert _wait(lambda: router.table()["s0"] == "ready")
        # the router repaired it from history, THEN re-admitted
        assert victim.version("a") == 2
        assert len(victim.rolled) == pre_rolls + 1
        assert victim.rolled[-1] == ("a", ((0, 1),), ())
        assert router.stats()["catchups"] >= 1
    finally:
        router.close()


def test_catchup_detects_respawn_between_polls():
    """A kill+restart faster than one poll tick never shows a ``dead``
    table state — the incarnation (generation) change alone must
    trigger the catch-up check."""
    stubs = [VersionedStub(f"s{i}", durable=False) for i in range(2)]
    router = _router(stubs, poll_interval_s=0.2)
    try:
        assert router.rolling_swap("a", adds=[(0, 1)], dels=[])["ok"]
        victim = stubs[1]
        victim.kill()
        victim.restart()  # well inside one poll interval
        assert _wait(lambda: victim.version("a") == 2)
        assert router.stats()["catchups"] >= 1
    finally:
        router.close()


def test_catchup_holds_replica_beyond_history():
    """A replica lagging further than the retained roll history can
    NEVER be repaired from it — it must stay in ``catchup`` (visible,
    not routable), not be silently re-admitted stale."""
    from bibfs_tpu_torch.fleet.router import ROLL_HISTORY_MAX

    stubs = [VersionedStub(f"s{i}", durable=False) for i in range(2)]
    router = _router(stubs)
    try:
        for i in range(ROLL_HISTORY_MAX + 2):
            assert router.rolling_swap("a", adds=[(0, i + 1)])["ok"]
        victim = stubs[0]
        victim.kill()
        assert _wait(lambda: router.table()["s0"] == "dead")
        victim.restart()  # v1; history starts at v4: unbridgeable gap
        assert _wait(lambda: router.table()["s0"] == "catchup")
        time.sleep(0.3)  # several poll ticks: it must STAY held
        assert router.table()["s0"] == "catchup"
        assert victim.version("a") == 1  # nothing half-applied
        assert "s0" in router.stats()["pending_catchup"]
        # queries keep flowing on the healthy replica
        assert router.query(1, 2, "a") is not None
    finally:
        router.close()


def test_durable_restart_passes_catchup_without_repair():
    """A replica whose store survived (durable / in-process) declares
    the committed version on its own — catch-up verifies and admits
    without replaying anything."""
    stubs = [VersionedStub(f"s{i}", durable=True) for i in range(2)]
    router = _router(stubs)
    try:
        assert router.rolling_swap("a", adds=[(0, 1)])["ok"]
        victim = stubs[0]
        pre_rolls = len(victim.rolled)
        victim.kill()
        assert _wait(lambda: router.table()["s0"] == "dead")
        victim.restart()
        assert _wait(lambda: router.table()["s0"] == "ready")
        assert len(victim.rolled) == pre_rolls  # no repair needed
        assert router.stats()["catchups"] >= 1
    finally:
        router.close()


def test_midroll_crash_respawn_held_then_repaired_by_hatch():
    """The mid-roll-crash wedge, regression-pinned: a replica that
    died BETWEEN a roll's update acks and its swap respawns with the
    half-applied batch re-armed in its overlay, so the replay's
    duplicate adds are refused — the router must hold it in ``catchup``
    (safe-but-unroutable, with its stuck duration visible in
    ``pending_catchup``/``catchup_stuck()`` and the
    bibfs_fleet_catchup_stuck gauge), and the supervisor's escape hatch
    must repair the fleet with a full respawn from the durable store."""
    from bibfs_tpu_torch.fleet import ScalePolicy, Supervisor

    class MidRollStub(VersionedStub):
        def __init__(self, name):
            super().__init__(name, durable=False)
            self.rearmed = False

        def roll(self, graph=None, adds=(), dels=()):
            if self.rearmed:
                # the respawn re-armed the crashed batch, so the
                # catch-up replay's adds collide with the overlay
                raise ValueError("duplicate adds refused")
            return super().roll(graph, adds=adds, dels=dels)

        def restart(self):
            super().restart()
            self.rearmed = True

    stubs = [MidRollStub("s0"), VersionedStub("s1", durable=False)]
    router = _router(stubs)
    sup = None
    try:
        assert router.rolling_swap("a", adds=[(0, 1)])["ok"]
        committed = dict(router.stats()["committed"])
        victim = stubs[0]
        victim.kill()  # "between the update acks and the swap"
        assert _wait(lambda: router.table()["s0"] == "dead")
        victim.restart()  # batch re-armed; replay will be refused
        assert _wait(lambda: router.table()["s0"] == "catchup")
        time.sleep(0.3)  # several poll ticks: held, never re-admitted
        assert router.table()["s0"] == "catchup"
        assert victim.version("a") == 1  # nothing half-folded
        assert "s0" in router.stats()["pending_catchup"]
        assert _wait(lambda: router.catchup_stuck().get("s0", 0.0) > 0.2)
        assert "bibfs_fleet_catchup_stuck" in REGISTRY.render()
        # queries keep flowing around the held replica meanwhile
        assert router.query(1, 2, "a") is not None

        # the escape hatch: replace it with a fresh spawn from the
        # durable store (declares the committed versions on its own)
        def spawn(idx):
            fresh = VersionedStub(f"fresh{idx}", durable=True)
            fresh.versions = dict(committed)
            return fresh

        sup = Supervisor(
            router,
            spawn,
            policy=ScalePolicy(stuck_after_s=0.2),
            poll_interval_s=30.0,
        )
        sup.tick()
        assert _wait(lambda: "s0" not in router.replica_names)
        assert _wait(
            lambda: any(
                n.startswith("fresh")
                and router.table().get(n) == "ready"
                for n in router.replica_names
            )
        )
        assert ("repair", "catchup_stuck") in [
            (e["dir"], e["reason"]) for e in sup.events()
        ]
        assert router.query(1, 2, "a") is not None
    finally:
        if sup is not None:
            sup.close()
        router.close()


def test_no_committed_versions_readmits_as_before():
    """Without any committed roll, recovery re-admission works exactly
    as pre-catchup: ready as soon as health says so."""
    stubs = [VersionedStub(f"s{i}") for i in range(2)]
    router = _router(stubs)
    try:
        stubs[0].kill()
        assert _wait(lambda: router.table()["s0"] == "dead")
        stubs[0].restart()
        assert _wait(lambda: router.table()["s0"] == "ready")
        assert router.stats()["catchups"] == 0
        assert router.stats()["committed"] == {}
    finally:
        router.close()


def test_catchup_metric_family_renders():
    stubs = [VersionedStub("s0")]
    router = _router(stubs)
    try:
        render = REGISTRY.render()
        assert "bibfs_fleet_catchups_total" in render
    finally:
        router.close()


def test_engine_replica_restart_keeps_store_version():
    """The in-process replica's restart (same store object) declares the
    rolled version immediately — the catch-up check verifies it in one
    version read."""
    store = GraphStore(compact_threshold=None)
    store.add("a", N, EDGES)
    rep = engine_replica("r0", store, device="cpu")
    router = _router([rep])
    try:
        assert router.rolling_swap("a", adds=[(0, N - 1)])["ok"]
        rep.kill()
        rep.restart()
        assert rep.version("a") == 2
        assert _wait(
            lambda: router.table()["r0"] == "ready"
            and router.stats()["catchups"] >= 1
        )
        assert router.query(0, N - 1, "a").hops == 1
    finally:
        router.close()


@pytest.mark.slow
def test_process_replica_durable_respawn_serves_acked_update(tmp_path):
    """THE regression the durability layer exists for, at the
    ProcessReplica level: an update acked by a ``--durable --fsync
    always`` child, SIGKILL'd immediately after the ack, is provably
    served after the respawn (manifest + WAL replay recovery), not
    silently un-acked by a respawn from its seed at v1."""
    from bibfs_tpu_torch.fleet import ProcessReplica
    from bibfs_tpu_torch.graph.io import write_graph_bin

    store_dir = tmp_path / "store"
    store_dir.mkdir()
    write_graph_bin(store_dir / "a.bin", N, EDGES)
    rep = ProcessReplica("p0", store_dir=str(store_dir),
                         durable=True, fsync="always", device="cpu",
                         spawn_timeout_s=SPAWN_S)
    try:
        ref = solve_serial(N, EDGES, 0, N - 1)
        assert rep.wait_ticket(
            rep.submit(0, N - 1, "a"), timeout=60.0
        ).hops == ref.hops
        # acked (the update() return IS the child's ack reply, which a
        # fsync=always child prints only after the WAL fsync)...
        rep.update("a", adds=[(0, N - 1)])
        # ...then SIGKILL with zero gap
        rep.kill()
        rep.restart()
        assert rep.version("a") == 1  # overlay re-armed, not folded
        got = rep.wait_ticket(rep.submit(0, N - 1, "a"), timeout=60.0)
        assert got.hops == 1  # the acked update IS served post-respawn
        # and a fold after respawn carries it into v2
        assert rep.roll("a") == 2
        assert rep.wait_ticket(
            rep.submit(0, N - 1, "a"), timeout=60.0
        ).hops == 1
    finally:
        rep.close()


@pytest.mark.slow
def test_process_replica_nondurable_respawn_caught_up_by_router(
    tmp_path
):
    """A NON-durable subprocess respawns from its seed at v1 — the
    router's catch-up path must repair it from the roll
    history before re-admitting, so the fleet still never serves the
    stale version."""
    from bibfs_tpu_torch.fleet import ProcessReplica
    from bibfs_tpu_torch.graph.io import write_graph_bin

    store_dir = tmp_path / "store"
    store_dir.mkdir()
    write_graph_bin(store_dir / "a.bin", N, EDGES)
    rep = ProcessReplica("p0", store_dir=str(store_dir), device="cpu",
                         spawn_timeout_s=SPAWN_S)
    router = Router([rep], poll_interval_s=0.2)
    try:
        assert router.rolling_swap("a", adds=[(0, N - 1)])["ok"]
        rep.kill()
        rep.restart()
        assert _wait(
            lambda: router.stats()["catchups"] >= 1
            and router.table()["p0"] == "ready",
            timeout=30.0,
        )
        assert rep.version("a") == 2
        assert router.query(0, N - 1, "a").hops == 1
    finally:
        router.close()
