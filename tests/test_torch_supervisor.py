"""The PyTorch port's elastic fleet supervisor on the CPU, every case of
the JAX package's ``tests/test_supervisor.py``: the PURE autoscale
decision core (:func:`~bibfs_tpu_torch.fleet.supervisor.decide_scale`)
under scripted metric feeds — hysteresis, cooldown flap-damping, bound
holds — plus the control loop itself over stub replicas on a real
:class:`~bibfs_tpu_torch.fleet.Router`: warm-before-admission scale-out,
drain-before-retire scale-in that only ever victimizes
supervisor-spawned replicas, paced dead-replica respawn, the
catch-up-wedge escape hatch, and pod-worker heal callbacks over a fake
pod (``watch_pod`` is duck-typed) and over a real ``PodPrimary`` of each
package with scripted workers. Then both packages side by side:
``decide_scale`` returns the same verdicts and streaks over a grid of
signals, streaks, clocks and policies, and the fleet metric families a
router and a supervisor mint render with the same names, kinds, labels
and values."""

import itertools
import re
import time

import pytest

from bibfs_tpu_torch.fleet import (
    ReplicaDead,
    Router,
    ScalePolicy,
    Supervisor,
    Verdict,
    decide_scale,
)
from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.solvers.api import BFSResult


# ---- doubles ----------------------------------------------------------

class _Ticket:
    def __init__(self, src, dst):
        self.src, self.dst = src, dst
        self.result = BFSResult(True, src + dst, None, None, 0.0, 0, 0)
        self.error = None


class _Stub:
    """Replica double for supervisor loop tests: scriptable load, a
    version ledger (optionally lost on restart — the non-durable
    respawn the escape hatch exists for), and an event log."""

    kind = "stub"

    def __init__(self, name, *, durable=True, versions=None,
                 restart_fails=0):
        self.name = name
        self.durable = durable
        self.generation = 0
        self.dead = False
        self.wedged = False
        self._load = 0
        self.versions: dict = dict(versions or {})
        self.events: list = []
        self.restart_calls = 0
        self.restart_fails = int(restart_fails)

    def _v(self, graph):
        return self.versions.get(str(graph or ""), 1)

    def submit(self, src, dst, graph=None):
        if self.dead:
            raise ReplicaDead(self.name)
        return _Ticket(src, dst)

    def wait_ticket(self, t, timeout=None):
        return t.result

    def flush(self, timeout=None):
        self.events.append("flush")

    def load(self):
        return (1 << 30) if self.dead else self._load

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
        self.events.append("begin_drain")
        return True

    def end_drain(self):
        self.events.append("end_drain")
        return True

    def roll(self, graph=None, adds=(), dels=()):
        if self.dead:
            raise ReplicaDead(self.name)
        if self.wedged:
            # the mid-roll-crash respawn: the batch is re-armed in the
            # overlay, so the replay's duplicate adds are refused
            raise ValueError("duplicate adds refused")
        key = str(graph or "")
        self.versions[key] = self._v(graph) + (1 if adds or dels else 0)
        return self.versions[key]

    def probe(self, graph=None, timeout=5.0):
        self.events.append("probe")
        return not self.dead

    def kill(self):
        self.dead = True

    def restart(self):
        self.restart_calls += 1
        if self.restart_fails > 0:
            self.restart_fails -= 1
            raise RuntimeError("respawn infrastructure down")
        self.dead = False
        self.generation += 1
        if not self.durable:
            self.versions = {}

    def close(self):
        self.events.append("close")


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _fleet(k=2, **stub_kw):
    stubs = [_Stub(f"s{i}", **stub_kw) for i in range(k)]
    return Router(stubs, poll_interval_s=0.05), stubs


def _sup(router, spawn, **policy_kw):
    """A supervisor whose daemon thread is effectively parked (30 s
    poll): tests drive ticks deterministically via ``tick()``."""
    policy_kw.setdefault("cooldown_s", 0.0)
    policy_kw.setdefault("respawn_backoff_s", 10.0)
    return Supervisor(router, spawn, policy=ScalePolicy(**policy_kw),
                      poll_interval_s=30.0)


# ---- decide_scale: the pure decision core -----------------------------

def _decide(policy, replicas, signals, *, now=100.0, last=-1e9,
            streaks=(0, 0)):
    return decide_scale(policy, replicas=replicas, signals=signals,
                        now_s=now, last_scale_s=last,
                        out_streak=streaks[0], in_streak=streaks[1])


def _sig(q=0, p99=None, shed=None):
    return {"queue_depth": q, "p99_ms": p99, "shed_rate": shed}


def test_decide_queue_out_fires_only_after_settle():
    pol = ScalePolicy(queue_hi=10, queue_lo=2, settle_ticks=3)
    streaks = (0, 0)
    for tick in range(1, 3):  # two over-threshold ticks: not yet
        v, *streaks = _decide(pol, 1, _sig(q=50), streaks=streaks)
        assert v.action == "hold" and v.reason == "steady"
        assert streaks == [tick, 0]
    v, *streaks = _decide(pol, 1, _sig(q=50), streaks=streaks)
    assert v.action == "out" and v.reason == "queue"
    assert v.target == 2
    assert streaks == [0, 0]  # acting resets both counters


def test_decide_streak_resets_on_recovery():
    pol = ScalePolicy(queue_hi=10, queue_lo=2, settle_ticks=2)
    v, *streaks = _decide(pol, 1, _sig(q=50))
    assert streaks == [1, 0]
    # one tick back under the threshold erases the progress
    v, *streaks = _decide(pol, 1, _sig(q=5), streaks=streaks)
    assert streaks == [0, 0]
    v, *streaks = _decide(pol, 1, _sig(q=50), streaks=streaks)
    assert v.action == "hold" and streaks == [1, 0]


def test_decide_p99_and_shed_reasons():
    pol = ScalePolicy(queue_hi=1000, queue_lo=2, p99_hi_ms=50.0,
                      shed_hi=5.0, settle_ticks=1)
    v, *_ = _decide(pol, 1, _sig(q=3, p99=80.0))
    assert v.action == "out" and v.reason == "p99"
    v, *_ = _decide(pol, 1, _sig(q=3, shed=9.0))
    assert v.action == "out" and v.reason == "shed"
    # queue wins the precedence when both are over
    v, *_ = _decide(pol, 1, _sig(q=2000, p99=80.0))
    assert v.reason == "queue"
    # unconfigured thresholds never consult the signal
    pol2 = ScalePolicy(queue_hi=1000, queue_lo=2, settle_ticks=1)
    v, *_ = _decide(pol2, 2, _sig(q=3, p99=1e9, shed=1e9))
    assert v.action != "out"


def test_decide_cooldown_holds_and_preserves_streaks():
    pol = ScalePolicy(queue_hi=10, queue_lo=2, settle_ticks=1,
                      cooldown_s=5.0)
    v, *streaks = _decide(pol, 1, _sig(q=50), now=103.0, last=100.0)
    assert v.action == "hold" and v.reason == "cooldown"
    assert streaks == [1, 0]  # the streak SURVIVES the freeze...
    v, *streaks = _decide(pol, 1, _sig(q=50), now=105.5, last=100.0,
                          streaks=streaks)
    assert v.action == "out"  # ...so the verdict fires at expiry


def test_decide_bound_holds_win_over_cooldown():
    pol = ScalePolicy(min_replicas=1, max_replicas=2, queue_hi=10,
                      queue_lo=2, settle_ticks=1, cooldown_s=1e9)
    v, *_ = _decide(pol, 2, _sig(q=50), now=100.0, last=99.0)
    assert v.action == "hold" and v.reason == "at_max"
    v, *_ = _decide(pol, 1, _sig(q=0), now=100.0, last=99.0)
    assert v.action == "hold" and v.reason == "at_min"


def test_decide_scale_in_after_idle_settle():
    pol = ScalePolicy(queue_hi=10, queue_lo=2, settle_ticks=2)
    v, *streaks = _decide(pol, 3, _sig(q=1))
    assert v.action == "hold" and streaks == [0, 1]
    v, *streaks = _decide(pol, 3, _sig(q=1), streaks=streaks)
    assert v.action == "in" and v.reason == "idle"
    assert v.target == 2 and streaks == [0, 0]


def test_decide_p99_lo_blocks_scale_in():
    pol = ScalePolicy(queue_hi=100, queue_lo=10, p99_lo_ms=20.0,
                      settle_ticks=1)
    # queue is idle but the fleet is still slow: hold, don't shrink
    v, *streaks = _decide(pol, 3, _sig(q=1, p99=35.0))
    assert v.action == "hold" and streaks == [0, 0]
    v, *_ = _decide(pol, 3, _sig(q=1, p99=5.0))
    assert v.action == "in"


def test_decide_verdict_repr_and_policy_validation():
    assert "out" in repr(Verdict("out", "queue", 3))
    with pytest.raises(ValueError):
        ScalePolicy(min_replicas=0)
    with pytest.raises(ValueError):
        ScalePolicy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        ScalePolicy(queue_hi=4, queue_lo=9)


# ---- the control loop over stub replicas ------------------------------

def test_scale_out_warms_before_admission():
    router, stubs = _fleet(1)
    spawned = []

    def spawn(idx):
        s = _Stub(f"x{idx}")
        spawned.append(s)
        return s

    sup = _sup(router, spawn, max_replicas=3, queue_hi=8, queue_lo=1,
               settle_ticks=2)
    try:
        stubs[0]._load = 50
        sup.tick()
        assert list(router.replica_names) == ["s0"]  # settle tick 1: hold
        sup.tick()
        assert _wait(lambda: "x1" in router.replica_names)
        # ready-probed BEFORE admission, and recorded as ours
        assert "probe" in spawned[0].events
        assert sup.stats()["spawned"] == ["x1"]
        assert [(e["dir"], e["reason"]) for e in sup.events()] == [
            ("out", "queue")
        ]
    finally:
        sup.close()
        router.close()


def test_scale_in_drains_and_only_retires_supervisor_spawned():
    router, stubs = _fleet(1)
    extras = {}

    def spawn(idx):
        s = _Stub(f"x{idx}")
        extras[s.name] = s
        return s

    sup = _sup(router, spawn, max_replicas=3, queue_hi=8, queue_lo=1,
               settle_ticks=1)
    try:
        stubs[0]._load = 50
        sup.tick()
        assert _wait(lambda: len(router.replica_names) == 2)
        stubs[0]._load = 0
        sup.tick()
        assert _wait(lambda: list(router.replica_names) == ["s0"])
        victim = extras["x1"]
        assert "begin_drain" in victim.events  # drained, then closed:
        assert "close" in victim.events        # no acked ticket lost
        # the ORIGINAL (operator-provided) replica is never the victim
        sup.tick()
        assert list(router.replica_names) == ["s0"]
        dirs = [(e["dir"], e["reason"]) for e in sup.events()]
        assert dirs == [("out", "queue"), ("in", "idle")]
    finally:
        sup.close()
        router.close()


def test_cooldown_blocks_immediate_reversal():
    router, stubs = _fleet(1)
    sup = _sup(router, lambda idx: _Stub(f"x{idx}"), max_replicas=3,
               queue_hi=8, queue_lo=1, settle_ticks=1, cooldown_s=60.0)
    try:
        stubs[0]._load = 50
        sup.tick()
        assert _wait(lambda: len(router.replica_names) == 2)
        stubs[0]._load = 0
        for _ in range(3):  # idle verdicts land inside the freeze
            sup.tick()
        assert len(router.replica_names) == 2
        assert not any(e["dir"] == "in" for e in sup.events())
    finally:
        sup.close()
        router.close()


def test_dead_replica_respawn_is_backoff_paced():
    router, stubs = _fleet(2)
    sup = _sup(router, lambda idx: _Stub(f"x{idx}"),
               respawn_backoff_s=30.0)
    try:
        victim = stubs[0]
        victim.restart_fails = 1  # first attempt fails, stays dead
        victim.kill()
        assert _wait(lambda: router.table()["s0"] == "dead")
        sup.tick()
        assert victim.restart_calls == 1
        sup.tick()  # still dead, but inside the backoff window
        assert victim.restart_calls == 1
        with sup._lock:  # age the attempt past the backoff
            sup._respawn_at["s0"] -= 60.0
        sup.tick()
        assert victim.restart_calls == 2
        assert not victim.dead
        assert _wait(lambda: router.table()["s0"] == "ready")
        assert [(e["dir"], e["reason"]) for e in sup.events()] == [
            ("respawn", "dead")
        ]
    finally:
        sup.close()
        router.close()


def test_catchup_wedge_escape_hatch_replaces_replica():
    """A replica held in ``catchup`` past ``stuck_after_s`` (here: a
    non-durable respawn lagging beyond the retained roll history) is
    REPLACED by a fresh spawn seeded from the durable store — admitted
    first, wedged one retired after, event counted."""
    from bibfs_tpu_torch.fleet.router import ROLL_HISTORY_MAX

    router, stubs = _fleet(2, durable=False)
    committed = {}

    def spawn(idx):
        # the factory contract: comes up over CURRENT durable content
        return _Stub(f"x{idx}", versions=dict(committed))

    sup = _sup(router, spawn, stuck_after_s=0.1)
    try:
        for i in range(ROLL_HISTORY_MAX + 2):
            assert router.rolling_swap("a", adds=[(0, i + 1)])["ok"]
        committed.update(router.stats()["committed"])
        victim = stubs[0]
        victim.kill()
        assert _wait(lambda: router.table()["s0"] == "dead")
        victim.restart()  # v1; history floor is v4+: unbridgeable
        assert _wait(lambda: router.table()["s0"] == "catchup")
        assert _wait(
            lambda: router.catchup_stuck().get("s0", 0.0) >= 0.1
        )
        assert "s0" in router.stats()["pending_catchup"]
        sup.tick()
        assert _wait(lambda: "s0" not in router.replica_names)
        assert _wait(lambda: router.table().get("x2") == "ready")
        assert ("repair", "catchup_stuck") in [
            (e["dir"], e["reason"]) for e in sup.events()
        ]
        assert "close" in victim.events
        # capacity never dipped: the replacement serves the fleet
        assert router.query(1, 2, "a") is not None
    finally:
        sup.close()
        router.close()


def test_pod_heal_respawns_dead_workers_with_backoff():
    class _FakePod:
        def __init__(self):
            self.dead = {1: "heartbeat silent"}
            self.sweeps = 0
            self.respawned = []

        def check_heartbeats(self):
            self.sweeps += 1
            return []

        def dead_workers(self):
            return dict(self.dead)

    router, _stubs = _fleet(1)
    sup = _sup(router, lambda idx: _Stub(f"x{idx}"),
               respawn_backoff_s=30.0)
    try:
        pod = _FakePod()

        def respawn(p, pidx):
            pod.respawned.append(pidx)
            pod.dead.pop(pidx, None)  # rejoined at a higher epoch

        sup.watch_pod(pod, respawn)
        sup.tick()
        assert pod.sweeps >= 1 and pod.respawned == [1]
        assert ("respawn", "pod_worker") in [
            (e["dir"], e["reason"]) for e in sup.events()
        ]
        # a worker dead AGAIN right away sits out the backoff window
        pod.dead = {1: "heartbeat silent"}
        sup.tick()
        assert pod.respawned == [1]
    finally:
        sup.close()
        router.close()


class _PodWorker:
    """A pod worker's control socket, scripted: a hello at its epoch,
    heartbeats every ``hb_s`` until :meth:`silence`, and a reader that acks
    each graph descriptor (its chunks read) at its epoch and counts it."""

    def __init__(self, port: int, pidx: int, epoch: int = 0,
                 hb_s: float = 0.05):
        import socket
        import threading

        from bibfs_tpu_torch.serve.net import encode_frame, extract_frames

        self._encode = encode_frame
        self._extract = extract_frames
        self.pidx, self.epoch = int(pidx), int(epoch)
        self.graphs = 0
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._quiet = threading.Event()
        self._send({"op": "hello", "process": self.pidx, "epoch": self.epoch})
        threading.Thread(target=self._beat, args=(hb_s,), daemon=True).start()
        threading.Thread(target=self._read, daemon=True).start()

    def _send(self, msg: dict) -> None:
        with self._wlock:
            self.sock.sendall(self._encode(msg))

    def _beat(self, hb_s: float) -> None:
        while not self._quiet.wait(hb_s):
            try:
                self._send({"op": "hb", "process": self.pidx,
                            "epoch": self.epoch})
            except OSError:
                return

    def _read(self) -> None:
        import json

        buf, chunks = bytearray(), {}
        try:
            while True:
                data = self.sock.recv(1 << 16)
                if not data:
                    return
                buf += data
                for raw in self._extract(buf):
                    msg = json.loads(raw.decode())
                    if msg.get("op") == "graph":
                        chunks[msg["seq"]] = msg["chunks"]
                    elif msg.get("op") == "graph_chunk":
                        chunks[msg["for"]] -= 1
                    else:
                        continue
                    for seq in [k for k, left in chunks.items() if not left]:
                        del chunks[seq]
                        self.graphs += 1
                        self._send({"seq": seq, "phase": "done", "ok": True,
                                    "epoch": self.epoch})
        except (OSError, ValueError):
            return

    def silence(self) -> None:
        self._quiet.set()

    def close(self) -> None:
        self.silence()
        try:
            self.sock.close()
        except OSError:
            pass


class _PodSnap:
    def __init__(self):
        import numpy as np

        self.n = 10
        self.pairs = np.array([[i, i + 1] for i in range(9)], dtype=np.int64)
        self.digest = "g" * 16
        self.version = 1


def _pod_heal_run(which: str) -> dict:
    """One scripted heal of a real ``PodPrimary`` of package ``which``
    under that package's ``Supervisor`` (the module docstring of
    :func:`test_pod_heal_with_a_real_primary`)."""
    if which == "ref":
        from bibfs_tpu.fleet import Router as R
        from bibfs_tpu.fleet import ScalePolicy as P
        from bibfs_tpu.fleet import Supervisor as S
        from bibfs_tpu.parallel.podmesh import PodPrimary
    else:
        from bibfs_tpu_torch.parallel.podmesh import PodPrimary

        R, P, S = Router, ScalePolicy, Supervisor
    pod = PodPrimary(2, host="127.0.0.1", heartbeat_timeout_s=1.0)
    workers = {p: _PodWorker(pod.port, p) for p in (1, 2)}
    pod.accept_workers()
    router = R([_Stub("s0")], poll_interval_s=3600.0)
    sup = S(router, lambda idx: _Stub(f"x{idx}"),
            policy=P(cooldown_s=0.0, respawn_backoff_s=30.0),
            poll_interval_s=3600.0)
    rec: dict = {"respawned": []}

    def respawn(p, pidx):
        epoch = p.worker_epoch(pidx) + 1
        old = workers[pidx]
        workers[pidx] = _PodWorker(p.port, pidx, epoch)
        assert p.accept_rejoin(timeout_s=10.0) == pidx
        old.close()
        rec["respawned"].append((pidx, epoch))

    def pod_events():
        return sum(e["dir"] == "respawn" and e["reason"] == "pod_worker"
                   for e in sup.events())

    def fall_silent(pidx):
        """Stop ``pidx``'s heartbeats and wait past the primary's timeout."""
        workers[pidx].silence()
        time.sleep(0.1)  # a beat already on the wire lands first
        with pod._lock:
            last = pod._last_hb[pidx]
        time.sleep(max(0.0, last + 1.2 - time.monotonic()))

    snap = _PodSnap()
    try:
        assert _wait(lambda: len(pod._last_hb) == 2)
        sup.watch_pod(pod, respawn)
        assert pod.ensure_graph(snap, build=lambda: "built",
                                timeout=10.0) == "built"
        sup.tick()
        rec["healthy"] = (pod_events(), pod.dead_workers())
        fall_silent(2)
        # one tick sweeps the heartbeats, marks worker 2 dead and heals
        # it: one respawn at epoch 1
        sup.tick()
        rec["healed"] = (pod_events(), pod.dead_workers(),
                         pod.worker_epoch(1), pod.worker_epoch(2))
        assert pod.ensure_graph(snap, build=lambda: "again",
                                timeout=10.0) == "again"
        rec["graphs"] = (workers[1].graphs, workers[2].graphs)
        # dead again at once: the tick marks it, the backoff holds the
        # next respawn
        assert _wait(lambda: 2 in pod._last_hb)
        fall_silent(2)
        sup.tick()
        rec["backoff"] = (pod_events(), sorted(pod.dead_workers()),
                          pod.worker_epoch(2))
        rec["fenced"] = pod.fenced_frames
    finally:
        sup.close()
        router.close()
        pod.close()
        for w in workers.values():
            w.close()
    return rec


def test_pod_heal_with_a_real_primary():
    """A real ``PodPrimary`` of each package, two scripted workers sending
    heartbeats: a worker falls silent, ``Supervisor.tick()`` marks it dead
    through ``check_heartbeats`` and its respawn callback rejoins a
    scripted worker at epoch + 1 through ``accept_rejoin``; the next
    ``ensure_graph`` re-broadcasts the unchanged graph to both; a second
    silence inside the backoff is left dead. The port's supervisor and
    primary count the same events at each step as the reference's."""
    ref, port = _pod_heal_run("ref"), _pod_heal_run("port")
    assert port == ref
    assert port["healthy"] == (0, {})
    assert port["healed"] == (1, {}, 0, 1)
    assert port["respawned"] == [(2, 1)]
    assert port["graphs"] == (2, 1)
    assert port["backoff"] == (1, [2], 1)


def test_supervisor_metric_families_render():
    router, _stubs = _fleet(1)
    sup = _sup(router, lambda idx: _Stub(f"x{idx}"))
    try:
        render = REGISTRY.render()
        # pre-minted at zero: dashboards see the families before any
        # scale event ever fires
        assert "bibfs_fleet_scale_events_total" in render
        assert "bibfs_fleet_replicas_target" in render
        assert "bibfs_fleet_catchup_stuck" in render
        assert 'reason="catchup_stuck"' in render
        assert sup.stats()["spawn_failures"] == 0
    finally:
        sup.close()
        router.close()


# ---- the two packages side by side ------------------------------------

POLICIES = [
    dict(queue_hi=10, queue_lo=2, settle_ticks=1),
    dict(queue_hi=10, queue_lo=2, settle_ticks=3, cooldown_s=5.0),
    dict(min_replicas=2, max_replicas=3, queue_hi=64, queue_lo=4,
         p99_hi_ms=50.0, p99_lo_ms=20.0, shed_hi=5.0, settle_ticks=2,
         cooldown_s=10.0),
    dict(queue_hi=1000, queue_lo=10, p99_lo_ms=20.0, shed_hi=1.0,
         settle_ticks=2),
]
SIGNALS = [
    {"queue_depth": q, "p99_ms": p99, "shed_rate": shed}
    for q, p99, shed in itertools.product(
        (0, 2, 5, 10, 50, 2000), (None, 5.0, 35.0, 80.0), (None, 0.5, 9.0))
] + [{}, {"queue_depth": None}, {"queue_depth": 64, "p99_ms": 50.0}]
STREAKS = [(0, 0), (1, 0), (0, 1), (2, 2), (5, 0)]
CLOCKS = [(100.0, -1e9), (103.0, 100.0), (105.5, 100.0), (100.0, 99.0)]


@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_decide_scale_parity(policy, replicas):
    """The port's ``decide_scale`` returns the JAX package's verdict
    (action, reason, target) and hysteresis counters over every signal,
    streak and clock of the grid."""
    from bibfs_tpu.fleet import ScalePolicy as RefPolicy
    from bibfs_tpu.fleet import decide_scale as ref_decide

    pol, ref_pol = ScalePolicy(**POLICIES[policy]), RefPolicy(**POLICIES[policy])
    n = 0
    for sig, (out_s, in_s), (now, last) in itertools.product(
            SIGNALS, STREAKS, CLOCKS):
        kw = dict(replicas=replicas, signals=sig, now_s=now,
                  last_scale_s=last, out_streak=out_s, in_streak=in_s)
        v, o, i = decide_scale(pol, **kw)
        rv, ro, ri = ref_decide(ref_pol, **kw)
        assert (v.action, v.reason, v.target, o, i) == (
            rv.action, rv.reason, rv.target, ro, ri), kw
        assert repr(v) == repr(rv)
        n += 1
    assert n == len(SIGNALS) * len(STREAKS) * len(CLOCKS)


_SAMPLE = re.compile(r"^(bibfs_fleet_\w+)\{([^}]*)\} (\S+)$")


def _fleet_families(registry, label: str) -> tuple[dict, set]:
    """The ``bibfs_fleet_*`` families of one registry's render: each
    family's kind, and the samples of the router labelled ``label``
    (name, sorted labels, value)."""
    kinds, samples = {}, set()
    for line in registry.render().splitlines():
        if line.startswith("# TYPE bibfs_fleet_"):
            _, _, name, kind = line.split()
            kinds[name] = kind
            continue
        m = _SAMPLE.match(line)
        if m is None:
            continue
        labels = dict(kv.split("=", 1) for kv in m.group(2).split(","))
        if labels.get("router") != f'"{label}"':
            continue
        samples.add((m.group(1), tuple(sorted(labels.items())), m.group(3)))
    return kinds, samples


def test_fleet_metric_families_parity():
    """A router and a supervisor of each package over the same stubs,
    driven through the same steps (queries, a spill, a roll, a dead
    replica respawned), render the same fleet families with the same
    kinds, label names, label values and values; every family of
    ``FLEET_METRIC_FAMILIES`` renders."""
    from bibfs_tpu.fleet import FLEET_METRIC_FAMILIES as REF_FAMILIES
    from bibfs_tpu.fleet import ReplicaDead as RefDead
    from bibfs_tpu.fleet import Router as RefRouter
    from bibfs_tpu.fleet import ScalePolicy as RefPolicy
    from bibfs_tpu.fleet import Supervisor as RefSupervisor
    from bibfs_tpu.obs.metrics import REGISTRY as REF_REGISTRY
    from bibfs_tpu.solvers.api import BFSResult as RefResult
    from bibfs_tpu_torch.fleet import FLEET_METRIC_FAMILIES

    assert tuple(FLEET_METRIC_FAMILIES) == tuple(REF_FAMILIES)

    class _PkgStub(_Stub):
        dead_exc = ReplicaDead
        result_cls = BFSResult

        def submit(self, src, dst, graph=None):
            if self.dead:
                raise self.dead_exc(self.name)
            t = _Ticket(src, dst)
            t.result = self.result_cls(True, src + dst, None, None, 0.0, 0, 0)
            return t

        def health(self):
            if self.dead:
                raise self.dead_exc(self.name)
            return {"state": "ready"}

    class _RefStub(_PkgStub):
        dead_exc = RefDead
        result_cls = RefResult

    out = []
    for stub_cls, router_cls, sup_cls, pol_cls, registry in (
            (_RefStub, RefRouter, RefSupervisor, RefPolicy, REF_REGISTRY),
            (_PkgStub, Router, Supervisor, ScalePolicy, REGISTRY)):
        label = "fleet-parity"
        stubs = [stub_cls(f"s{i}") for i in range(3)]
        router = router_cls(stubs, poll_interval_s=3600.0, spill_after=4,
                            obs_label=label)
        sup = sup_cls(router, lambda idx: stub_cls(f"x{idx}"),
                      policy=pol_cls(cooldown_s=0.0, respawn_backoff_s=0.0),
                      poll_interval_s=3600.0)
        try:
            for i in range(12):
                router.submit(i, i + 1, f"g{i % 4}").wait(timeout=10.0)
            hot = next(g for g in (f"h{i}" for i in range(64))
                       if router.owner(g) == "s1")
            stubs[1]._load = 50  # the hash owner is backed up: spill
            router.submit(1, 2, hot).wait(timeout=10.0)
            stubs[1]._load = 0
            assert router.rolling_swap("a", adds=[(0, 1)])["ok"]
            stubs[2].kill()
            router._poll_once()
            sup.tick()
            router._poll_once()
            out.append(_fleet_families(registry, label))
        finally:
            sup.close()
            router.close(close_replicas=False)
    (ref_kinds, ref_samples), (kinds, samples) = out
    fleet_only = [f for f in FLEET_METRIC_FAMILIES
                  if f.startswith("bibfs_fleet_")]
    assert set(fleet_only) <= set(kinds)
    assert {f: kinds[f] for f in fleet_only} == {
        f: ref_kinds[f] for f in fleet_only}
    assert samples == ref_samples
    assert any(name == "bibfs_fleet_spills_total" and value != "0"
               for name, _, value in samples)
