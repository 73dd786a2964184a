"""The PyTorch port's pipelined engine (``bibfs_tpu_torch.serve.
pipeline``) against ``bibfs_tpu.serve.pipeline`` and the port's own
synchronous engine, on the CPU: every ``BFSResult`` field except
``time_s``, the engine counters and the resilience accounting equal the
reference's pipelined engine in the batch modes auto, pallas, pallas_alt
and minor8 on the host and the device routing; then the reference's own
pipelined cases run against the port (deadline and depth-only flushing,
ticket timeout and cancel, admission control, concurrent submitters,
close and kill races, faults at launch and at finish), and a CUDA engine
answers no card failure on the host, at launch or at finish.

Batching is made deterministic where engines are compared: depth-only
flushing (``max_wait_ms=None``) with the depth trigger at the wave's
queued size, so the flusher pops each wave whole. No test asserts a
count of deadline flushes or an order between threads, and every wait
has a timeout."""

import threading
import time

import numpy as np
import pytest

FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")
RES_KEYS = ("errors", "fallbacks", "retries", "bisections")
WAIT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _fields(r):
    return tuple(getattr(r, f) for f in FIELDS)


def _skiplink_graph(n: int) -> np.ndarray:
    """Chain plus skip links (max degree 4): diameter ~n/7, every size
    buckets to ELL width 8."""
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


def _rand_pairs(rng, n: int, k: int) -> np.ndarray:
    src = rng.integers(0, n, size=k)
    dst = (src + rng.integers(1, n, size=k)) % n
    return np.stack([src, dst], axis=1)


def _check_oracle(n, edges, pairs, results):
    from bibfs_tpu_torch.solvers.serial import solve_serial

    for (src, dst), r in zip(pairs, results):
        ref = solve_serial(n, edges, int(src), int(dst))
        assert r.found == ref.found, (src, dst)
        if ref.found:
            assert r.hops == ref.hops, (src, dst)
            if r.path is not None:
                r.validate_path(n, edges, int(src), int(dst))


def _pipe(n, edges, **kw):
    from bibfs_tpu_torch.serve import ExecutableCache, PipelinedQueryEngine

    kw.setdefault("exec_cache", ExecutableCache())
    return PipelinedQueryEngine(n, edges, device="cpu", **kw)


def _ref_pipe(n, edges, spec=None, **kw):
    from bibfs_tpu.serve import ExecutableCache, FaultPlan, PipelinedQueryEngine

    return PipelinedQueryEngine(
        n, edges, exec_cache=ExecutableCache(),
        faults=None if spec is None else FaultPlan.parse(spec), **kw,
    )


def _same_accounting(port, ref):
    sp, sr = port.stats(), ref.stats()
    assert dict(port.counters) == dict(ref.counters)
    for key in RES_KEYS:
        assert sp["resilience"][key] == sr["resilience"][key], key
    assert sp["dist_cache"] == sr["dist_cache"]
    assert sp["resilience"]["breaker"] == sr["resilience"]["breaker"]
    return sp, sr


# ---- the latency histogram -------------------------------------------
def test_latency_histogram_percentiles():
    from bibfs_tpu_torch.serve import LatencyHistogram

    h = LatencyHistogram()
    h.record_many([0.001] * 90 + [0.1] * 10)
    assert h.count == 100
    assert 0.0008 <= h.percentile(0.5) <= 0.0015
    assert 0.08 <= h.percentile(0.99) <= 0.13
    assert h.max_s == pytest.approx(0.1)
    s = h.summary_ms()
    assert s["count"] == 100 and s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    assert LatencyHistogram().summary_ms()["count"] == 0


# ---- against the reference's pipelined engine --------------------------
@pytest.mark.parametrize("device_batches", [False, True])
@pytest.mark.parametrize("mode", ["auto", "pallas", "pallas_alt", "minor8"])
def test_pipelined_equals_reference(mode, device_batches):
    """Two waves through both packages' pipelined engines and the port's
    synchronous one: a fresh wave popped whole (device-routed when
    ``device_batches``), then repeats, reverse twins and new pairs that the
    distance cache and a drained host batch answer. Every field but the
    time, the counters, the resilience accounting and the cache equal the
    reference's; the answers equal the synchronous engine's and the
    oracle's."""
    from bibfs_tpu_torch.serve import ExecutableCache, QueryEngine

    n = 260
    edges = _skiplink_graph(n)
    rng = np.random.default_rng(11)
    wave1 = _rand_pairs(rng, n, 40)
    wave1[9] = (17, 17)  # trivial: resolved at submit, never queued
    # distinct pairs: the 39 queued ones pop as one batch of 39 (the
    # device route takes a batch of at least flush_threshold pairs)
    assert len({tuple(p) for p in wave1}) == 40
    wave2 = np.concatenate([wave1[:6], wave1[:3], wave1[10:16, ::-1],
                            _rand_pairs(rng, n, 8)])
    kw = dict(mode=mode, flush_threshold=39, max_wait_ms=None,
              device_batches=device_batches, cache_entries=24)
    port, ref = _pipe(n, edges, **kw), _ref_pipe(n, edges, **kw)
    sync = QueryEngine(n, edges, device="cpu", exec_cache=ExecutableCache(),
                       **{k: v for k, v in kw.items() if k != "max_wait_ms"})
    try:
        ran = []
        for wave in (wave1, wave2):
            got, want = port.query_many(wave), ref.query_many(wave)
            assert [_fields(r) for r in got] == [_fields(r) for r in want]
            assert ([_fields(r)[:3] for r in got]
                    == [_fields(r)[:3] for r in sync.query_many(wave)])
            _check_oracle(n, edges, wave, got)
            ran.append({r.mode for r in got if r.mode is not None})
        sp, _sr = _same_accounting(port, ref)
        assert not any(sp["resilience"]["fallbacks"].values())
        assert sp["pipeline"]["outstanding"] == 0
        if device_batches:
            assert port.counters["device_batches"] == 1
            assert ran[0] == {"minor8" if mode == "auto" else mode}
            assert set(sp["stages"]) == {"device", "host"}
        else:
            assert port.counters["device_batches"] == 0
            assert set(sp["stages"]) == {"host"}
        assert port.counters["cache_served"] > 0
    finally:
        port.close()
        ref.close()


def test_pipelined_stats_keys_follow_reference():
    n = 120
    edges = _skiplink_graph(n)
    with _pipe(n, edges) as port, _ref_pipe(n, edges) as ref:
        port.query(0, 60)
        ref.query(0, 60)
        sp, sr = port.stats(), ref.stats()
    assert set(sp) - set(sr) == {"device"}
    assert set(sp["pipeline"]) == set(sr["pipeline"])
    assert set(sp["overlap"]) == set(sr["overlap"])
    assert set(sp["latency_ms"]) == set(sr["latency_ms"])
    assert sp["stages"].keys() == sr["stages"].keys()
    for route in sp["stages"]:
        assert sp["stages"][route].keys() == sr["stages"][route].keys()


# ---- correctness through both routes ----------------------------------
def test_pipelined_host_route_matches_oracle():
    n = 220
    edges = _skiplink_graph(n)
    with _pipe(n, edges) as eng:
        pairs = _rand_pairs(np.random.default_rng(0), n, 40)
        pairs[3] = (9, 9)  # trivial
        results = eng.query_many(pairs)
        _check_oracle(n, edges, pairs, results)
        assert eng.counters["host_queries"] > 0
        assert eng.counters["device_batches"] == 0
        assert eng.counters["trivial"] == 1
        st = eng.stats()
        assert st["latency_ms"]["count"] == 40
        assert st["pipeline"]["flushes"] >= 1
        assert st["overlap"]["wall_s"] >= 0


def test_pipelined_device_route_matches_oracle():
    n = 220
    edges = _skiplink_graph(n)
    with _pipe(n, edges, flush_threshold=8, device_batches=True) as eng:
        pairs = _rand_pairs(np.random.default_rng(1), n, 40)
        results = eng.query_many(pairs)
        _check_oracle(n, edges, pairs, results)
        assert eng.counters["device_batches"] >= 1
        assert eng.counters["host_queries"] == 0
        assert eng.exec_cache.stats()["programs"] >= 1


def test_pipelined_query_many_empty():
    with _pipe(20, np.array([[0, 1]])) as eng:
        assert eng.query_many([]) == []
        assert eng.counters["queries"] == 0
        assert eng.pipe_counters["flushes"] == 0


# ---- deadline and depth-only flushing -----------------------------------
@pytest.mark.parametrize("device", [False, True])
def test_deadline_flush_without_explicit_flush(device):
    """A sub-threshold queue resolves soon after ``max_wait_ms`` with no
    flush() call, on the host and the device routing."""
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n = 150
    edges = _skiplink_graph(n)
    with _pipe(n, edges, flush_threshold=50, max_wait_ms=40.0,
               device_batches=device) as eng:
        t0 = time.perf_counter()
        res = eng.submit(0, 100).wait(timeout=30.0)  # NOT eng.flush()
        assert time.perf_counter() - t0 < 20.0
        assert res.found and res.hops == solve_serial(n, edges, 0, 100).hops
        assert eng.pipe_counters["deadline_flushes"] >= 1


def test_no_deadline_means_depth_only():
    n = 100
    with _pipe(n, _skiplink_graph(n), flush_threshold=50,
               max_wait_ms=None) as eng:
        t = eng.submit(0, 60)
        time.sleep(0.3)
        assert not t.done()
        eng.flush(timeout=WAIT_S)
        assert t.done() and t.result.found


def test_ticket_wait_timeout():
    n = 100
    with _pipe(n, _skiplink_graph(n), flush_threshold=50,
               max_wait_ms=None) as eng:
        t = eng.submit(0, 60)
        with pytest.raises(TimeoutError):
            t.wait(timeout=0.2)
        eng.flush(timeout=WAIT_S)
        assert t.wait(timeout=5.0).found


def test_flush_timeout_reports_outstanding():
    """A flush whose batch is held past its timeout raises instead of
    hanging, and a later flush still drains it."""
    from bibfs_tpu_torch.serve import FaultPlan

    n = 100
    plan = FaultPlan.parse("host_batch:every=1,kind=latency,ms=400")
    with _pipe(n, _skiplink_graph(n), flush_threshold=50, max_wait_ms=None,
               faults=plan) as eng:
        t = eng.submit(0, 60)
        with pytest.raises(TimeoutError, match="outstanding"):
            eng.flush(timeout=0.05)
        eng.flush(timeout=WAIT_S)
        assert t.wait(timeout=5.0).found


# ---- admission control and lifecycle ------------------------------------
def test_admission_control_blocks_and_recovers():
    n = 150
    with _pipe(n, _skiplink_graph(n), flush_threshold=1000,
               max_wait_ms=10.0, max_queue=1) as eng:
        tickets = [eng.submit(i, i + 30) for i in range(3)]
        assert all(t.wait(timeout=30.0).found for t in tickets)
        assert eng.pipe_counters["submit_blocked"] >= 1


def test_full_queue_flushes_even_depth_only():
    """max_queue < flush_threshold with depth-only flushing must not
    deadlock: a full admission queue is itself a flush trigger."""
    n = 150
    edges = _skiplink_graph(n)
    with _pipe(n, edges, flush_threshold=50, max_wait_ms=None,
               max_queue=4) as eng:
        pairs = [(i, i + 40) for i in range(9)]
        done = []
        th = threading.Thread(
            target=lambda: done.append(eng.query_many(pairs))
        )
        th.start()
        th.join(timeout=30.0)
        assert not th.is_alive(), "submit deadlocked on a full queue"
        _check_oracle(n, edges, np.array(pairs), done[0])


def test_closed_engine_rejects_submits_and_joins_its_threads():
    n = 60
    eng = _pipe(n, _skiplink_graph(n))
    eng.query(0, 30)
    eng.close()
    eng.close()  # idempotent
    assert not eng._flusher.is_alive()
    assert not any(th.name.startswith("bibfs-finish")
                   for th in threading.enumerate())
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(1, 2)
    assert eng.health_snapshot()["state"] == "draining"


def test_pipelined_drain_rejects_new_submits_resolves_queued():
    from bibfs_tpu_torch.serve import QueryError
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n = 120
    edges = _skiplink_graph(n)
    with _pipe(n, edges, flush_threshold=64, max_wait_ms=None) as eng:
        queued = eng.submit(0, 50)
        eng.begin_drain()
        assert eng.health_snapshot()["state"] == "draining"
        with pytest.raises(QueryError) as exc:
            eng.submit(1, 40)
        assert exc.value.kind == "capacity"
        eng.flush(timeout=WAIT_S)
        assert queued.wait(timeout=30.0).hops == solve_serial(
            n, edges, 0, 50).hops
        eng.end_drain()
        assert eng.health_snapshot()["state"] == "ready"
        t = eng.submit(1, 40)
        eng.flush(timeout=WAIT_S)
        assert t.wait(timeout=30.0).hops == solve_serial(
            n, edges, 1, 40).hops


def test_pipelined_kill_fails_queued_with_internal_error():
    from bibfs_tpu_torch.serve import QueryError

    n = 120
    eng = _pipe(n, _skiplink_graph(n), flush_threshold=64, max_wait_ms=None)
    t = eng.submit(0, 50)
    eng.kill()
    with pytest.raises(QueryError) as exc:
        t.wait(timeout=5.0)
    assert exc.value.kind == "internal"
    with pytest.raises((QueryError, RuntimeError)):
        eng.submit(1, 2)
    eng.close()  # idempotent after kill
    assert not eng._flusher.is_alive()


# ---- concurrency ---------------------------------------------------------
def test_concurrent_submitters_equal_sync_engine():
    """Four threads submit against ONE pipelined engine: every ticket
    resolves to the synchronous engine's answer and the oracle's, with
    exact query accounting."""
    from bibfs_tpu_torch.serve import ExecutableCache, QueryEngine

    n = 300
    edges = _skiplink_graph(n)
    threads, per = 4, 25
    rng = np.random.default_rng(7)
    plans = [_rand_pairs(rng, n, per) for _ in range(threads)]
    plans[1][:5] = plans[0][:5]  # cross-thread repeats hit the dedupe
    sync = QueryEngine(n, edges, device="cpu", exec_cache=ExecutableCache())
    with _pipe(n, edges, max_wait_ms=5.0) as eng:
        outs: list = [[] for _ in range(threads)]
        errors: list = []

        def worker(k):
            try:
                for s, d in plans[k]:
                    outs[k].append(((int(s), int(d)),
                                    eng.submit(int(s), int(d))))
            except Exception as e:  # pragma: no cover - fail loudly
                errors.append(e)

        ts = [threading.Thread(target=worker, args=(k,))
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30.0)
            assert not t.is_alive(), "submitter thread hung"
        assert not errors
        eng.flush(timeout=WAIT_S)
        for out in outs:
            for (s, d), ticket in out:
                r = ticket.wait(timeout=30.0)
                w = sync.query(s, d)
                assert (r.found, r.hops) == (w.found, w.hops), (s, d)
        assert eng.counters["queries"] == threads * per


def test_pipelined_repeat_traffic_cache_served():
    n = 260
    edges = _skiplink_graph(n)
    with _pipe(n, edges, flush_threshold=8, device_batches=True) as eng:
        pairs = _rand_pairs(np.random.default_rng(2), n, 24)
        warm = eng.query_many(pairs)
        _check_oracle(n, edges, pairs, warm)
        dispatches = (eng.counters["device_batches"],
                      eng.counters["host_queries"])
        again = eng.query_many(np.concatenate([pairs, pairs[:, ::-1]]))
        for a, b in zip(again[: len(pairs)], warm):
            assert a.found == b.found and a.hops == b.hops
        assert (eng.counters["device_batches"],
                eng.counters["host_queries"]) == dispatches
        assert eng.counters["cache_served"] >= 2 * len(pairs)


def test_solve_many_pipelined_equals_reference():
    from bibfs_tpu.solvers.api import solve_many as ref_solve_many

    from bibfs_tpu_torch.serve import QueryError
    from bibfs_tpu_torch.solvers.api import solve_many

    n = 180
    edges = _skiplink_graph(n)
    pairs = [tuple(p) for p in np.random.default_rng(5).integers(
        0, n, size=(10, 2))] + [(0, 10 ** 9)]
    got = solve_many(n, edges, pairs, pipelined=True, max_wait_ms=20.0,
                     device="cpu")
    want = ref_solve_many(n, edges, pairs, pipelined=True, max_wait_ms=20.0)
    assert isinstance(got[-1], QueryError) and got[-1].kind == "invalid"
    assert [_fields(r) for r in got[:-1]] == [_fields(r) for r in want[:-1]]
    _check_oracle(n, edges, pairs[:-1], got[:-1])


# ---- resilience through the pipeline ------------------------------------
@pytest.mark.parametrize("spec", ["device:every=1", "device_finish:every=1",
                                  "device:times=1"])
def test_pipelined_device_faults_equal_reference(spec):
    """A launch fault retries then degrades the batch to the host; a
    finish fault recovers it on the finish worker; a single launch fault
    is absorbed by the retry. Answers, counters and resilience accounting
    equal the reference's, and no ticket fails."""
    from bibfs_tpu_torch.serve import FaultPlan, RetryPolicy

    from bibfs_tpu.serve import RetryPolicy as RefRetry

    n = 220
    edges = _skiplink_graph(n)
    kw = dict(flush_threshold=12, max_wait_ms=None, device_batches=True)
    port = _pipe(n, edges, faults=FaultPlan.parse(spec),
                 retry=RetryPolicy(2, base_ms=0.0), **kw)
    ref = _ref_pipe(n, edges, spec, retry=RefRetry(2, base_ms=0.0), **kw)
    pairs = [(i, i + 50) for i in range(12)]
    try:
        got, want = port.query_many(pairs), ref.query_many(pairs)
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
        _check_oracle(n, edges, np.array(pairs), got)
        sp, _sr = _same_accounting(port, ref)
        res = sp["resilience"]
        assert res["errors"] == {k: 0 for k in res["errors"]}
        assert res["faults"]["fired_total"] >= 1
        if spec == "device:times=1":
            assert res["retries"] == 1 and port.counters["device_batches"] == 1
        else:
            assert res["fallbacks"]["device->host"] >= 1
            assert port.counters["host_queries"] == len(pairs)
    finally:
        port.close()
        ref.close()


def test_pipelined_query_many_return_errors():
    from bibfs_tpu_torch.serve import QueryError

    n = 100
    with _pipe(n, _skiplink_graph(n)) as eng:
        out = eng.query_many([(0, 50), (0, 10 ** 9), (1, 40)],
                             return_errors=True)
        assert out[0].found and out[2].found
        assert isinstance(out[1], QueryError) and out[1].kind == "invalid"


def test_pipelined_failed_ticket_carries_query_error():
    """Break both host rungs for one pair: that ticket fails with an
    ``internal`` QueryError, its batch-mates resolve."""
    from bibfs_tpu_torch.serve import FaultPlan, QueryError
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n = 150
    edges = _skiplink_graph(n)
    poison = (2, 42)
    plan = FaultPlan.parse(f"host_batch:pair={poison[0]}-{poison[1]}")
    eng = _pipe(n, edges, flush_threshold=1000, max_wait_ms=5.0, faults=plan)
    real = eng._solve_serial_one
    eng._solve_serial_one = lambda s, d: (
        (_ for _ in ()).throw(RuntimeError("serial rung down"))
        if (s, d) == poison else real(s, d)
    )
    try:
        pairs = [(i, i + 40) for i in range(6)]
        out = eng.query_many(pairs, return_errors=True)
        for (s, d), r in zip(pairs, out):
            if (s, d) == poison:
                assert isinstance(r, QueryError) and r.kind == "internal"
            else:
                ref = solve_serial(n, edges, s, d)
                assert r.found == ref.found and r.hops == ref.hops
        assert eng.stats()["resilience"]["errors"]["internal"] == 1
    finally:
        eng.close()


# ---- ticket cancellation ------------------------------------------------
def test_cancel_drops_queued_ticket_from_accounting():
    n = 100
    with _pipe(n, _skiplink_graph(n), flush_threshold=50,
               max_wait_ms=None) as eng:
        t = eng.submit(0, 60)
        with pytest.raises(TimeoutError):
            t.wait(timeout=0.1, cancel_on_timeout=True)
        assert t.done() and t.error is not None
        assert t.error.kind == "timeout"
        assert eng.pending == 0
        t0 = time.perf_counter()
        eng.flush(timeout=WAIT_S)
        assert time.perf_counter() - t0 < 5.0
        assert eng.query(0, 30).found  # the finish worker is alive
        assert eng.stats()["resilience"]["errors"]["timeout"] == 1


def test_cancel_after_resolution_is_a_noop():
    n = 100
    with _pipe(n, _skiplink_graph(n), max_wait_ms=5.0) as eng:
        t = eng.submit(0, 60)
        res = t.wait(timeout=30.0)
        assert res.found
        assert t.cancel() is False
        assert t.error is None and t.result is res


# ---- shutdown races (bounded: a deadlock fails, never hangs) -------------
def test_close_races_with_inflight_submitters():
    n = 200
    eng = _pipe(n, _skiplink_graph(n), max_wait_ms=2.0)
    tickets: list = []
    lock = threading.Lock()

    def submitter(k):
        for i in range(40):
            try:
                t = eng.submit((k * 13 + i) % n, (k * 7 + i + 31) % n)
            except RuntimeError as e:
                assert "closed" in str(e)
                return
            with lock:
                tickets.append(t)

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(4)]
    for th in threads:
        th.start()
    time.sleep(0.02)
    eng.close()
    for th in threads:
        th.join(timeout=30.0)
        assert not th.is_alive(), "submitter deadlocked across close()"
    for t in tickets:
        assert t.done(), (t.src, t.dst)
    assert not eng._flusher.is_alive()


def test_close_while_device_flush_mid_launch():
    """close() while a device flush is held open by an injected latency
    fault drains cleanly: the in-flight batch resolves."""
    from bibfs_tpu_torch.serve import FaultPlan

    n = 200
    plan = FaultPlan.parse("device:every=1,kind=latency,ms=150")
    eng = _pipe(n, _skiplink_graph(n), flush_threshold=8,
                device_batches=True, faults=plan, max_wait_ms=2.0)
    tickets = [eng.submit(i, i + 50) for i in range(12)]
    time.sleep(0.05)  # the flusher is inside the slowed launch
    t0 = time.perf_counter()
    eng.close()
    assert time.perf_counter() - t0 < 30.0
    for t in tickets:
        assert t.done(), "ticket stranded by close() during launch"
        if t.error is not None:
            assert "closed" in str(t.error)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(0, 1)
    assert eng.health_snapshot()["state"] == "draining"


def test_health_degrades_on_queue_pressure():
    n = 100
    with _pipe(n, _skiplink_graph(n), flush_threshold=1000,
               max_wait_ms=None, max_queue=10) as eng:
        assert eng.health_snapshot()["state"] == "ready"
        for i in range(9):  # >= 90% of max_queue
            eng.submit(i, i + 40)
        snap = eng.health_snapshot()
        assert snap["state"] == "degraded"
        assert any("queue" in r for r in snap["reasons"])
        eng.flush(timeout=WAIT_S)
        assert eng.health_snapshot()["state"] == "ready"


def test_pipelined_query_many_allocates_no_registry_objects():
    from bibfs_tpu_torch.obs.metrics import REGISTRY

    def cells():
        return sum(len(f.children()) for f in REGISTRY.families())

    n = 150
    with _pipe(n, _skiplink_graph(n)) as eng:
        eng.query(0, 30)
        before = cells()
        pairs = np.random.default_rng(2).integers(0, n, size=(60, 2))
        results = eng.query_many(pairs)
        assert len(results) == 60
        assert all(r.level_stats is None for r in results)
        assert cells() == before


# ---- a CUDA engine answers no card failure on the host ------------------
def _cuda_typed_pipe(monkeypatch, n, edges, **kw):
    """A pipelined engine whose device reads as ``cuda`` (no card needed:
    ``mode="sync"`` builds no kernel, and the tests replace the device
    stages before any flush reaches the card)."""
    import torch

    from bibfs_tpu_torch.serve import ExecutableCache, PipelinedQueryEngine
    from bibfs_tpu_torch.serve import engine as engine_mod

    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    return PipelinedQueryEngine(n, edges, mode="sync", host_backend="serial",
                                exec_cache=ExecutableCache(),
                                flush_threshold=6, max_wait_ms=None, **kw)


def _fresh(k, lo, span=50):
    return [(lo + i, lo + i + span) for i in range(k)]


def _card_failure(*_args):
    raise RuntimeError("bibfs_minor_level: CUDA launch failed (719)")


def _launched(n, edges):
    """Stand in for a launch that succeeded on the card: the host arrays a
    real launch copies back, from the plain search over a CPU copy of the
    graph."""
    from bibfs_tpu_torch.solvers.dense import (
        DeviceGraph,
        _batch_dispatch,
        _host,
    )

    g = DeviceGraph.build(n, edges, device="cpu")

    def launch(pairs):
        stats = {"host_syncs": 0}
        _p, dispatch, finish = _batch_dispatch(g, pairs, "sync", stats)
        outs = [_host(o) for o in finish(dispatch())]
        return (outs, (0.0, stats["mode"], stats["host_syncs"]),
                time.perf_counter())

    return launch


@pytest.mark.parametrize("stage", ["launch", "finish"])
def test_cuda_pipelined_card_failure_fails_tickets(monkeypatch, stage):
    """A card failure at launch (on the flusher) or at finish (on the
    worker) fails the batch's tickets with ``kind='internal'``: no retry,
    no fallback, nothing answered on the host, the breaker stays closed
    however often it happens, and the in-flight slots all come back."""
    from bibfs_tpu_torch.serve import QueryError

    n = 220
    edges = _skiplink_graph(n)
    eng = _cuda_typed_pipe(monkeypatch, n, edges)
    try:
        if stage == "launch":
            eng._device_launch = _card_failure
        else:
            eng._device_launch = _launched(n, edges)
            eng._device_finish = _card_failure
        for wave in range(4):
            out = eng.query_many(_fresh(6, 10 * wave), return_errors=True)
            assert all(isinstance(r, QueryError) and r.kind == "internal"
                       for r in out), out
        st = eng.stats()
        res = st["resilience"]
        assert not any(res["fallbacks"].values()) and res["retries"] == 0
        assert res["errors"]["internal"] == 24
        assert res["breaker"]["state"] == "closed"
        assert res["breaker"]["opens"] == 0
        assert st["host_queries"] == st["device_queries"] == 0
        assert st["pipeline"]["outstanding"] == 0
        assert eng._inflight._value == 2  # every slot returned
        # below the crossover the host route is a routing decision
        assert eng.query_many(_fresh(3, 150))[0].found
        assert eng.counters["host_queries"] == 3
    finally:
        eng.close()


def test_cuda_pipelined_degrades_injected_faults_only(monkeypatch):
    """On a CUDA engine the chaos seam still drives the ladder: injected
    launch faults retry, open the breaker and degrade to the host, and an
    injected finish fault is recovered on the host. A card failure during
    the half-open probe that follows fails its tickets and frees the
    probe without a recorded outcome."""
    from bibfs_tpu_torch.serve import (
        CircuitBreaker,
        FaultPlan,
        QueryError,
        RetryPolicy,
    )

    n = 220
    edges = _skiplink_graph(n)
    eng = _cuda_typed_pipe(
        monkeypatch, n, edges,
        faults=FaultPlan.parse("device:times=2;device_finish:times=1"),
        retry=RetryPolicy(2, base_ms=0.0),
        breaker=CircuitBreaker(fail_threshold=2, reset_s=0.0),
    )
    try:
        real_launch = _launched(n, edges)

        def fault_then_launch(pairs):
            eng._faults.fire("device", pairs)
            return real_launch(pairs)

        eng._device_launch = fault_then_launch
        pairs = _fresh(6, 0)
        _check_oracle(n, edges, pairs, eng.query_many(pairs))
        res = eng.stats()["resilience"]
        assert res["fallbacks"]["device->host"] == 1 and res["retries"] == 1
        assert res["breaker"]["opens"] == 1
        assert eng.counters["host_queries"] == 6
        # the half-open probe launches; its injected finish fault recovers
        pairs = _fresh(6, 20)
        _check_oracle(n, edges, pairs, eng.query_many(pairs))
        res = eng.stats()["resilience"]
        assert res["fallbacks"]["device->host"] == 2
        assert eng.counters["host_queries"] == 12
        assert not any(res["errors"].values())
        eng._device_launch = _card_failure
        for lo in (40, 60):  # the probe is freed each time
            out = eng.query_many(_fresh(6, lo), return_errors=True)
            assert all(isinstance(r, QueryError) and r.kind == "internal"
                       for r in out)
        res = eng.stats()["resilience"]
        assert res["fallbacks"]["device->host"] == 2
        assert res["breaker"]["state"] == "half_open"
        assert eng.counters["host_queries"] == 12
    finally:
        eng.close()


def test_launch_counts_are_exact_across_threads():
    """``count_launch`` (a wrapper's count, or one key of it) takes a
    lock: the pipelined engine's flusher and a caller's thread may both
    launch. Sixteen threads with a short switch interval lose no count."""
    import sys

    from bibfs_tpu_torch.ops import _cuda

    def wrapper():
        pass

    wrapper.launches = 0
    keyed = type("K", (), {"launches": {"a": 0}})

    def bump():
        for _ in range(2000):
            _cuda.count_launch(wrapper)
            _cuda.count_launch(keyed, "a")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=bump) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
    assert wrapper.launches == 32000 and keyed.launches["a"] == 32000


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "minor", "pallas", "pallas_alt"])
def test_cuda_pipelined_flush_equals_cpu_engine(mode):
    """On the card: the pipelined engine's device flushes, launched on
    its flusher thread, equal the CPU engine's field for field, with the
    level kernel's launches counted and no fallback or retry."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from bibfs_tpu_torch.ops import minor_level, pull_expand
    from bibfs_tpu_torch.serve import ExecutableCache, PipelinedQueryEngine

    n = 300
    edges = _skiplink_graph(n)
    pairs = _rand_pairs(np.random.default_rng(10), n, 40)
    kw = dict(mode=mode, flush_threshold=40, max_wait_ms=None,
              device_batches=True)
    counted = {"auto": (minor_level.minor_level, "minor8"),
               "minor": (minor_level.minor_level, "minor"),
               "pallas": (pull_expand.pull_dual, None),
               "pallas_alt": (pull_expand.pull_single, None)}[mode]

    def launches():
        wrapper, key = counted
        return wrapper.launches if key is None else wrapper.launches[key]

    before = launches()
    with PipelinedQueryEngine(n, edges, device="cuda",
                              exec_cache=ExecutableCache(), **kw) as gpu:
        got = gpu.query_many(pairs)
        st = gpu.stats()
    with _pipe(n, edges, **kw) as cpu:
        want = cpu.query_many(pairs)
        assert dict(st["resilience"]["errors"]) == {
            k: 0 for k in st["resilience"]["errors"]}
        assert {k: st[k] for k in cpu.counters} == dict(cpu.counters)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert st["device_batches"] == 1 and launches() > before
    assert st["resilience"]["retries"] == 0
    assert not any(st["resilience"]["fallbacks"].values())
