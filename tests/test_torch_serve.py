"""The PyTorch port's serving layer (``bibfs_tpu_torch.serve``) against
``bibfs_tpu.serve`` on the CPU: the shape buckets and the snapshot digest
(cache identity) byte for byte, the metrics registry's rendering, the
distance and executable caches, and the synchronous ``QueryEngine`` and
``solve_many`` — every ``BFSResult`` field except ``time_s`` and the
engine counters equal the reference engine's in every batch mode, layout
and ``device_batches`` setting. Then the reference's own engine cases run
against the port, the option and the query kinds of later slices raise
``NotImplementedError`` and the store options refuse what the
reference refuses, a CUDA engine whose kernels do not build raises
from its constructor, and (on a card only) a device flush equals the CPU
engine's."""

import json

import numpy as np
import pytest

FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")


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
    """k random pairs with src != dst."""
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


def _engine(n, edges, **kw):
    from bibfs_tpu_torch.serve import ExecutableCache, QueryEngine

    kw.setdefault("exec_cache", ExecutableCache())
    return QueryEngine(n, edges, device="cpu", **kw)


def _graph_cases():
    from bibfs_tpu_torch.graph.generate import gnp_random_graph, rmat_graph

    n_r, e_r = rmat_graph(7, edge_factor=6, seed=1)
    e_g = gnp_random_graph(300, 3.0 / 300, seed=9)
    return {
        "skiplink": (220, _skiplink_graph(220)),
        "rmat7": (n_r, e_r),
        "gnp300": (300, e_g),
        # the same graph as gnp300, edges reversed, shuffled and doubled
        "gnp300_perm": (300, np.concatenate(
            [e_g[::-1, ::-1], e_g[np.random.default_rng(0).permutation(len(e_g))]]
        )),
        "empty": (5, np.zeros((0, 2), dtype=np.int64)),
    }


GRAPHS = _graph_cases()


# ---- buckets, snapshot identity, caches -----------------------------
def test_bucket_ladders():
    from bibfs_tpu_torch.serve import bucket_batch, bucket_rows, bucket_width

    assert bucket_rows(1) == 128
    assert bucket_rows(128) == 128
    assert bucket_rows(129) == 256
    assert bucket_rows(100_008) == 131072
    assert bucket_width(1) == 8
    assert bucket_width(13) == 16
    assert bucket_batch(1) == 128
    assert bucket_batch(300) == 512


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bucketed_ell_equals_reference(name):
    """Bucket padding is the reference's: the same padded table, degree
    row and bucket key."""
    from bibfs_tpu.serve import bucketed_ell as ref_bucketed
    from bibfs_tpu.serve import ell_bucket_key as ref_key

    from bibfs_tpu_torch.serve import bucketed_ell, ell_bucket_key

    n, edges = GRAPHS[name]
    g, r = bucketed_ell(n, edges), ref_bucketed(n, edges)
    assert (g.n, g.n_pad, g.width, g.num_edges) == (r.n, r.n_pad, r.width,
                                                    r.num_edges)
    np.testing.assert_array_equal(g.nbr, r.nbr)
    np.testing.assert_array_equal(g.deg, r.deg)
    assert ell_bucket_key(g) == ref_key(r)
    assert (g.deg[n:] == 0).all()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_snapshot_digest_equals_reference(name):
    """Cache identity: the content digest is the reference's byte for
    byte (edge order, orientation and duplicates do not change it), and so
    is the engine's cache namespace."""
    from bibfs_tpu.serve import QueryEngine as RefEngine
    from bibfs_tpu.store.snapshot import GraphSnapshot as RefSnapshot

    from bibfs_tpu_torch.store.snapshot import GraphSnapshot

    n, edges = GRAPHS[name]
    snap, ref = GraphSnapshot.build(n, edges), RefSnapshot.build(n, edges)
    assert snap.digest == ref.digest
    np.testing.assert_array_equal(snap.pairs, ref.pairs)
    for a, b in zip(snap.csr(), ref.csr()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(snap.undirected_edges(),
                                  ref.undirected_edges())
    assert snap.num_edges == ref.num_edges
    assert _engine(n, edges).graph_id == RefEngine(n, edges).graph_id
    if name == "gnp300_perm":
        assert snap.digest == GraphSnapshot.build(*GRAPHS["gnp300"]).digest


def test_snapshot_lifecycle():
    from bibfs_tpu_torch.store.snapshot import GraphSnapshot

    n, edges = GRAPHS["skiplink"]
    snap = GraphSnapshot.build(n, edges)
    other = GraphSnapshot.build(n, edges)
    assert other.digest == snap.digest and other.version > snap.version
    assert GraphSnapshot(n, snap.pairs).digest.startswith("anon-")
    assert snap.ell() is snap.ell() and snap.csr() is snap.csr()
    assert snap.tiered() is snap.tiered()
    assert snap.native_csr() is None
    fired = []
    snap.on_retire(fired.append)
    snap.retain()
    assert snap.refs == 2
    assert snap.release() is False and not snap.retired
    assert snap.release() is True and snap.retired
    assert fired == [snap]
    assert snap._ell is None  # the memoized tables are freed
    assert snap.ell().n == n  # a post-retire build answers, uncached
    assert snap._ell is None
    with pytest.raises(RuntimeError, match="retired"):
        snap.retain()
    late = []
    snap.on_retire(late.append)
    assert late == [snap]
    assert snap.stats()["digest"] == snap.digest


def test_executable_cache_counters():
    from bibfs_tpu_torch.serve import ExecutableCache

    c = ExecutableCache()
    assert c.note(("a", 1)) is False
    assert c.note(("a", 1)) is True
    assert c.note(("b", 2)) is False
    assert c.stats() == {"hits": 1, "misses": 2, "programs": 2}
    assert c.program_counts() == {"('a', 1)": 2, "('b', 2)": 1}


def test_distance_cache_equals_reference():
    """One scripted sequence of forest, path and pair-memo inserts,
    lookups, evictions and an invalidation gives the reference's answers
    and stats."""
    from bibfs_tpu.serve import DistanceCache as RefCache

    from bibfs_tpu_torch.serve import DistanceCache
    from bibfs_tpu_torch.serve.cache import walk_parents

    par = np.array([-1, 0, 1, 2], dtype=np.int32)
    assert walk_parents(par, 0, 3) == [0, 1, 2, 3]
    assert walk_parents(par, 0, 9) is None
    out = []
    for cache in (DistanceCache(entries=2, pair_entries=2),
                  RefCache(entries=2, pair_entries=2)):
        log = []
        cache.put_forest("g", 0, par, 4)
        log += [cache.lookup("g", 0, 3), cache.lookup("g", 3, 0),
                cache.lookup("g", 0, 99), cache.lookup("g", 5, 3)]
        cache.put_result("g", 7, 9, False, None, None)
        log.append(cache.lookup("g", 9, 7))
        for i in range(3):
            cache.put_result("g", i, i + 10, True, 1, [i, i + 10])
        cache.put_path("g", [4, 5, 6], 8)
        cache.put_forest("g", 1, par, 4)
        log += [cache.lookup("g", 6, 4), cache.lookup("h", 0, 3)]
        log.append(cache.invalidate("g"))
        log.append(cache.stats())
        out.append(log)
    assert out[0] == out[1]
    assert out[0][0] == (True, 3, [0, 1, 2, 3])
    assert out[0][1] == (True, 3, [3, 2, 1, 0])


def test_metrics_render_equals_reference():
    """The port's registry renders the same Prometheus text as the
    reference's for the same operations (counters, labelled gauges,
    histograms, bank views)."""
    from bibfs_tpu.obs import metrics as ref_metrics

    from bibfs_tpu_torch.obs import metrics

    def drive(mod):
        reg = mod.MetricsRegistry()
        c = reg.counter("bibfs_x_total", "x", ("engine",))
        c.labels(engine="a").inc(3)
        g = reg.gauge("bibfs_y", "y", ("cache",))
        g.labels(cache="b").set(2.5)
        g.labels(cache="b").set_max(1)
        h = reg.histogram("bibfs_z_seconds", "z", ("stage",))
        h.labels(stage="launch").record_many([1e-5, 3e-3, 0.2])
        bank = mod.MetricBank({"q": c.labels(engine="b")})
        bank["q"] += 2
        text = reg.render()
        lines = [ln for ln in text.splitlines() if "build_info" not in ln]
        return lines, dict(bank), h.labels(stage="launch").summary_ms()

    assert drive(metrics) == drive(ref_metrics)
    assert metrics.build_info_fields()["torch"] != "unknown"


def test_engine_families_match_reference():
    """Every ``bibfs_*`` family an engine mints in the port has the
    reference's kind and label names, so a scrape means the same thing."""
    from bibfs_tpu.obs.metrics import REGISTRY as REF
    from bibfs_tpu.serve import FaultPlan as RefPlan
    from bibfs_tpu.serve import QueryEngine as RefEngine

    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.serve import FaultPlan

    n, edges = GRAPHS["skiplink"]
    RefEngine(n, edges, faults=RefPlan.parse("host_batch:p=0.0"))
    _engine(n, edges, faults=FaultPlan.parse("host_batch:p=0.0"))
    names = [f.name for f in REGISTRY.families() if f.name != "bibfs_build_info"]
    assert "bibfs_route_fallbacks_total" in names
    assert "bibfs_stage_seconds" in names
    for name in names:
        ref = REF.get(name)
        assert ref is not None, name
        mine = REGISTRY.get(name)
        assert (mine.kind, mine.labelnames) == (ref.kind, ref.labelnames), name


# ---- the engine against the reference engine ------------------------
def _engine_graph(layout):
    return GRAPHS["skiplink"] if layout == "ell" else GRAPHS["rmat7"]


@pytest.mark.parametrize("device_batches", [True, False])
@pytest.mark.parametrize("layout", ["ell", "tiered"])
@pytest.mark.parametrize("mode",
                         ["auto", "minor8", "minor", "sync", "pallas", "fused"])
def test_engine_equals_reference(mode, layout, device_batches):
    """Two waves through both engines: 40 fresh pairs (a trivial one and
    a duplicate among them), then exact repeats, reverse twins and
    forest-path destinations. Results, counters, resilience accounting,
    cache and program stats all equal the reference's (minor8 on the
    tiered graph degrades to the host route in both, counted)."""
    from bibfs_tpu.serve import ExecutableCache as RefExec
    from bibfs_tpu.serve import QueryEngine as RefEngine

    n, edges = _engine_graph(layout)
    rng = np.random.default_rng(5)
    pairs = _rand_pairs(rng, n, 40)
    pairs[3] = (9, 9)
    pairs[7] = pairs[6]
    kw = dict(mode=mode, layout=layout, flush_threshold=8,
              device_batches=device_batches, cache_entries=32)
    ref = RefEngine(n, edges, exec_cache=RefExec(), **kw)
    eng = _engine(n, edges, **kw)
    waves = [pairs]
    want = ref.query_many(pairs)
    got = eng.query_many(pairs)
    second = np.concatenate([pairs[:10], pairs[10:20, ::-1]])
    extra = [(int(s), r.path[len(r.path) // 2])
             for (s, _d), r in zip(pairs[20:], want[20:]) if r.found]
    second = np.concatenate([second, np.array(extra, dtype=np.int64)
                             .reshape(-1, 2)])
    waves.append(second)
    want += ref.query_many(second)
    got += eng.query_many(second)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    _check_oracle(n, edges, np.concatenate(waves), got)
    assert dict(eng.counters) == dict(ref.counters)
    sr, st = ref.stats(), eng.stats()
    for key in ("errors", "fallbacks", "retries", "bisections"):
        assert st["resilience"][key] == sr["resilience"][key], key
    assert st["dist_cache"] == sr["dist_cache"]
    assert st["exec_cache"] == sr["exec_cache"]
    for key in ("solver_dispatch_free", "flush_threshold", "max_batch",
                "bucket", "device_batches_enabled", "ladder"):
        assert st[key] == sr[key], key
    assert st["graph"]["digest"] == sr["graph"]["digest"]
    if device_batches and mode == "minor8" and layout == "tiered":
        # minor8 refuses hub tiers: every device attempt fails, and each
        # degrade is retried and counted before the host answers
        assert st["resilience"]["fallbacks"]["device->host"] >= 1
        assert st["resilience"]["retries"] >= 1
        assert eng.counters["device_batches"] == 0
    elif device_batches:
        assert not any(st["resilience"]["fallbacks"].values())
        assert eng.counters["device_batches"] >= 1
        ran = {r.mode for r in got if r.mode is not None}
        assert ran == ({mode} if mode not in ("auto", "fused")
                       else {"minor8" if layout == "ell" else "minor"}
                       if mode == "auto" else {"pallas"})


@pytest.mark.parametrize("mode", ["minor8", "auto"])
def test_engine_minor8_refill_equals_reference(mode):
    """A flush padded from 5 queries to a 128-lane rung whose deepest
    query passes the int8 depth cap: the capped query is refilled through
    the int32 planes, and neither the pad lanes nor the refill change the
    counters or the banked forests against the reference's engine."""
    from bibfs_tpu.serve import ExecutableCache as RefExec
    from bibfs_tpu.serve import QueryEngine as RefEngine

    n = 300
    edges = np.array([[i, i + 1] for i in range(n - 1)])
    pairs = [(0, n - 1), (0, 10), (5, 200), (100, 280), (7, 9)]
    kw = dict(mode=mode, flush_threshold=2, device_batches=True,
              cache_entries=10)
    ref = RefEngine(n, edges, exec_cache=RefExec(), **kw)
    eng = _engine(n, edges, **kw)
    got, want = eng.query_many(pairs), ref.query_many(pairs)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert got[0].hops == n - 1 and got[0].path == list(range(n))
    assert {r.mode for r in got} == {"minor8"}
    assert dict(eng.counters) == dict(ref.counters)
    assert eng.counters["device_queries"] == len(pairs)
    assert eng.stats()["dist_cache"] == ref.stats()["dist_cache"]
    # the refilled query's target-side forest was banked: 200 lies in it
    assert eng.query(n - 1, 200).hops == n - 1 - 200
    assert eng.counters["cache_served"] == 1


def test_engine_stats_keys_follow_reference():
    from bibfs_tpu.serve import QueryEngine as RefEngine

    n, edges = GRAPHS["skiplink"]
    st = _engine(n, edges).stats()
    sr = RefEngine(n, edges).stats()
    assert set(st) - set(sr) == {"device"}
    assert st["device"] == "cpu"
    assert st["health"]["state"] == sr["health"]["state"] == "ready"


def test_solve_many_equals_reference():
    from bibfs_tpu.serve.resilience import QueryError as RefError
    from bibfs_tpu.solvers.api import solve_many as ref_solve_many

    from bibfs_tpu_torch.serve import QueryError
    from bibfs_tpu_torch.solvers.api import solve_many

    n, edges = GRAPHS["skiplink"]
    pairs = [tuple(p) for p in
             np.random.default_rng(5).integers(0, n, size=(34, 2))]
    for kw in (dict(flush_threshold=8, device_batches=True),
               dict(flush_threshold=4), dict(mode="minor")):
        got = solve_many(n, edges, pairs, device="cpu", **kw)
        want = ref_solve_many(n, edges, pairs, **kw)
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
    got = solve_many(n, edges, [(0, 40), (0, 999)], device="cpu",
                     return_errors=True)
    want = ref_solve_many(n, edges, [(0, 40), (0, 999)], return_errors=True)
    assert _fields(got[0]) == _fields(want[0])
    assert isinstance(got[1], QueryError) and isinstance(want[1], RefError)
    assert got[1].kind == want[1].kind == "invalid"
    assert str(got[1]) == str(want[1])


# ---- the reference's engine cases, against the port -----------------
def test_engine_device_batch_matches_oracle():
    n = 220
    edges = _skiplink_graph(n)
    eng = _engine(n, edges, flush_threshold=8, device_batches=True)
    pairs = _rand_pairs(np.random.default_rng(0), n, 40)
    pairs[3] = (9, 9)  # trivial
    results = eng.query_many(pairs)
    _check_oracle(n, edges, pairs, results)
    assert eng.counters["device_batches"] == 1
    assert eng.counters["device_queries"] == 39
    assert eng.counters["host_queries"] == 0
    assert eng.counters["trivial"] == 1
    assert eng.stats()["bucket"] == [256, 8]


def test_engine_host_fallback_below_crossover():
    n = 120
    edges = _skiplink_graph(n)
    eng = _engine(n, edges, flush_threshold=10, device_batches=True)
    pairs = [(0, n - 1), (3, 40), (5, 5)]
    results = eng.query_many(pairs)
    _check_oracle(n, edges, pairs, results)
    assert eng.counters["device_batches"] == 0
    assert eng.counters["host_queries"] == 2  # the trivial query never dispatches
    assert eng.stats()["host_backend"] == "native"
    assert eng.stats()["resilience"]["fallbacks"]["device->host"] == 0


def test_engine_cpu_device_routes_host():
    """An engine on the CPU sends even above-crossover flushes to the host
    runtime; host-solved paths bank as forest fragments, so a new
    destination on a served path answers from the cache."""
    n = 150
    edges = _skiplink_graph(n)
    eng = _engine(n, edges, flush_threshold=4)
    pairs = np.random.default_rng(1).integers(0, n, size=(12, 2))
    results = eng.query_many(pairs)
    _check_oracle(n, edges, pairs, results)
    assert not eng.stats()["device_batches_enabled"]
    assert eng.counters["device_batches"] == 0
    assert eng.counters["host_queries"] > 0
    src, res = next(((int(s), r) for (s, _d), r in zip(pairs, results)
                     if r.found and r.hops and r.hops >= 2))
    before = eng.counters["host_queries"]
    r2 = eng.query(src, res.path[1])
    assert r2.found and r2.hops == 1
    assert eng.counters["host_queries"] == before


def test_engine_disconnected_and_memo():
    eng = _engine(5, np.array([[0, 1], [1, 2], [3, 4]]), flush_threshold=1,
                  device_batches=True)
    assert not eng.query(0, 4).found
    before = (eng.counters["device_batches"], eng.counters["host_queries"])
    assert not eng.query(4, 0).found  # the reverse repeat, from the pair memo
    assert (eng.counters["device_batches"],
            eng.counters["host_queries"]) == before


def test_repeated_sources_zero_dispatch_after_warmup():
    """Exact repeats, reverse twins and new destinations inside a cached
    source forest answer from the distance cache with no dispatch."""
    n = 260
    edges = _skiplink_graph(n)
    eng = _engine(n, edges, flush_threshold=8, device_batches=True)
    pairs = _rand_pairs(np.random.default_rng(2), n, 33)
    pairs[0] = (0, n - 1)
    warm = eng.query_many(pairs)
    _check_oracle(n, edges, pairs, warm)
    dispatches = (eng.counters["device_batches"], eng.counters["host_queries"])
    served_before = eng.counters["cache_served"]
    again = eng.query_many(np.concatenate([pairs, pairs[:, ::-1]]))
    for a, b in zip(again[: len(pairs)], warm):
        assert a.found == b.found and a.hops == b.hops
    r = eng.query(0, warm[0].path[1])
    assert r.found and r.hops == 1
    assert (eng.counters["device_batches"],
            eng.counters["host_queries"]) == dispatches
    assert eng.counters["cache_served"] >= served_before + 2 * len(pairs)
    assert eng.dist_cache.stats()["hits"] > 0


def test_shape_bucket_single_batch_search():
    """Two graph sizes in one shape bucket share one built batch search:
    the shared program accounting says hit and the batch-minor search
    cache gains no entry for the second graph."""
    from bibfs_tpu_torch.serve import ExecutableCache
    from bibfs_tpu_torch.solvers import batch_minor as bm

    n1, n2 = 300, 450  # both bucket to 512 rows x width 8
    shared = ExecutableCache()
    rng = np.random.default_rng(3)
    eng1 = _engine(n1, _skiplink_graph(n1), flush_threshold=8,
                   device_batches=True, exec_cache=shared)
    eng2 = _engine(n2, _skiplink_graph(n2), flush_threshold=8,
                   device_batches=True, exec_cache=shared)
    assert eng1.graph.n_pad == eng2.graph.n_pad == 512
    assert eng1.graph.width == eng2.graph.width == 8
    p1 = rng.integers(0, n1, size=(40, 2))
    _check_oracle(n1, _skiplink_graph(n1), p1, eng1.query_many(p1))
    after_first = bm._build_minor_kernel.cache_info()
    assert shared.stats() == {"hits": 0, "misses": 1, "programs": 1}
    p2 = rng.integers(0, n2, size=(40, 2))
    _check_oracle(n2, _skiplink_graph(n2), p2, eng2.query_many(p2))
    after_second = bm._build_minor_kernel.cache_info()
    assert shared.stats() == {"hits": 1, "misses": 1, "programs": 1}
    assert after_second.misses == after_first.misses
    assert after_second.hits > after_first.hits


def test_flush_threshold_from_calibration(tmp_path, monkeypatch):
    """The default crossover is the calibrated one of the engine's
    device type (``cpu`` here), else the committed default; the
    reference's engine reads the same block."""
    from bibfs_tpu.serve import QueryEngine as RefEngine
    from bibfs_tpu.utils import calibrate as ref_calibrate

    from bibfs_tpu_torch.solvers.batch_minor import (
        SMALL_BATCH_SYNC,
        small_batch_threshold,
    )
    from bibfs_tpu_torch.utils import calibrate

    def clear():
        calibrate.clear_cache()
        ref_calibrate._read_calibration_file.cache_clear()

    edges = np.array([[0, 1], [1, 2]])
    cal = tmp_path / "calibration.json"
    cal.write_text(json.dumps({"cpu": {"batch_crossover": 7},
                               "cuda": {"batch_crossover": 9}}))
    monkeypatch.setenv(calibrate.CAL_ENV, str(cal))
    clear()
    try:
        assert small_batch_threshold("cpu") == 7
        assert small_batch_threshold("cuda") == 9
        assert _engine(40, edges).flush_threshold == 7
        assert RefEngine(40, edges).flush_threshold == 7
        cal.write_text(json.dumps({"cpu": {"batch_crossover": "x"}}))
        clear()
        assert _engine(40, edges).flush_threshold == SMALL_BATCH_SYNC
        assert small_batch_threshold("cuda") == SMALL_BATCH_SYNC
    finally:
        monkeypatch.delenv(calibrate.CAL_ENV)
        clear()
    # the committed calibration.json's cpu block, as the reference reads it
    assert _engine(40, edges).flush_threshold == RefEngine(
        40, edges).flush_threshold


def test_max_batch_chunking_and_autoflush():
    """A queue past max_batch flushes itself and solves in rung-sized
    chunks; a sub-crossover tail goes to the host route."""
    n = 200
    edges = _skiplink_graph(n)
    eng = _engine(n, edges, flush_threshold=8, max_batch=128,
                  device_batches=True)
    pairs = np.unique(_rand_pairs(np.random.default_rng(4), n, 400),
                      axis=0)[:131]
    assert len(pairs) == 131
    results = eng.query_many(pairs)
    _check_oracle(n, edges, pairs, results)
    assert eng.counters["device_batches"] == 1
    assert eng.counters["device_queries"] == 128
    assert eng.counters["host_queries"] == 3


def test_engine_tiered_layout():
    n, edges = GRAPHS["rmat7"]
    eng = _engine(n, edges, layout="tiered", flush_threshold=8,
                  device_batches=True)
    pairs = np.random.default_rng(6).integers(0, n, size=(33, 2))
    results = eng.query_many(pairs)
    _check_oracle(n, edges, pairs, results)
    assert eng.counters["device_batches"] == 1
    assert eng.graph.tier_meta  # the case really exercised hub tiers
    assert {r.mode for r in results if r.mode} == {"minor"}


def test_query_many_empty_short_circuits():
    eng = _engine(10, np.array([[0, 1]]))
    calls = []
    eng.flush = lambda: calls.append(1)
    assert eng.query_many([]) == []
    assert calls == []
    assert eng.counters["queries"] == 0


def test_device_flush_banking_hygiene():
    """One device flush dedupes repeated roots and banks at most
    ``cache_entries`` newest roots; the rest is counted, not copied."""
    n = 220
    edges = _skiplink_graph(n)
    eng = _engine(n, edges, flush_threshold=8, device_batches=True,
                  cache_entries=4)
    pairs = [(0, 40 + i) for i in range(10)]  # the src root repeats 10x
    results = eng.query_many(pairs)
    _check_oracle(n, edges, np.array(pairs), results)
    assert eng.counters["inserts_skipped"] == 16  # 20 chances, 11 roots, cap 4
    st = eng.dist_cache.stats()
    assert st["inserts"] == 4 and st["forest_evictions"] == 0
    before = (eng.counters["device_batches"], eng.counters["host_queries"])
    r = eng.query(0, 49)
    assert r.found and r.hops == results[-1].hops
    assert (eng.counters["device_batches"],
            eng.counters["host_queries"]) == before


def test_host_flush_banking_hygiene():
    n = 150
    edges = _skiplink_graph(n)
    eng = _engine(n, edges, flush_threshold=1000, cache_entries=2)
    pairs = [(i, i + 20) for i in range(8)]
    _check_oracle(n, edges, np.array(pairs), eng.query_many(pairs))
    assert eng.counters["host_queries"] == 8
    assert eng.counters["inserts_skipped"] == 6  # 8 found paths, cap 2


def test_host_batch_long_path_refill():
    """The threaded C batch caps path buffers at 512; a found-but-capped
    result is re-solved per query so the engine returns full paths."""
    n = 600
    edges = np.array([[i, i + 1] for i in range(n - 1)])
    eng = _engine(n, edges, flush_threshold=1000)
    pairs = [(0, n - 1), (1, n - 1), (0, 5), (3, 9)]
    results = eng.query_many(pairs)
    _check_oracle(n, edges, np.array(pairs), results)
    assert results[0].hops == n - 1 and len(results[0].path) == n


def test_host_backend_serial_and_native_equal():
    n, edges = GRAPHS["gnp300"]
    pairs = np.random.default_rng(8).integers(0, n, size=(12, 2))
    a = _engine(n, edges, host_backend="serial")
    b = _engine(n, edges, host_backend="native")
    ra, rb = a.query_many(pairs), b.query_many(pairs)
    assert a.stats()["host_backend"] == "serial"
    assert b.stats()["host_backend"] == "native"
    assert [(r.found, r.hops) for r in ra] == [(r.found, r.hops) for r in rb]
    _check_oracle(n, edges, pairs, ra)


def test_engine_range_checks_and_bad_arguments():
    edges = np.array([[0, 1]])
    eng = _engine(10, edges)
    with pytest.raises(ValueError):
        eng.query(0, 10)
    with pytest.raises(ValueError, match="store"):
        eng.submit(0, 1, graph="social")
    for kw, match in ((dict(layout="bogus"), "layout"),
                      (dict(mode="bogus"), "batch mode"),
                      (dict(host_backend="bogus"), "host_backend"),
                      (dict(max_batch=0), "max_batch")):
        with pytest.raises(ValueError, match=match):
            _engine(10, edges, **kw)


def test_drain_kill_close_lifecycle():
    from bibfs_tpu_torch.serve import QueryError
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n = 60
    edges = _skiplink_graph(n)
    with _engine(n, edges, flush_threshold=64) as eng:
        queued = eng.submit(0, 50)
        assert queued.result is None and eng.pending == 1
        eng.begin_drain()
        assert eng.health_snapshot()["state"] == "draining"
        with pytest.raises(QueryError) as exc:
            eng.submit(1, 40)
        assert exc.value.kind == "capacity"
        eng.flush()
        assert queued.result.hops == solve_serial(n, edges, 0, 50).hops
        eng.end_drain()
        assert eng.health_snapshot()["state"] == "ready"
        assert eng.query(1, 40).hops == solve_serial(n, edges, 1, 40).hops
        snap = eng._current_rt().snapshot
    assert eng.health_snapshot()["state"] == "draining"
    assert snap.retired  # close dropped the engine's pin
    with pytest.raises(ValueError, match="closed"):
        eng.submit(0, 1)
    assert eng.stats()["queries"] == 2
    killed = _engine(n, edges, flush_threshold=64)
    t = killed.submit(0, 50)
    killed.kill()
    assert isinstance(t.error, QueryError) and t.error.kind == "internal"
    assert killed.stats()["resilience"]["errors"]["internal"] == 1
    with pytest.raises(ValueError, match="closed"):
        killed.submit(0, 1)


def test_typed_point_to_point_queries():
    from bibfs_tpu_torch.query.types import PointToPoint

    n, edges = GRAPHS["skiplink"]
    eng = _engine(n, edges)
    r = eng.query_one(PointToPoint(0, 30))
    _check_oracle(n, edges, [(0, 30)], [r])
    again = eng.query_one((0, 30))  # a bare pair coerces; the memo answers
    assert (again.found, again.hops, again.path) == (r.found, r.hops, r.path)
    assert eng.counters["cache_served"] == 1
    mixed = eng.query_many([PointToPoint(1, 50), (2, 60)])
    _check_oracle(n, edges, [(1, 50), (2, 60)], mixed)


def test_flush_spans_are_traced():
    from bibfs_tpu_torch.obs.trace import Tracer, set_tracer

    n, edges = GRAPHS["skiplink"]
    eng = _engine(n, edges, flush_threshold=8, device_batches=True)
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        eng.query_many(_rand_pairs(np.random.default_rng(9), n, 12))
        eng.query_many([(0, 100), (1, 101)])
    finally:
        set_tracer(prev)
    names = {e["name"] for e in tracer.events() if e.get("ph") == "X"}
    assert {"flush", "device_launch", "device_finish", "bank_forests",
            "host_batch", "cache_lookup"} <= names


# ---- options of later slices, kernels that do not build -------------
@pytest.mark.parametrize("option,value", [
    pytest.param("store", object(), id="store-value0"),
    pytest.param("graph", "social", id="graph-social"),
    pytest.param("oracle_k", 4, id="oracle_k-4"),
    pytest.param("mesh", 2, id="mesh-2"),
])
def test_unported_options_raise(option, value):
    """The options once of later slices are ported and refuse what the
    reference refuses: ``mesh=`` a rank count below 1 (before any rank is
    spawned), an inline graph beside ``store=``, ``graph=`` without a
    store, and ``oracle_k`` beside ``store=`` (the store owns the
    oracles)."""
    from bibfs_tpu_torch.serve import QueryEngine
    from bibfs_tpu_torch.store import GraphStore

    n, edges = GRAPHS["skiplink"]
    if option == "mesh":
        from bibfs_tpu.serve import QueryEngine as RefEngine

        for bad in (-value, True):
            with pytest.raises(ValueError, match="mesh"):
                _engine(n, edges, **{option: bad})
            with pytest.raises(ValueError, match="mesh"):
                RefEngine(n, edges, **{option: bad})
        return
    if option == "oracle_k":
        store = GraphStore()
        store.add("g", n, edges)
        with pytest.raises(ValueError, match="oracle_k"):
            QueryEngine(store=store, oracle_k=value, device="cpu")
        assert store.current("g").refs == 1  # the refused engine took no pin
        return
    with pytest.raises(ValueError, match="store"):
        _engine(n, edges, **{option: value})


def test_unported_query_kinds_and_pipelined_raise():
    """The query kinds are ported (``MultiSource`` and ``Weighted`` answer
    as the serial oracle says); the whole-graph analytics kinds come with a
    later slice and raise ``NotImplementedError`` naming ROADMAP item 9 in
    both engines, counting no query; ``solve_many(pipelined=True)`` serves
    through the pipelined engine."""
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.query.types import MultiSource, Query, Weighted
    from bibfs_tpu_torch.solvers.api import solve_many
    from bibfs_tpu_torch.solvers.serial import solve_serial_csr

    class _Sssp(Query):
        kind = "sssp"

        def validate(self, n):
            pass

        def cache_key(self):
            return ("sssp",)

    n, edges = GRAPHS["skiplink"]
    rp, ci = build_csr(n, edges)
    eng = _engine(n, edges)
    ms = eng.query_one(MultiSource((0, 1), 5))
    assert ms.per_source == tuple(
        solve_serial_csr(n, rp, ci, s, 5).hops for s in (0, 1))
    assert eng.query_one(Weighted(0, 5)).found
    with pytest.raises(NotImplementedError, match="item 9"):
        eng.submit_query(_Sssp())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.query_many([_Sssp()], return_errors=True)
    assert eng.counters["queries"] == 2
    from bibfs_tpu_torch.serve import PipelinedQueryEngine

    with PipelinedQueryEngine(n, edges, device="cpu") as pipe:
        assert pipe.query_one(MultiSource((0, 1), 5)).per_source == \
            ms.per_source
        with pytest.raises(NotImplementedError, match="item 9"):
            pipe.submit_query(_Sssp())
        assert pipe.counters["queries"] == 1
    got = solve_many(n, edges, [(0, 1)], pipelined=True, device="cpu")
    assert _fields(got[0]) == _fields(eng.query(0, 1))


@pytest.mark.parametrize("mode,source", [
    ("auto", "batch_minor"), ("minor8", "batch_minor"),
    ("pallas", "pull_expand"), ("fused_alt", "pull_expand"),
])
def test_cuda_engine_build_failure_raises(monkeypatch, tmp_path, mode, source):
    """No fallback hides a kernel: a CUDA engine builds the kernels its
    mode launches in its constructor, and a build failure raises there
    (here: no nvcc) instead of degrading flushes to the host."""
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
    n, edges = GRAPHS["skiplink"]
    with pytest.raises(RuntimeError, match="nvcc"):
        QueryEngine(n, edges, mode=mode)
    assert asked == [source]
    # the torch-composed modes launch no kernel and need no build
    assert engine_mod._mode_sources("sync") == ()


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_minor8_on_tiered_layout(monkeypatch, device):
    """``minor8`` refuses hub tiers. A CUDA engine, which does not degrade
    a device failure to the host, refuses the pair at construction; on
    the CPU the engine keeps the JAX package's ladder (the tiered
    ``minor8`` case of ``test_engine_equals_reference``)."""
    import torch

    from bibfs_tpu_torch.serve import ExecutableCache, QueryEngine
    from bibfs_tpu_torch.serve import engine as engine_mod

    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda d=None: torch.device(device))
    n, edges = GRAPHS["rmat7"]
    make = lambda layout: QueryEngine(  # noqa: E731
        n, edges, mode="minor8", layout=layout, exec_cache=ExecutableCache())
    if device == "cuda":
        with pytest.raises(ValueError, match="minor8"):
            make("tiered")
    else:
        assert make("tiered").layout == "tiered"


def test_cuda_default_device_without_card_raises():
    import torch

    from bibfs_tpu_torch.serve import QueryEngine

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryEngine(*GRAPHS["skiplink"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "minor", "pallas", "pallas_alt"])
def test_cuda_engine_flush_equals_cpu_engine(mode):
    """On the card: a device flush through the CUDA kernels equals the
    CPU engine's flush (the plain torch versions) field for field, with
    no fallback and no retry."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from bibfs_tpu_torch.serve import ExecutableCache, QueryEngine

    n, edges = GRAPHS["gnp300"]
    pairs = _rand_pairs(np.random.default_rng(10), n, 40)
    kw = dict(mode=mode, flush_threshold=8, device_batches=True)
    gpu = QueryEngine(n, edges, device="cuda", exec_cache=ExecutableCache(),
                      **kw)
    cpu = _engine(n, edges, **kw)
    got, want = gpu.query_many(pairs), cpu.query_many(pairs)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert dict(gpu.counters) == dict(cpu.counters)
    assert gpu.counters["device_batches"] == 1
    res = gpu.stats()["resilience"]
    assert res["retries"] == 0 and not any(res["fallbacks"].values())
