"""Both serving engines of the port on the query kinds
(``QueryEngine.submit_query`` / ``PipelinedQueryEngine.submit_query`` over
``bibfs_tpu_torch.serve.routes.taxonomy`` and ``taxonomy_device``) against
the JAX package's engine on the same graph, on the CPU: the answers of
every kind (host rungs, and the device rungs forced on), the
``query_kinds`` cells, the kind cache's stats and the fallback counters
under every chaos site of the kinds; the overlay-pending path; ``AsOf``
across a hot swap on a durable store and an unknown version refused as
``kind='invalid'``; the analytics kinds refused naming ROADMAP item 9; the
metric families minted at construction; and, on a CUDA-typed engine, a
device rung's real failure failing its tickets while an injected fault
degrades to the host rung."""

import dataclasses

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


N = 240


def _edges():
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    return gnp_random_graph(N, 7 / N, seed=4)


EDGES = _edges()
SITES = ("msbfs", "weighted", "kshortest", "asof_replay", "msbfs_device",
         "weighted_device", "kshortest_device")


def _same(a, b) -> bool:
    """Equal results: the reference's fields but the time (the port's
    ``BFSResult`` adds ``mode`` and ``host_syncs``), or equal errors."""
    if isinstance(a, BaseException) or isinstance(b, BaseException):
        return (type(a).__name__, getattr(a, "kind", None)) == \
            (type(b).__name__, getattr(b, "kind", None))
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    return type(a).__name__ == type(b).__name__ and all(
        db[k] == v for k, v in da.items() if k != "time_s")


def _queries(Q, seed: int, n: int = N, version=None):
    """A mixed list: shared-source multi-source queries (with a repeat),
    weighted (two seeds), k-shortest (k = 1 and 3), typed point-to-point
    and, with ``version``, as-of queries."""
    rng = np.random.default_rng(seed)
    src = tuple(int(x) for x in rng.choice(n, 12, replace=False))
    out = []
    for _ in range(3):
        out.append(Q.MultiSource(src, int(rng.integers(n))))
    out.append(out[0])
    for ws in (0, 2):
        for _ in range(2):
            out.append(Q.Weighted(int(rng.integers(n)), int(rng.integers(n)),
                                  weight_seed=ws))
    for k in (1, 3):
        for _ in range(2):
            out.append(Q.KShortest(int(rng.integers(n)),
                                   int(rng.integers(n)), k=k))
    out.append(Q.PointToPoint(int(rng.integers(n)), int(rng.integers(n))))
    if version is not None:
        out.append(Q.AsOf(Q.PointToPoint(1, 2), version))
        out.append(Q.AsOf(Q.Weighted(3, 4, weight_seed=1), version))
    return out


def _force(eng):
    """Pin the device rungs on, whatever the calibration file says (the
    reference tests' own switch)."""
    eng.routes["msbfs_device"].min_sources = 1
    eng.routes["weighted_device"].min_batch = 1
    eng.routes["kshortest_device"].min_k = 2
    return eng


def _pair(device: bool, pipelined: bool = False, ref_pipelined=False, **kw):
    import bibfs_tpu.serve as RS

    import bibfs_tpu_torch.serve as PS

    rcls = RS.PipelinedQueryEngine if ref_pipelined else RS.QueryEngine
    pcls = PS.PipelinedQueryEngine if pipelined else PS.QueryEngine
    ref = rcls(N, EDGES, device_batches=device, **kw)
    port = pcls(N, EDGES, device="cpu", device_batches=device, **kw)
    if device:
        _force(ref)
        _force(port)
    return ref, port


def _kind_stats(eng) -> tuple:
    st = eng.stats()
    return (st["query_kinds"], st["kind_cache"],
            {k: v for k, v in st["resilience"]["fallbacks"].items() if v})


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_engines_answer_every_kind_as_reference(pipelined, device):
    import bibfs_tpu.query as RQ

    import bibfs_tpu_torch.query as PQ

    ref, port = _pair(device, pipelined, ref_pipelined=pipelined)
    try:
        # inline snapshots number their versions per process: each engine
        # is asked its own
        rv, pv = (e.stats()["graph"]["version"] for e in (ref, port))
        for rnd in range(2):  # the second round: kind-cache hits
            want = ref.query_many(_queries(RQ, 1, version=rv),
                                  return_errors=True)
            got = port.query_many(_queries(PQ, 1, version=pv),
                                  return_errors=True)
            assert all(_same(a, b) for a, b in zip(want, got)), [
                (a, b) for a, b in zip(want, got) if not _same(a, b)]
            assert _kind_stats(port) == _kind_stats(ref), rnd
        kinds = port.stats()["query_kinds"]
        if device:
            assert kinds["msbfs"].get("msbfs_device", 0) > 0
            assert kinds["weighted"].get("weighted_device", 0) > 0
            assert kinds["kshortest"].get("kshortest_device", 0) > 0
        assert port.stats()["solver_dispatch_free"] == \
            ref.stats()["solver_dispatch_free"]
        # single queries through query_one
        for rq, pq in zip(_queries(RQ, 5), _queries(PQ, 5)):
            assert _same(ref.query_one(rq), port.query_one(pq))
        assert _kind_stats(port) == _kind_stats(ref)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("site", SITES)
def test_fallback_counters_under_each_chaos_site(site):
    """An injected fault at a kind's site degrades it down its ladder with
    every answer exact; the counters, cells and breakers are the
    reference's."""
    import bibfs_tpu.query as RQ
    from bibfs_tpu.serve.faults import FaultPlan as RPlan

    import bibfs_tpu_torch.query as PQ
    from bibfs_tpu_torch.serve.faults import FaultPlan as PPlan

    spec = f"{site}:times=50"
    # a host rung's site fires where its device rung stands aside
    ref, port = _pair(site.endswith("_device"), faults=None)
    ref._faults = RPlan.parse(spec, seed=0)
    port._faults = PPlan.parse(spec, seed=0)
    try:
        rv, pv = (e.stats()["graph"]["version"] for e in (ref, port))
        for seed in (2, 3):
            want = ref.query_many(_queries(RQ, seed, version=rv),
                                  return_errors=True)
            got = port.query_many(_queries(PQ, seed, version=pv),
                                  return_errors=True)
            assert all(_same(a, b) for a, b in zip(want, got)), seed
        assert _kind_stats(port) == _kind_stats(ref)
        fallbacks = port.stats()["resilience"]["fallbacks"]
        assert sum(v for k, v in fallbacks.items()
                   if k.startswith(site.replace("_replay", ""))) > 0
        for name in ("msbfs", "weighted", "kshortest", "asof",
                     "msbfs_device", "weighted_device", "kshortest_device"):
            assert port.routes[name].breaker.state == \
                ref.routes[name].breaker.state, name
    finally:
        ref.close()
        port.close()


def _stores(tmp_path=None, **kw):
    from bibfs_tpu.store import GraphStore as RStore

    from bibfs_tpu_torch.store import GraphStore as PStore

    if tmp_path is not None:
        (tmp_path / "ref").mkdir()
        (tmp_path / "port").mkdir()
        ref = RStore(wal_dir=str(tmp_path / "ref"), **kw)
        port = PStore(wal_dir=str(tmp_path / "port"), device="cpu", **kw)
    else:
        ref, port = RStore(**kw), PStore(device="cpu", **kw)
    ref.add("g", N, EDGES)
    port.add("g", N, EDGES)
    return ref, port


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_overlay_pending_answers_exactly_cache_aside(pipelined):
    import bibfs_tpu.query as RQ
    import bibfs_tpu.serve as RS

    import bibfs_tpu_torch.query as PQ
    import bibfs_tpu_torch.serve as PS

    rs, ps = _stores()
    rcls = RS.PipelinedQueryEngine if pipelined else RS.QueryEngine
    ref = _force(rcls(store=rs, graph="g", device_batches=True))
    cls = PS.PipelinedQueryEngine if pipelined else PS.QueryEngine
    port = _force(cls(store=ps, graph="g", device="cpu", device_batches=True))
    try:
        base = port.query_many(_queries(PQ, 7), return_errors=True)
        ref.query_many(_queries(RQ, 7), return_errors=True)
        adds = [(0, N - 1), (5, 77), (12, 200)]
        dels = [tuple(int(x) for x in EDGES[0])]
        rs.update("g", adds=adds, dels=dels)
        ps.update("g", adds=adds, dels=dels)
        want = ref.query_many(_queries(RQ, 7), return_errors=True)
        got = port.query_many(_queries(PQ, 7), return_errors=True)
        assert all(_same(a, b) for a, b in zip(want, got))
        assert _kind_stats(port) == _kind_stats(ref)
        one = port.query_one(PQ.MultiSource((0,), N - 1))
        assert one.hops == 1  # the pending edge answered exactly
        kinds = port.stats()["query_kinds"]
        # the overlay-merged truth stays on the host rungs
        assert kinds["msbfs"].get("msbfs", 0) > 0
        assert len(base) == len(got)
    finally:
        ref.close()
        port.close()
        rs.close()
        ps.close()


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_asof_across_hot_swap_and_unknown_version(tmp_path, pipelined):
    import bibfs_tpu.query as RQ
    import bibfs_tpu.serve as RS

    import bibfs_tpu_torch.query as PQ
    import bibfs_tpu_torch.serve as PS
    from bibfs_tpu_torch.serve.resilience import QueryError

    rs, ps = _stores(tmp_path, retain_history=True)
    rcls = RS.PipelinedQueryEngine if pipelined else RS.QueryEngine
    ref = _force(rcls(store=rs, graph="g", device_batches=True))
    cls = PS.PipelinedQueryEngine if pipelined else PS.QueryEngine
    port = _force(cls(store=ps, graph="g", device="cpu", device_batches=True))
    try:
        v1 = ps.current("g").version
        assert v1 == rs.current("g").version

        def asof(Q, v):
            return [Q.AsOf(Q.PointToPoint(0, N - 1), v),
                    Q.AsOf(Q.MultiSource((0, 3, 9), N - 1), v),
                    Q.AsOf(Q.Weighted(0, N - 1, weight_seed=2), v),
                    Q.AsOf(Q.KShortest(0, N - 1, k=2), v)]

        first = port.query_many(asof(PQ, v1), return_errors=True)
        assert all(_same(a, b) for a, b in zip(
            ref.query_many(asof(RQ, v1), return_errors=True), first))
        for store in (rs, ps):  # a hot swap to version 2
            store.update("g", adds=[(0, N - 1)])
            store.compact("g")
        v2 = ps.current("g").version
        assert v2 == rs.current("g").version and v2 != v1
        for v in (v1, v2):
            want = ref.query_many(asof(RQ, v), return_errors=True)
            got = port.query_many(asof(PQ, v), return_errors=True)
            assert all(_same(a, b) for a, b in zip(want, got)), v
        assert port.query_one(PQ.AsOf(PQ.PointToPoint(0, N - 1), v2)).hops \
            == 1
        ref.query_one(RQ.AsOf(RQ.PointToPoint(0, N - 1), v2))
        again = port.query_many(asof(PQ, v1), return_errors=True)
        ref.query_many(asof(RQ, v1), return_errors=True)
        assert all(_same(a, b) for a, b in zip(first, again))
        # an unknown version is the client's error, not the route's
        with pytest.raises(QueryError) as err:
            port.query_one(PQ.AsOf(PQ.PointToPoint(0, 1), 999))
        assert err.value.kind == "invalid"
        with pytest.raises(Exception) as rerr:
            ref.query_one(RQ.AsOf(RQ.PointToPoint(0, 1), 999))
        assert getattr(rerr.value, "kind", None) == "invalid"
        assert port.routes["asof"].breaker.state == "closed"
        assert _kind_stats(port) == _kind_stats(ref)
        assert port.routes["asof"].stats()["replays"] == \
            ref.routes["asof"].stats()["replays"]
    finally:
        ref.close()
        port.close()
        rs.close()
        ps.close()


@pytest.mark.parametrize("kind", ["sssp", "pagerank", "components",
                                  "triangles"])
@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_analytics_kinds_raise_naming_item_9(kind, pipelined):
    import bibfs_tpu_torch.serve as PS
    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.query.types import Query

    class _Analytics(Query):
        def validate(self, n):
            pass

        def cache_key(self):
            return (kind,)

    _Analytics.kind = kind
    cls = PS.PipelinedQueryEngine if pipelined else PS.QueryEngine
    with cls(N, EDGES, device="cpu") as eng:
        with pytest.raises(NotImplementedError, match="item 9"):
            eng.submit_query(_Analytics())
        assert eng.counters["queries"] == 0
        # its cells render at zero, as the reference mints them
        text = REGISTRY.render()
        assert (f'bibfs_query_total{{engine="{eng.obs_label}",kind="{kind}",'
                f'route="store"}} 0') in text


def test_kind_tables_and_metric_families_equal_reference():
    import bibfs_tpu.serve.routes.taxonomy as R
    from bibfs_tpu.obs.names import QUERY_METRIC_FAMILIES

    import bibfs_tpu_torch.serve as PS
    import bibfs_tpu_torch.serve.routes.taxonomy as P
    import bibfs_tpu_torch.serve.routes.taxonomy_device as PD
    import bibfs_tpu.serve.routes.taxonomy_device as RD
    from bibfs_tpu_torch.obs.metrics import REGISTRY

    assert P.KIND_ROUTES == R.KIND_ROUTES
    assert P.KIND_LADDERS == R.KIND_LADDERS
    assert P.KIND_ROUTE_LABELS == R.KIND_ROUTE_LABELS
    for name in ("DEFAULT_MSBFS_DEVICE_MIN_SOURCES",
                 "DEFAULT_WEIGHTED_DEVICE_MIN_BATCH",
                 "DEFAULT_KSHORTEST_DEVICE_MIN_K"):
        assert getattr(PD, name) == getattr(RD, name)
    eng = PS.QueryEngine(N, EDGES, device="cpu")
    text = REGISTRY.render()
    for fam in QUERY_METRIC_FAMILIES:
        assert f"# TYPE {fam} " in text, fam
    label = eng.obs_label
    for kind, route in P.KIND_ROUTE_LABELS:
        assert (f'bibfs_query_total{{engine="{label}",kind="{kind}",'
                f'route="{route}"}} 0') in text
    for kind in ("msbfs", "weighted", "kshortest"):
        assert (f'bibfs_query_device_breaker_state{{engine="{label}",'
                f'kind="{kind}"}} 0') in text
    assert f'bibfs_msbfs_breaker_state{{engine="{label}"}} 0' in text
    # the CPU engine's crossovers come from the cpu calibration block,
    # the reference's on the CPU
    import bibfs_tpu.serve as RS

    ref = RS.QueryEngine(N, EDGES)
    for name in ("msbfs_device", "weighted_device", "kshortest_device"):
        assert eng.routes[name].stats()["crossover"] == \
            ref.routes[name].stats()["crossover"]
    eng.close()
    ref.close()


def test_query_many_mixed_and_invalid_slots():
    """Pairs and typed queries in one list; an invalid typed query costs
    its slot only, as in the reference."""
    import bibfs_tpu.query as RQ

    import bibfs_tpu_torch.query as PQ
    from bibfs_tpu_torch.solvers.api import solve_many

    ref, port = _pair(True)
    try:
        def mixed(Q):
            return [(0, 5), Q.MultiSource((1, N + 3), 7), Q.Weighted(2, 9),
                    Q.KShortest(4, 4, k=2), Q.KShortest(3, 8, k=0), (6, 6),
                    Q.AsOf(Q.PointToPoint(1, 2), 12345)]

        want = ref.query_many(mixed(RQ), return_errors=True)
        got = port.query_many(mixed(PQ), return_errors=True)
        assert all(_same(a, b) for a, b in zip(want, got))
        assert _kind_stats(port) == _kind_stats(ref)
        from bibfs_tpu.solvers.api import solve_many as ref_solve_many

        res = solve_many(N, EDGES, [PQ.Weighted(2, 9), (0, 5)], device="cpu")
        want = ref_solve_many(N, EDGES, [RQ.Weighted(2, 9), (0, 5)])
        assert all(_same(a, b) for a, b in zip(want, res))
    finally:
        ref.close()
        port.close()


def test_weight_memos_are_bounded_fifo():
    import bibfs_tpu_torch.query as PQ
    import bibfs_tpu_torch.serve as PS

    eng = _force(PS.QueryEngine(N, EDGES, device="cpu", device_batches=True))
    rt = eng._current_rt()
    for seed in range(10):
        eng.query_one(PQ.Weighted(0, 9, weight_seed=seed))
    assert sorted(rt._weights) == list(range(2, 10))
    assert sorted(rt._wtables) == list(range(2, 10))
    rp, ci = rt.snapshot.csr()
    assert rt.weights_for(9, rp, ci) is rt._weights[9]
    tgt, _w = rt.weighted_device_tables(9)
    assert tgt.device.type == "cpu" and tgt.dtype.is_floating_point is False
    eng.close()


# ---- a CUDA-typed engine: no fallback hides a device rung's failure --------

@pytest.mark.parametrize("kind", ["msbfs", "weighted", "kshortest"])
def test_cuda_engine_device_rung_failure_fails_tickets(monkeypatch, kind):
    """On a CUDA engine a device rung that fails for real (here: no card to
    upload its tables to) fails its tickets with ``kind='internal'``,
    feeds no breaker and counts no fallback; an injected fault at its site
    degrades to the host rung, whose answers equal a CPU engine's."""
    import torch

    import bibfs_tpu_torch.query as PQ
    import bibfs_tpu_torch.serve as PS
    from bibfs_tpu_torch.serve import engine as engine_mod
    from bibfs_tpu_torch.serve.faults import FaultPlan
    from bibfs_tpu_torch.serve.resilience import QueryError

    if torch.cuda.is_available():
        pytest.skip("a card is present: its rungs would not fail")
    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device=None: torch.device(device or "cuda"))
    src = tuple(range(0, 120, 10))
    q = {"msbfs": PQ.MultiSource(src, 7),
         "weighted": PQ.Weighted(3, 77, weight_seed=1),
         "kshortest": PQ.KShortest(3, 77, k=3)}[kind]
    eng = PS.QueryEngine(N, EDGES, mode="sync")
    with pytest.raises(QueryError) as err:
        eng.query_one(q)
    assert err.value.kind == "internal"
    st = eng.stats()
    assert not any(st["resilience"]["fallbacks"].values())
    assert eng.routes[f"{kind}_device"].breaker.state == "closed"
    assert st["query_kinds"].get(kind, {}) == {}
    cpu = PS.QueryEngine(N, EDGES, device="cpu")
    faulted = PS.QueryEngine(N, EDGES, mode="sync",
                             faults=FaultPlan.parse(f"{kind}_device:times=9"))
    got = faulted.query_one(q)
    assert _same(cpu.query_one(q), got)
    st = faulted.stats()
    assert st["resilience"]["fallbacks"][f"{kind}_device->{kind}"] >= 1
    assert st["query_kinds"][kind] == {kind: 1}
    for e in (eng, cpu, faulted):
        e.close()
