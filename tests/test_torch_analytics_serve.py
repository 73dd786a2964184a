"""The analytics kinds through the port's serving stack
(``serve/routes/analytics.py`` behind both engines' ``submit_query``,
``GraphStore.analytics``, ``bibfs-torch-serve``'s stdin ``analytics``)
against the JAX package's on the same graph, on the CPU: every kind's
answers and the ``query_kinds`` / ``kind_cache`` / fallback stats with the
host rung and with the blocked rung forced (SSSP distances, labels, counts
and rounds exactly; the blocked rung's PageRank within 1e-6, its
iterations equal or one off where the reference's last delta straddles
the tolerance); the adaptive ladder's ``digest#kind`` entries; the
``analytics`` and ``analytics_finish`` chaos seams degrading with no lost
ticket; the four ``bibfs_analytics_*`` families; the result store through
the engines (a repeat from the ``store`` route, a delete barrier, adds-only
maintenance, a durable respawn, and the same directory as the
reference's); the stdin command; and, on a CUDA-typed engine, a blocked
rung's real failure failing its tickets while an injected fault degrades."""

import dataclasses
import io
import json

import numpy as np
import pytest

#: the blocked rung's PageRank ranks against the reference's (float32 sums
#: in another order than XLA's)
RANK_TOL = 1e-6
#: how near the tolerance the reference's last delta must lie for one
#: iteration more or less to be the other side of it
STRADDLE = 1e-7

# deliberately not a multiple of the 128 tile edge
N = 150


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _edges():
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    return gnp_random_graph(N, 8.0 / N, seed=21)


EDGES = _edges()
KINDS = ("sssp", "pagerank", "components", "triangles")


def _queries(A):
    """A flush of every kind: three SSSP sources over two weight seeds (two
    planes) with a repeat, two PageRank settings."""
    return [A.Sssp(4), A.Sssp(9), A.Sssp(4, weight_seed=1), A.Sssp(4),
            A.PageRank(), A.PageRank(damping=0.9, tol=1e-4),
            A.Components(), A.Triangles()]


def _same(a, b, blocked: bool = False, tol: float = 1e-8) -> bool:
    """Equal results: every field but the time, vectors entry for entry;
    a blocked rung's PageRank within :data:`RANK_TOL` and its iterations
    equal or one off at a straddled tolerance."""
    if isinstance(a, BaseException) or isinstance(b, BaseException):
        return (type(a).__name__, getattr(a, "kind", None)) == \
            (type(b).__name__, getattr(b, "kind", None))
    if type(a).__name__ != type(b).__name__:
        return False
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    if blocked and "ranks" in da:
        iters_ok = da["iters"] == db["iters"] or (
            abs(da["iters"] - db["iters"]) == 1
            and abs(db["delta"] - max(tol, 5e-7)) <= STRADDLE)
        return (da["found"] == db["found"] and iters_ok
                and float(np.max(np.abs(a.ranks - b.ranks))) <= RANK_TOL
                and abs(da["delta"] - db["delta"]) <= RANK_TOL)
    return all(np.array_equal(v, db[k]) for k, v in da.items()
               if k != "time_s")


def _force(eng, min_edges):
    for k in KINDS:
        eng.routes[f"{k}_blocked"].min_edges = min_edges
    return eng


def _kind_stats(eng) -> tuple:
    st = eng.stats()
    return (st["query_kinds"], st["kind_cache"],
            {k: v for k, v in st["resilience"]["fallbacks"].items() if v})


def _pair(pipelined=False, rung="host", **kw):
    import bibfs_tpu.serve as RS

    import bibfs_tpu_torch.serve as PS

    rcls = RS.PipelinedQueryEngine if pipelined else RS.QueryEngine
    pcls = PS.PipelinedQueryEngine if pipelined else PS.QueryEngine
    ref = rcls(N, EDGES, **kw)
    port = pcls(N, EDGES, device="cpu", **kw)
    min_edges = 1 << 30 if rung == "host" else 0
    return _force(ref, min_edges), _force(port, min_edges)


def _tol_of(q) -> float:
    return float(getattr(q, "tol", 1e-8))


@pytest.mark.parametrize("rung", ["host", "blocked"])
@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_engines_answer_every_kind_as_reference(pipelined, rung):
    import bibfs_tpu.analytics as RA

    import bibfs_tpu_torch.analytics as PA

    ref, port = _pair(pipelined, rung)
    blocked = rung == "blocked"
    try:
        for rnd in range(2):  # the second round: kind-cache hits
            want = ref.query_many(_queries(RA), return_errors=True)
            got = port.query_many(_queries(PA), return_errors=True)
            for q, a, b in zip(_queries(PA), got, want):
                assert _same(a, b, blocked, _tol_of(q)), (rnd, q, a, b)
            assert _kind_stats(port) == _kind_stats(ref), rnd
        kinds = port.stats()["query_kinds"]
        for k in KINDS:
            assert kinds[k].get(f"{k}_blocked" if blocked else k, 0) > 0
        for rq, pq in zip(_queries(RA), _queries(PA)):
            assert _same(port.query_one(pq), ref.query_one(rq), blocked,
                         _tol_of(pq))
        assert _kind_stats(port) == _kind_stats(ref)
        for k in KINDS:
            name = f"{k}_blocked"
            assert port.routes[name].stats()["crossover"] == \
                ref.routes[name].stats()["crossover"]
    finally:
        ref.close()
        port.close()


def test_sssp_blocked_planes_and_weight_tables():
    """A flush's same-seed sources share one plane (one launch a seed);
    the weight tables are memoized per seed, FIFO-bounded, on the
    engine's device, and the rounds counted are the reference's."""
    import bibfs_tpu.analytics as RA

    import bibfs_tpu_torch.analytics as PA
    from bibfs_tpu_torch.ops import semiring_plane

    ref, port = _pair(rung="blocked")
    try:
        calls = []
        real = semiring_plane.minplus_fixpoint_plain

        def spy(table, bcol, init, **kw):
            calls.append(init.shape[1])
            return real(table, bcol, init, **kw)

        semiring_plane.minplus_fixpoint_plain = spy
        try:
            got = port.query_many(_queries(PA)[:4])
        finally:
            semiring_plane.minplus_fixpoint_plain = real
        assert sorted(calls) == [1, 2]  # seed 0: sources 4, 9; seed 1: 4
        want = ref.query_many(_queries(RA)[:4])
        assert all(_same(a, b) for a, b in zip(got, want))
        rt = port._current_rt()
        for seed in range(10):
            port.query_one(PA.Sssp(0, weight_seed=seed))
        assert sorted(rt._awtabs) == list(range(2, 10))
        assert rt.analytics_weight_table(9) is rt._awtabs[9]
        assert rt._awtabs[9].device.type == "cpu"
        assert rt._awtabs[9].dtype.is_floating_point
    finally:
        ref.close()
        port.close()


def _adaptive_entries(eng) -> dict:
    out = {}
    for key, ent in eng.stats()["adaptive"]["digests"].items():
        if "#" not in key:
            continue
        routes = {r: {b: v["n"] for b, v in by.items()}
                  for r, by in ent["routes"].items()}
        out[key] = (routes, ent["last"], ent["explored"])
    return out


def test_adaptive_ladder_entries_equal_reference():
    import bibfs_tpu.analytics as RA
    from bibfs_tpu.store import GraphStore as RStore

    import bibfs_tpu_torch.analytics as PA
    import bibfs_tpu_torch.serve as PS
    from bibfs_tpu_torch.store import GraphStore as PStore
    import bibfs_tpu.serve as RS

    rs, ps = RStore(compact_threshold=None), PStore(compact_threshold=None,
                                                    device="cpu")
    rs.add("g", N, EDGES)
    ps.add("g", N, EDGES)
    ref = RS.QueryEngine(store=rs, graph="g", adaptive=True)
    port = PS.QueryEngine(store=ps, graph="g", adaptive=True, device="cpu")
    try:
        for A, eng in ((RA, ref), (PA, port)):
            eng.query_one(A.Sssp(2))
            eng.query_one(A.Triangles())
            eng.query_one(A.Components())
        got, want = _adaptive_entries(port), _adaptive_entries(ref)
        assert got == want
        assert {k.rsplit("#", 1)[1] for k in got} == {
            "sssp", "triangles", "components"}
    finally:
        ref.close()
        port.close()
        rs.close()
        ps.close()


@pytest.mark.parametrize("rung", ["host", "blocked"])
@pytest.mark.parametrize("site", ["analytics", "analytics_finish"])
def test_chaos_seams_degrade_with_no_lost_ticket(site, rung):
    """An injected fault at either seam degrades the kind down its ladder
    to the per-query fallback; every ticket is answered exactly, and the
    counters, cells and breakers are the reference's."""
    import bibfs_tpu.analytics as RA
    from bibfs_tpu.serve.faults import FaultPlan as RPlan

    import bibfs_tpu_torch.analytics as PA
    from bibfs_tpu_torch.serve.faults import FaultPlan as PPlan

    spec = f"{site}:times=50"
    clean_ref, _clean_port = _pair(rung=rung)
    _clean_port.close()
    ref, port = _pair(rung=rung)
    ref._faults = RPlan.parse(spec, seed=0)
    port._faults = PPlan.parse(spec, seed=0)
    try:
        want = clean_ref.query_many(_queries(RA), return_errors=True)
        got = port.query_many(_queries(PA), return_errors=True)
        faulted = ref.query_many(_queries(RA), return_errors=True)
        assert not any(isinstance(r, BaseException) for r in got)
        for a, b in zip(got, faulted):
            assert _same(a, b)  # the fallbacks are the host rungs'
        # the values of a fault-free run (a fallback solves each query
        # alone, so an SSSP's rounds are its own source's, not its plane's)
        for a, b in zip(got, want):
            for key in ("dist", "labels", "count"):
                if hasattr(a, key):
                    assert np.array_equal(getattr(a, key), getattr(b, key))
            if hasattr(a, "ranks"):
                assert np.max(np.abs(a.ranks - b.ranks)) <= RANK_TOL
        assert _kind_stats(port) == _kind_stats(ref)
        fallbacks = port.stats()["resilience"]["fallbacks"]
        assert sum(fallbacks.values()) > 0
        for k in KINDS:
            for name in (k, f"{k}_blocked"):
                assert port.routes[name].breaker.state == \
                    ref.routes[name].breaker.state, name
    finally:
        for e in (clean_ref, ref, port):
            e.close()


def test_metric_families_minted_like_reference():
    import bibfs_tpu.analytics as RA
    from bibfs_tpu.obs.metrics import REGISTRY as RREG

    import bibfs_tpu_torch.analytics as PA
    from bibfs_tpu_torch.obs.metrics import REGISTRY as PREG

    ref, port = _pair(rung="blocked")
    try:
        def cells(reg, label):
            fams = ("bibfs_analytics_rounds_total",
                    "bibfs_analytics_breaker_state")
            return sorted(
                line.replace(label, "E") for line in reg.render().splitlines()
                if line.startswith(fams) and f'engine="{label}"' in line)

        assert cells(PREG, port.obs_label) == cells(RREG, ref.obs_label)
        assert len(cells(PREG, port.obs_label)) == 8
        for A, eng in ((RA, ref), (PA, port)):
            eng.query_many(_queries(A))
        got, want = cells(PREG, port.obs_label), cells(RREG, ref.obs_label)
        # the rounds of every kind but PageRank's are exact; PageRank's
        # iterations may differ by one at a straddled tolerance
        strip = [c for c in got if 'kind="pagerank"' not in c
                 or "breaker" in c]
        assert strip == [c for c in want if 'kind="pagerank"' not in c
                         or "breaker" in c]
        # the store's two families, minted with a store
        from bibfs_tpu.store import GraphStore as RStore

        from bibfs_tpu_torch.store import GraphStore as PStore

        stores = (RStore(obs_label="fam-s"), PStore(obs_label="fam-s"))

        def store_cells(reg):
            fams = ("bibfs_analytics_store_events_total",
                    "bibfs_analytics_store_entries")
            return sorted(line for line in reg.render().splitlines()
                          if line.startswith(fams) and "fam-s" in line)

        assert store_cells(PREG) == store_cells(RREG)
        assert len(store_cells(PREG)) == 8
        for st in stores:
            st.close()
    finally:
        ref.close()
        port.close()


# ---- the result store through the engines ---------------------------------

def _analytics_dir_state(d) -> dict:
    """The result store's directory: arrays and ``meta.json`` but the
    solve time, by relative path."""
    import os

    out = {}
    for root, _dirs, files in sorted(os.walk(d)):
        for fname in sorted(files):
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, d)
            if fname.endswith(".npy"):
                out[rel] = np.load(path).tolist()
            else:
                with open(path) as f:
                    meta = json.load(f)
                meta["scalars"].pop("time_s", None)
                out[rel] = meta
    return out


def _events(store) -> dict:
    return store.analytics.stats()["events"]


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_result_store_through_engines_like_reference(tmp_path, pipelined):
    import bibfs_tpu.analytics as RA
    import bibfs_tpu.serve as RS
    from bibfs_tpu.store import GraphStore as RStore

    import bibfs_tpu_torch.analytics as PA
    import bibfs_tpu_torch.serve as PS
    from bibfs_tpu_torch.store import GraphStore as PStore

    n = 120
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    edges = gnp_random_graph(n, 7.0 / n, seed=9)
    sides = {}
    for who, St, Es, A in (("ref", RStore, RS, RA), ("port", PStore, PS, PA)):
        d = tmp_path / who
        d.mkdir()
        kw = {"device": "cpu"} if who == "port" else {}
        store = St(compact_threshold=None, wal_dir=str(d), fsync="off", **kw)
        store.add("g", n, edges)
        cls = Es.PipelinedQueryEngine if pipelined else Es.QueryEngine
        qs = [A.Sssp(5), A.PageRank(), A.Components(), A.Triangles()]
        eng1 = Es.QueryEngine(store=store, graph="g", **kw)
        first = [eng1.query_one(q) for q in qs]
        eng2 = cls(store=store, graph="g", **kw)
        second = [eng2.query_one(q) for q in qs]  # from the store
        k2 = eng2.stats()["query_kinds"]
        eng2.close()
        steps = [dict(_events(store))]
        dels = [tuple(e) for e in np.asarray(edges)[:3].tolist()]
        store.roll("g", adds=[(0, 77), (1, 90)], dels=dels)
        third = [eng1.query_one(q) for q in qs]
        steps.append(dict(_events(store)))
        store.update("g", adds=[(2, 101), (3, 88)])
        store.compact("g")
        fourth = [eng1.query_one(q) for q in (A.Sssp(5), A.Components())]
        steps.append(dict(_events(store)))
        k1 = eng1.stats()["query_kinds"]
        eng1.close()
        stats = store.stats()["analytics"]
        store.close()
        again = St.from_dir(str(d), durable=True, **kw)
        eng_r = Es.QueryEngine(store=again, graph="g", **kw)
        fifth = eng_r.query_one(A.Sssp(5))
        kr = eng_r.stats()["query_kinds"]
        steps.append(dict(_events(again)))
        eng_r.close()
        again.close()
        sides[who] = dict(answers=[first, second, third, fourth, [fifth]],
                          kinds=(k1, k2, kr), steps=steps, stats=stats,
                          dir=_analytics_dir_state(str(d / "analytics")))
    got, want = sides["port"], sides["ref"]
    for a_round, b_round in zip(got["answers"], want["answers"]):
        assert all(_same(a, b) for a, b in zip(a_round, b_round))
    assert got["kinds"] == want["kinds"]
    assert got["steps"] == want["steps"]
    assert got["stats"] == want["stats"]
    assert got["dir"] == want["dir"] and got["dir"]
    k1, k2, kr = got["kinds"]
    assert all(k2[k].get("store", 0) == 1 for k in KINDS)
    assert got["steps"][2]["incremental"] - got["steps"][1]["incremental"] == 2
    assert kr["sssp"].get("store", 0) == 1 and got["steps"][3]["load"] > 0


def test_stdin_analytics_command_like_reference(tmp_path, capsys,
                                                monkeypatch):
    from bibfs_tpu.graph.io import write_graph_bin
    from bibfs_tpu.serve.cli import main as ref_main

    from bibfs_tpu_torch.serve.cli import main as port_main

    gpath = tmp_path / "g.bin"
    write_graph_bin(gpath, N, EDGES)
    script = ("0 50\n"
              "analytics components\n"
              "analytics sssp source=4 weight_seed=1\n"
              "analytics pagerank damping=0.9 max_iters=50\n"
              "analytics triangles\n"
              "analytics katz\n"
              "analytics sssp bogus\n"
              "analytics sssp\n"
              "3 40\n")

    def run(main, *extra):
        monkeypatch.setattr("sys.stdin", io.StringIO(script))
        assert main([str(gpath), "--no-path", *extra]) == 0
        out = capsys.readouterr().out.strip().splitlines()
        lines = []
        for line in out:
            if line.startswith("analytics "):
                body = json.loads(line[len("analytics "):])
                body.pop("time_s")
                line = ("analytics", body)
            lines.append(line)
        return lines

    want = run(ref_main)
    got = run(port_main, "--device", "cpu")
    assert got == want
    assert sum(1 for x in got if isinstance(x, tuple)) == 4
    assert sum(str(x).startswith("error invalid:") for x in got) == 3


# ---- a CUDA-typed engine: no fallback hides a blocked rung's failure -------

@pytest.mark.parametrize("kind", KINDS)
def test_cuda_engine_blocked_rung_failure_fails_tickets(monkeypatch, kind):
    """On a CUDA engine a blocked rung that fails for real (here: no card
    to upload its tiles to) fails its tickets with ``kind='internal'``,
    feeds no breaker and counts no fallback; an injected fault at the
    ``analytics`` seam degrades to the host rungs, whose answers equal a
    CPU engine's."""
    import torch

    import bibfs_tpu_torch.analytics as PA
    import bibfs_tpu_torch.serve as PS
    from bibfs_tpu_torch.serve import engine as engine_mod
    from bibfs_tpu_torch.serve.faults import FaultPlan
    from bibfs_tpu_torch.serve.resilience import QueryError

    if torch.cuda.is_available():
        pytest.skip("a card is present: its rungs would not fail")
    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device=None: torch.device(device or "cuda"))
    q = {"sssp": PA.Sssp(3, weight_seed=1), "pagerank": PA.PageRank(),
         "components": PA.Components(), "triangles": PA.Triangles()}[kind]
    eng = _force(PS.QueryEngine(N, EDGES, mode="sync"), 0)
    with pytest.raises(QueryError) as err:
        eng.query_one(q)
    assert err.value.kind == "internal"
    st = eng.stats()
    assert not any(st["resilience"]["fallbacks"].values())
    assert eng.routes[f"{kind}_blocked"].breaker.state == "closed"
    assert st["query_kinds"].get(kind, {}) == {}
    cpu = PS.QueryEngine(N, EDGES, device="cpu")
    faulted = _force(PS.QueryEngine(
        N, EDGES, mode="sync", faults=FaultPlan.parse("analytics:times=50")),
        0)
    assert _same(faulted.query_one(q), cpu.query_one(q))
    st = faulted.stats()
    assert st["resilience"]["fallbacks"][f"{kind}_blocked->{kind}"] >= 1
    for e in (eng, cpu, faulted):
        e.close()
