"""The port's analytics units (``bibfs_tpu_torch.analytics``: the semiring
host rungs, the query kinds and their specs and summaries, the per-digest
result store and its maintenance) against the JAX package's on the CPU:
the host rungs' vectors and counts bit for bit at a non-tile-multiple n
and pinned to the independent ``ref_*`` functions, the spec builder's
queries and rejects, the summaries, the result store's events across a
hit, a delete barrier, adds-only maintenance and a durable respawn, and
each package adopting the other's ``analytics/`` directory."""

import json

import numpy as np
import pytest

# deliberately not a multiple of the 128 tile edge
N = 137


def _graph(seed=3, n=N, p=None):
    from bibfs_tpu.graph.csr import build_csr
    from bibfs_tpu.graph.generate import gnp_random_graph

    edges = gnp_random_graph(n, p if p is not None else 6.0 / n, seed=seed)
    rp, ci = build_csr(n, edges)
    return n, edges, rp, ci


def _mods():
    from bibfs_tpu.analytics import semiring as ref

    from bibfs_tpu_torch.analytics import semiring as port

    return ref, port


# ---- the host rungs, bit for bit ------------------------------------------

@pytest.mark.parametrize("seed,p", [(3, None), (11, 2.0 / N), (13, 10.0 / N)])
def test_host_rungs_equal_jax_package(seed, p):
    from bibfs_tpu.query.weighted import synthetic_weights

    ref, port = _mods()
    n, _edges, rp, ci = _graph(seed=seed, p=p)
    w = synthetic_weights(rp, ci, 0)
    for a, b in zip(port.host_sssp(n, rp, ci, w, [5, 99]),
                    ref.host_sssp(n, rp, ci, w, [5, 99])):
        assert np.array_equal(a, b)
    for kw in ({}, dict(damping=0.9, tol=1e-10, max_iters=300)):
        got = port.host_pagerank(n, rp, ci, **kw)
        want = ref.host_pagerank(n, rp, ci, **kw)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    got = port.host_components(n, rp, ci)
    want = ref.host_components(n, rp, ci)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert port.host_triangles(n, rp, ci) == ref.host_triangles(n, rp, ci)
    assert port.host_triangles(n, rp, ci, chunk=16) == ref.host_triangles(
        n, rp, ci, chunk=16)


def test_host_rungs_match_independent_references():
    from bibfs_tpu_torch.query.weighted import (
        dijkstra_numpy,
        synthetic_weights,
    )

    _ref, port = _mods()
    n, edges, rp, ci = _graph(seed=7, p=10.0 / N)
    w = synthetic_weights(rp, ci, 0)
    dist, rounds = port.host_sssp(n, rp, ci, w, [5])
    want, _ = dijkstra_numpy(n, rp, ci, w, 5)
    assert rounds >= 1 and np.array_equal(dist[:, 0], want)
    ranks, _it, delta = port.host_pagerank(n, rp, ci, tol=1e-10,
                                           max_iters=300)
    assert delta <= 1e-10 and abs(ranks.sum() - 1.0) < 1e-9
    assert np.max(np.abs(ranks - port.ref_pagerank_dense(
        n, rp, ci, tol=1e-10, max_iters=300))) < 1e-8
    labels, count, _ = port.host_components(n, rp, ci)
    assert (labels.tolist(), count) == tuple(
        x.tolist() if hasattr(x, "tolist") else x
        for x in port.ref_components_unionfind(n, edges))
    assert port.host_triangles(n, rp, ci)[0] == port.ref_triangles_intersect(
        n, rp, ci) > 0


def test_references_equal_jax_package():
    ref, port = _mods()
    n, edges, rp, ci = _graph(seed=5, p=9.0 / N)
    assert np.array_equal(port.ref_pagerank_dense(n, rp, ci),
                          ref.ref_pagerank_dense(n, rp, ci))
    got, want = (port.ref_components_unionfind(n, edges),
                 ref.ref_components_unionfind(n, edges))
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert port.ref_triangles_intersect(n, rp, ci) == \
        ref.ref_triangles_intersect(n, rp, ci)
    assert set(port.SEMIRINGS) == set(ref.SEMIRINGS)
    for name, sr in port.SEMIRINGS.items():
        plane = np.arange(n * 2, dtype=sr.dtype).reshape(n, 2) % 7
        assert np.array_equal(
            port.csr_semiring_matvec(n, rp, ci, plane, sr),
            ref.csr_semiring_matvec(n, rp, ci, plane, ref.SEMIRINGS[name]))


def test_empty_and_disconnected_like_jax_package():
    from bibfs_tpu.graph.csr import build_csr
    from bibfs_tpu.query.weighted import synthetic_weights

    ref, port = _mods()
    for n, edges in ((9, np.zeros((0, 2), dtype=np.int64)),
                     (7, np.array([[0, 1], [1, 2], [2, 3], [0, 3],
                                   [4, 5], [5, 6], [4, 6]]))):
        rp, ci = build_csr(n, edges)
        w = synthetic_weights(rp, ci, 0)
        for fn, args in ((lambda m: m.host_sssp, (n, rp, ci, w, [0])),
                         (lambda m: m.host_pagerank, (n, rp, ci)),
                         (lambda m: m.host_components, (n, rp, ci)),
                         (lambda m: m.host_triangles, (n, rp, ci))):
            got, want = fn(port)(*args), fn(ref)(*args)
            for a, b in zip(got, want):
                assert np.array_equal(a, b)


# ---- the query kinds --------------------------------------------------------

def test_kind_taxonomy_like_jax_package():
    import bibfs_tpu.analytics as ref

    import bibfs_tpu_torch.analytics as port
    from bibfs_tpu_torch.serve.routes import taxonomy

    assert port.ANALYTICS_KINDS == ref.ANALYTICS_KINDS
    assert sorted(port.__all__) == sorted(ref.__all__)
    for kind in port.ANALYTICS_KINDS:
        assert taxonomy.KIND_LADDERS[kind] == (f"{kind}_blocked", kind,
                                               "host")
    queries = [(port.Sssp(7, weight_seed=2), ref.Sssp(7, weight_seed=2)),
               (port.PageRank(0.9, 1e-6, 40), ref.PageRank(0.9, 1e-6, 40)),
               (port.Components(), ref.Components()),
               (port.Triangles(), ref.Triangles())]
    for p, r in queries:
        assert (p.kind, p.cache_key(), p.rep_pair()) == \
            (r.kind, r.cache_key(), r.rep_pair())


@pytest.mark.parametrize("kind,params", [
    ("sssp", {"source": "7", "weight_seed": 2}),
    ("pagerank", {"damping": "0.9", "tol": 1e-6, "max_iters": "40"}),
    ("pagerank", {}),
    ("components", {}),
    ("triangles", None),
])
def test_query_from_spec_roundtrip(kind, params):
    from bibfs_tpu.analytics.queries import analytics_query_from_spec as ref

    from bibfs_tpu_torch.analytics.queries import analytics_query_from_spec

    got = analytics_query_from_spec(kind, params)
    want = ref(kind, params)
    assert (got.kind, got.cache_key()) == (want.kind, want.cache_key())


@pytest.mark.parametrize("kind,params,msg", [
    ("katz", {}, "unknown analytics kind"),
    ("sssp", {}, "needs source"),
    ("sssp", {"source": 1, "bogus": 2}, "unknown sssp params"),
    ("triangles", {"chunk": 4}, "unknown triangles params"),
])
def test_query_from_spec_rejects_like_jax_package(kind, params, msg):
    from bibfs_tpu.analytics.queries import analytics_query_from_spec as ref

    from bibfs_tpu_torch.analytics.queries import analytics_query_from_spec

    with pytest.raises(ValueError, match=msg) as got:
        analytics_query_from_spec(kind, params)
    with pytest.raises(ValueError) as want:
        ref(kind, params)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [
    lambda m: m.PageRank(damping=1.0), lambda m: m.PageRank(tol=0.0),
    lambda m: m.PageRank(max_iters=0)])
def test_query_validation_like_jax_package(bad):
    import bibfs_tpu.analytics as ref

    import bibfs_tpu_torch.analytics as port

    with pytest.raises(ValueError) as got:
        bad(port).validate(N)
    with pytest.raises(ValueError) as want:
        bad(ref).validate(N)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        port.Sssp(N).validate(N)


def test_summaries_like_jax_package():
    import bibfs_tpu.analytics.queries as rq
    from bibfs_tpu.query.weighted import synthetic_weights

    import bibfs_tpu_torch.analytics.queries as pq

    ref, port = _mods()
    n, _edges, rp, ci = _graph(seed=5)
    w = synthetic_weights(rp, ci, 0)
    dist, rounds = port.host_sssp(n, rp, ci, w, [0])
    ranks, iters, delta = port.host_pagerank(n, rp, ci)
    labels, count, crounds = port.host_components(n, rp, ci)
    tri, _ = port.host_triangles(n, rp, ci)
    reached = int(np.isfinite(dist[:, 0]).sum())
    for m in (pq, rq):
        m.results = [
            m.SsspResult(True, dist[:, 0], reached, rounds, 0.5),
            m.PageRankResult(True, ranks, iters, delta, 0.5),
            m.ComponentsResult(True, labels, count, crounds, 0.5),
            m.TrianglesResult(True, tri, 0.5),
        ]
    for got, want in zip(pq.results, rq.results):
        s = pq.analytics_summary(got)
        assert s == rq.analytics_summary(want)
        json.dumps(s)
    del pq.results, rq.results
    with pytest.raises(ValueError, match="not an analytics result"):
        pq.analytics_summary(object())
    # read-only vectors: answers are shared between tickets
    r = pq.SsspResult(True, np.zeros(3), 3, 1, 0.0)
    with pytest.raises(ValueError):
        r.dist[0] = 1.0


# ---- the result store -------------------------------------------------------

def _stores(tmp_path=None, label="t"):
    from bibfs_tpu.analytics.results import AnalyticsResultStore as Ref

    from bibfs_tpu_torch.analytics.results import AnalyticsResultStore

    root = None if tmp_path is None else str(tmp_path)
    return {
        "ref": Ref(None if root is None else root + "/ref",
                   store_label=f"{label}-ref"),
        "port": AnalyticsResultStore(
            None if root is None else root + "/port",
            store_label=f"{label}-port"),
    }


def _drive_lifecycle(st):
    """A hit, a delete barrier, adds-only maintenance and a swap; returns
    what the store said at each step and its stats."""
    seen = []
    st.note_register("g", "d0")
    st.put("g", ("triangles",), "d0", "triangles", {},
           {"count": 4, "found": True})
    st.put("g", ("components",), "d0", "components",
           {"labels": np.arange(5, dtype=np.int64)}, {"count": 5})
    got = st.lookup("g", ("triangles",), "d0")
    seen.append((got[0], got[1].scalars["count"]))
    st.note_update("g", np.array([[1, 2]]), None)
    st.note_fold("g", "d1", clean=True)
    got = st.lookup("g", ("components",), "d1")
    seen.append((got[0], got[2].tolist()))
    st.commit_maintained("g", ("components",), "d1", "components",
                         {"labels": np.array([0, 1, 1, 3, 4])},
                         {"count": 4})
    seen.append(st.lookup("g", ("triangles",), "d1"))  # value-global: gone
    st.note_update("g", np.array([[3, 4]]), np.array([[0, 1]]))
    st.note_fold("g", "d2", clean=True)
    seen.append(st.lookup("g", ("components",), "d2"))  # a delete: barrier
    st.put("g", ("sssp", 0, 0), "d2", "sssp", {"dist": np.zeros(5)},
           {"found": True, "reached": 5, "rounds": 1, "time_s": 0.0})
    st.note_update("g", None, None)
    st.note_fold("g", "d3", clean=True)
    got = st.lookup("g", ("sssp", 0, 0), "d3")
    seen.append(got[0])  # an empty delta serves as a hit
    st.note_swap("g", "d4")
    seen.append(st.lookup("g", ("sssp", 0, 0), "d4"))
    st.purge("g")
    return seen, st.stats()


def test_result_store_lifecycle_like_jax_package(tmp_path):
    for root in (None, tmp_path):
        got = {who: _drive_lifecycle(st)
               for who, st in _stores(root, label=f"life-{root is None}")
               .items()}
        assert got["port"] == got["ref"]
        assert got["port"][1]["events"]["incremental"] == 1


def test_result_store_metric_families_like_jax_package():
    from bibfs_tpu.obs.metrics import REGISTRY as RR

    from bibfs_tpu_torch.analytics.results import STORE_EVENTS
    from bibfs_tpu_torch.obs.metrics import REGISTRY as PR

    _stores(label="fam")
    for reg, who in ((PR, "port"), (RR, "ref")):
        text = reg.render()
        for e in STORE_EVENTS:
            assert (f'bibfs_analytics_store_events_total{{store="fam-{who}",'
                    f'event="{e}"}} 0') in text
        assert f'bibfs_analytics_store_entries{{store="fam-{who}"}} 0' in text


def test_maintenance_equals_jax_package_and_recompute():
    from bibfs_tpu.analytics import results as rres
    from bibfs_tpu.graph.csr import build_csr
    from bibfs_tpu.query.weighted import synthetic_weights

    from bibfs_tpu_torch.analytics import results as pres

    _ref, port = _mods()
    n, edges, rp, ci = _graph(seed=17)
    w = synthetic_weights(rp, ci, 0)
    dist, _ = port.host_sssp(n, rp, ci, w, [3])
    labels, _count, _ = port.host_components(n, rp, ci)
    adds = np.array([[0, 70], [12, 100], [5, 64]], dtype=np.int64)
    new_edges = np.concatenate([edges, adds])
    rp2, ci2 = build_csr(n, new_edges)
    w2 = synthetic_weights(rp2, ci2, 0)
    got = pres.maintain_sssp(dist[:, 0], adds, n, rp2, ci2, w2, 0)
    want = rres.maintain_sssp(dist[:, 0], adds, n, rp2, ci2, w2, 0)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert np.array_equal(got[0], port.host_sssp(n, rp2, ci2, w2, [3])[0][:, 0])
    got = pres.maintain_components(labels, adds, n)
    want = rres.maintain_components(labels, adds, n)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[1] == port.ref_components_unionfind(n, new_edges)[1]


@pytest.mark.parametrize("kind", ["sssp", "pagerank", "components",
                                  "triangles"])
def test_payload_roundtrip_like_jax_package(kind):
    from bibfs_tpu.analytics import queries as rq
    from bibfs_tpu.analytics import results as rres

    from bibfs_tpu_torch.analytics import queries as pq
    from bibfs_tpu_torch.analytics import results as pres

    vec = np.arange(6, dtype=np.float64)
    make = {
        "sssp": lambda m: m.SsspResult(True, vec, 6, 3, 0.25),
        "pagerank": lambda m: m.PageRankResult(True, vec, 9, 1e-9, 0.25),
        "components": lambda m: m.ComponentsResult(
            True, vec.astype(np.int64), 6, 2, 0.25),
        "triangles": lambda m: m.TrianglesResult(True, 11, 0.25),
    }[kind]
    arrays, scalars = pres.result_to_payload(kind, make(pq))
    r_arrays, r_scalars = rres.result_to_payload(kind, make(rq))
    assert scalars == r_scalars and sorted(arrays) == sorted(r_arrays)
    for k in arrays:
        assert np.array_equal(arrays[k], r_arrays[k])
    back = pres.result_from_payload(kind, r_arrays, r_scalars)
    assert type(back).__name__ == type(make(rq)).__name__
    assert pq.analytics_summary(back) == rq.analytics_summary(
        rres.result_from_payload(kind, arrays, scalars))
    with pytest.raises(ValueError, match="unknown analytics kind"):
        pres.result_to_payload("katz", None)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_adopts_the_others_directory(tmp_path, writer):
    """Entries one package persists are found, loaded by mmap and served
    by the other: the directory format is one."""
    from bibfs_tpu.analytics.results import AnalyticsResultStore as Ref

    from bibfs_tpu_torch.analytics.results import AnalyticsResultStore

    cls = {"ref": Ref, "port": AnalyticsResultStore}
    reader = "port" if writer == "ref" else "ref"
    root = str(tmp_path / "analytics")
    st = cls[writer](root, store_label=f"adopt-w-{writer}")
    st.note_register("g", "d0")
    arr = np.arange(6, dtype=np.float64)
    st.put("g", ("sssp", 0, 0), "d0", "sssp", {"dist": arr},
           {"found": True, "reached": 6, "rounds": 2, "time_s": 0.0})
    st.put("g", ("triangles",), "d0", "triangles", {},
           {"found": True, "count": 3, "time_s": 0.0})
    files = sorted(str(p.relative_to(tmp_path))
                   for p in tmp_path.rglob("*") if p.is_file())
    other = cls[reader](root, store_label=f"adopt-r-{reader}")
    got = other.lookup("g", ("sssp", 0, 0), "d0")
    assert got is not None and got[0] == "hit"
    assert isinstance(got[1].arrays["dist"], np.memmap)
    assert np.array_equal(np.asarray(got[1].arrays["dist"]), arr)
    assert other.lookup("g", ("triangles",), "d0")[1].scalars["count"] == 3
    assert other.stats()["events"]["load"] == 2
    # and the same files either way: write the same entries with the
    # reader's package into a second root
    root2 = str(tmp_path / "again")
    st2 = cls[reader](root2, store_label=f"adopt-w2-{reader}")
    st2.note_register("g", "d0")
    st2.put("g", ("sssp", 0, 0), "d0", "sssp", {"dist": arr},
            {"found": True, "reached": 6, "rounds": 2, "time_s": 0.0})
    st2.put("g", ("triangles",), "d0", "triangles", {},
            {"found": True, "count": 3, "time_s": 0.0})
    files2 = sorted(str(p.relative_to(tmp_path / "again"))
                    for p in (tmp_path / "again").rglob("*") if p.is_file())
    assert [f[len("analytics/"):] for f in files] == files2
