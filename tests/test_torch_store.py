"""The port's graph store (``bibfs_tpu_torch.store``) against
``bibfs_tpu.store`` on the CPU, exactly: snapshot digests and the
store-relative versions; the delta overlay's ``apply`` (accepted and
refused batches) and exact ``solve`` on seeded graphs with adds, deletes
and disconnection; one update / compaction / swap sequence (a rebase of
updates that race a compaction, an external swap that races one) run on
both packages, ending at equal digests, versions and stats; the oracle's
index lifecycle in the store; the metric families; the durable and
memory-tier options, each accepted or refused as the reference does
(their behaviour is held to the reference in ``test_torch_durable.py``
and ``test_torch_memtier.py``)."""

import os

import numpy as np
import pytest

FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _gnp(n=90, deg=3.0, seed=1):
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    return n, gnp_random_graph(n, deg / n, seed=seed)


def _packages():
    import bibfs_tpu.store as ref
    import bibfs_tpu_torch.store as port

    return ref, port


def _fields(r):
    return tuple(getattr(r, f) for f in FIELDS)


def _edge_set(arr) -> set:
    return {(int(u), int(v)) for u, v in np.asarray(arr).tolist()}


def _live_edges(store, name) -> set:
    ov = store.overlay(name)
    snap = store.current(name)
    return _edge_set(ov.merged_edges() if ov is not None
                     else snap.undirected_edges())


def _store_stats(st: dict) -> dict:
    """A store's stats without the keys only one package has (the
    reference's analytics block, the port's device)."""
    out = {k: v for k, v in st.items() if k not in ("analytics", "device")}
    graphs = {}
    for name, g in st["graphs"].items():
        g = dict(g)
        if g.get("oracle"):
            g["oracle"] = {k: v for k, v in g["oracle"].items()
                           if k not in ("index", "last_error")}
        graphs[name] = g
    out["graphs"] = graphs
    return out


def test_snapshot_digest_and_store_versions():
    ref, port = _packages()
    n, edges = _gnp()
    shuffled = edges[np.random.default_rng(0).permutation(len(edges))][:, ::-1]
    a, b = ref.GraphSnapshot.build(n, edges), port.GraphSnapshot.build(
        n, shuffled)
    assert a.digest == b.digest
    assert b.stats()["tier"] == "hot" and b.mapped_bytes() == 0
    vs = []
    for pkg in (ref, port):
        store = pkg.GraphStore(compact_threshold=None)
        store.add("g", n, edges)
        store.add("h", n, shuffled)
        store.update("g", adds=[(0, n - 1)] if (0, n - 1) not in
                     _edge_set(edges) else [], dels=[tuple(edges[0])])
        new = store.compact("g")
        vs.append((store.current("g").version, store.current("h").version,
                   new.digest, store.default_graph(), store.names()))
    assert vs[0] == vs[1]
    assert vs[1][:2] == (2, 1)


def _rand_batch(rng, n, live: set, k_add: int, k_del: int):
    adds, dels = [], []
    while len(adds) < k_add:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        e = (min(u, v), max(u, v))
        if u != v and e not in live and e not in adds:
            adds.append(e)
    pool = sorted(live)
    for i in rng.choice(len(pool), size=min(k_del, len(pool)), replace=False):
        dels.append(pool[int(i)])
    return adds, dels


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_overlay_apply_and_solve_equal_reference(seed):
    ref, port = _packages()
    n, edges = _gnp(seed=seed)
    r_ov = ref.DeltaOverlay(ref.GraphSnapshot.build(n, edges))
    p_ov = port.DeltaOverlay(port.GraphSnapshot.build(n, edges))
    rng = np.random.default_rng(seed)
    live = _edge_set(r_ov.base.undirected_edges())
    for step in range(5):
        adds, dels = _rand_batch(rng, n, live, 4, 3)
        if step >= 3:  # cut vertex 0 off: every edge of it deleted
            dels = sorted(set(dels) | {e for e in live if 0 in e})
            adds = [e for e in adds if 0 not in e]
        assert p_ov.apply(adds, dels) == r_ov.apply(adds, dels)
        live = (live - set(dels)) | set(adds)
        assert _edge_set(p_ov.merged_edges()) == live
        assert p_ov.capture() == r_ov.capture()
        assert p_ov.stats() == r_ov.stats()
        corr_r, corr_p = r_ov.correction(), p_ov.correction()
        for s, d in rng.integers(0, n, size=(25, 2)):
            a = r_ov.solve(int(s), int(d), correction=corr_r)
            b = p_ov.solve(int(s), int(d), correction=corr_p)
            assert _fields(b) == _fields(a), (step, s, d)
        if step >= 3:
            assert not p_ov.solve(0, 1 + seed).found
    # refused batches leave both overlays exactly as they were
    bad = [([tuple(sorted(live))[0]], []), ([], [(n - 2, n - 1)]
           if (n - 2, n - 1) not in live else [(0, 1)]),
           ([(3, 3)], []), ([(0, n)], [])]
    for adds, dels in bad:
        for ov in (r_ov, p_ov):
            with pytest.raises(ValueError):
                ov.apply(adds, dels)
    assert p_ov.capture() == r_ov.capture()
    assert p_ov.apply([], [], commit=False) == r_ov.apply([], [], commit=False)
    # the compaction build: the same digest
    assert p_ov.snapshot()[0].digest == r_ov.snapshot()[0].digest
    a_r, d_r = r_ov.capture()
    assert p_ov.rebase(a_r, d_r) == r_ov.rebase(a_r, d_r) == (set(), set())


def _store_sequence(pkg, n, edges, twin):
    """One update / compaction / swap sequence: returns what is compared."""
    store = pkg.GraphStore(compact_threshold=None)
    store.add("social", n, edges)
    store.add("twin", n, twin)
    out = []
    rng = np.random.default_rng(11)
    live = _live_edges(store, "social")
    adds, dels = _rand_batch(rng, n, live, 5, 3)
    out.append(store.update("social", adds=adds, dels=dels))
    out.append(_store_stats(store.stats()))
    new = store.compact("social")
    out.append((new.version, new.digest, store.overlay("social")))
    # a rebase: an update lands while the compaction builds
    live = _live_edges(store, "social")
    adds, dels = _rand_batch(rng, n, live, 3, 2)
    store.update("social", adds=adds, dels=dels)
    ov = store.overlay("social")
    racer = _rand_batch(rng, n, _live_edges(store, "social"), 1, 1)
    orig = ov.snapshot

    def build_with_update(a=None, d=None):
        built = orig(a, d)
        store.update("social", adds=racer[0], dels=[adds[0]] + racer[1])
        return built

    ov.snapshot = build_with_update
    new = store.compact("social")
    out.append((new.version, new.digest, store.overlay("social").stats(),
                sorted(_live_edges(store, "social"))))
    # an external swap lands while a compaction builds: the swap wins
    ov2 = store.overlay("social")
    orig2 = ov2.snapshot
    declared = pkg.GraphSnapshot.build(n, twin, version=10)

    def build_with_swap(a=None, d=None):
        built = orig2(a, d)
        store.swap("social", declared)
        return built

    ov2.snapshot = build_with_swap
    kept = store.compact("social")
    out.append((kept.version, kept.digest, store.overlay("social")))
    with pytest.raises(ValueError, match="forward"):
        store.swap("social", pkg.GraphSnapshot.build(n, edges, version=3))
    rolled = store.roll("twin", adds=[racer[0][0]])
    out.append((rolled.version, rolled.digest, store.roll("twin").version))
    out.append(_store_stats(store.stats()))
    store.close()
    return out


def test_store_sequence_equals_reference():
    ref, port = _packages()
    n, edges = _gnp(120, 3.0, seed=5)
    perm = np.random.default_rng(6).permutation(n)
    twin = perm[edges]  # the same graph, vertices relabelled
    got = _store_sequence(port, n, edges, twin)
    want = _store_sequence(ref, n, edges, twin)
    assert got == want
    assert got[-1]["graphs"]["social"]["version"] == 10
    assert got[-1]["graphs"]["social"]["swaps"] == 3


def test_background_compaction_keeps_the_live_graph():
    """Crossing the threshold compacts on a background thread while
    updates keep arriving; after ``close()`` the live edge set (snapshot
    plus any rebased overlay) equals the reference's, and every pending
    delta was rebased, none lost."""
    ref, port = _packages()
    n, edges = _gnp(150, 3.0, seed=9)
    lives = []
    for pkg in (ref, port):
        store = pkg.GraphStore(compact_threshold=4)
        store.add("g", n, edges)
        rng = np.random.default_rng(12)
        for _ in range(6):
            adds, dels = _rand_batch(rng, n, _live_edges(store, "g"), 2, 1)
            store.update("g", adds=adds, dels=dels)
        store.close()
        st = store.stats()["graphs"]["g"]
        assert st["compactions"] >= 1 and st["compact_failures"] == 0
        assert not st["compacting"]
        lives.append(_live_edges(store, "g"))
    assert lives[0] == lives[1]


def test_store_oracle_lifecycle_equals_reference():
    """Index builds, an adds-only repair, a delete's invalidation and the
    rebuild after compaction: the same index arrays and counts."""
    ref, port = _packages()
    n, edges = _gnp(140, 2.5, seed=4)
    seen = []
    for pkg, kw in ((ref, {}), (port, {"device": "cpu"})):
        store = pkg.GraphStore(compact_threshold=None, oracle_k=8, **kw)
        store.add("g", n, edges)
        assert store.wait_for_index("g", timeout=60)
        rec = [store.oracle("g").index.dist.copy()]
        live = _live_edges(store, "g")
        adds, _ = _rand_batch(np.random.default_rng(3), n, live, 3, 0)
        store.update("g", adds=adds)
        orc = store.oracle("g")  # repaired synchronously
        rec.append((orc.index.dist.copy(), orc.index.gen,
                    orc.index.repaired_edges))
        store.update("g", dels=[sorted(live)[0]])
        rec.append(store.oracle("g"))  # a delete invalidates
        store.compact("g")
        assert store.wait_for_index("g", timeout=60)
        rec.append(store.oracle("g").index.dist.copy())
        store.close()
        rec.append(_store_stats(store.stats()))
        seen.append(rec)
    want, got = seen
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][0], want[1][0])
    assert got[1][1:] == want[1][1:]
    assert got[2] is None and want[2] is None
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4]
    assert got[4]["graphs"]["g"]["oracle"]["repairs"] == 1


def test_failed_index_build_is_counted_and_raised(monkeypatch):
    """No host sweep stands in for a failed device build: it is counted in
    ``stats()`` and ``wait_for_index`` raises it."""
    import bibfs_tpu_torch.oracle as oracle_pkg
    from bibfs_tpu_torch.store import GraphStore

    def broken(*a, **k):
        raise RuntimeError("msbfs kernel refused")

    monkeypatch.setattr(oracle_pkg, "build_index", broken)
    n, edges = _gnp(40)
    store = GraphStore(oracle_k=4, device="cpu")
    store.add("g", n, edges)
    with pytest.raises(RuntimeError, match="msbfs kernel refused"):
        store.wait_for_index("g", timeout=30)
    st = store.stats()["graphs"]["g"]["oracle"]
    assert st["failures"] >= 1 and not st["ready"]
    assert "refused" in st["last_error"]
    assert store.oracle("g") is None
    store.close()


def test_from_dir_equals_reference(tmp_path):
    from bibfs_tpu.graph.io import write_graph_bin

    ref, port = _packages()
    n, edges = _gnp(60)
    write_graph_bin(tmp_path / "b.bin", n, edges)
    write_graph_bin(tmp_path / "a.bin", n, edges[: len(edges) // 2])
    # a checkpoint-named file is no seed graph; a torn file is skipped
    write_graph_bin(tmp_path / "a.v2.0123456789ab.bin", n, edges)
    (tmp_path / "torn.bin").write_bytes(b"\x01\x00")
    stores = [pkg.GraphStore.from_dir(tmp_path) for pkg in (ref, port)]
    assert stores[1].names() == stores[0].names() == ["a", "b"]
    assert [e["graph"] for e in stores[1].load_errors] == \
        [e["graph"] for e in stores[0].load_errors] == ["torn"]
    for name in ("a", "b"):
        assert stores[1].current(name).digest == stores[0].current(name).digest
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError):
        port.GraphStore.from_dir(tmp_path / "empty")


def test_store_metric_families_render():
    from bibfs_tpu.obs.names import STORE_METRIC_FAMILIES

    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.store import GraphStore

    n, edges = _gnp(30)
    store = GraphStore(obs_label="families")
    store.add("g", n, edges)
    render = REGISTRY.render()
    for fam in STORE_METRIC_FAMILIES:
        assert fam in render, fam
    assert 'bibfs_store_tier{store="families",tier="hot"} 1' in render


@pytest.mark.parametrize("kwargs", [
    {"wal_dir": "."}, {"fsync": "always"}, {"residency_budget": 1 << 20},
    {"mmap_arrays": True}, {"retain_history": True},
])
def test_durable_options_name_the_durability_slice(kwargs, tmp_path):
    """Each durable or memory-tier option, once refused naming the
    durability slice, now constructs (or refuses) exactly as the
    reference's does, with the same ``stats()`` flags, the same
    ``memory_stats()`` and the same ``history`` / ``reconstruct_version``
    answers on a store; ``from_dir(durable=True)`` recovers; ``analytics``
    still waits for item 9."""
    ref, port = _packages()
    n, edges = _gnp(20)
    got = {}
    for pkg in (ref, port):
        if "wal_dir" in kwargs:
            kwargs = {"wal_dir": str(tmp_path / pkg.__name__)}
            os.makedirs(kwargs["wal_dir"])
        try:
            store = pkg.GraphStore(compact_threshold=None, **kwargs)
        except ValueError as e:
            got[pkg] = ("refused", str(e))
            continue
        name = "g"
        store.add(name, n, edges)
        st = store.stats()
        ms = store.memory_stats()
        for g in ms["graphs"].values():
            g.pop("arrays")
        cur = store.reconstruct_version(name, 1)
        with pytest.raises(ValueError):
            store.reconstruct_version(name, 2)
        got[pkg] = (st["durable"], st["retain_history"], st["fsync"],
                    ms, store.history(name), cur.digest)
        store.close()
    assert got[port] == got[ref]
    if "retain_history" in kwargs:
        assert got[port][0] == "refused" and "wal_dir" in got[port][1]
        store = port.GraphStore(retain_history=True, wal_dir=str(tmp_path))
        store.add("g", n, edges)
        assert [e["version"] for e in store.history("g")] == [1]
        store.close()
    elif "wal_dir" in kwargs:
        assert got[port][0] is True
        again = port.GraphStore.from_dir(kwargs["wal_dir"], durable=True)
        assert again.current("g").digest == got[port][5]
        assert again.stats()["graphs"]["g"]["durable"]["recovered"] is not None
        again.close()
    store = port.GraphStore()
    with pytest.raises(NotImplementedError, match="item 9"):
        store.analytics  # noqa: B018
