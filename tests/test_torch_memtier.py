"""The port's memory tiers (``GraphSnapshot.from_sidecar`` / ``demote`` /
``promote`` / ``native_csr``, the store's residency accountant:
``touch``, ``rebalance``, ``memory_stats``) against ``bibfs_tpu.store``
on the CPU: the same demotion order and ``memory_stats`` under one touch
and rebalance sequence, exact promotion, the tier metrics, the host
route's zero-copy native CSR over a mapped snapshot, the no-unmapped-
reads retirement contract, tables uploaded from a read-only mapping as
private copies, and both engines answering from mapped and cold graphs
exactly as the reference's engines do."""

import os
import warnings

import numpy as np
import pytest

FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")
N = 60
EDGES = np.array([[i, i + 1] for i in range(N - 1)]
                 + [[i, i + 7] for i in range(N - 7)])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _packages():
    import bibfs_tpu.store as ref
    import bibfs_tpu_torch.store as port

    return {"ref": ref, "port": port}


def _fields(r):
    return tuple(getattr(r, f) for f in FIELDS)


def _seed_dir(root, graphs=(("g", N, EDGES),)):
    from bibfs_tpu.graph.io import write_graph_bin

    os.makedirs(root, exist_ok=True)
    for name, n, edges in graphs:
        write_graph_bin(os.path.join(root, f"{name}.bin"), n, edges)
    return str(root)


def _graphs():
    rng = np.random.default_rng(11)
    return [(f"g{i}", 80 + 20 * i, rng.integers(0, 80 + 20 * i,
                                                size=(200 + 60 * i, 2)))
            for i in range(4)]


def _memory(store) -> dict:
    ms = store.memory_stats()
    for g in ms["graphs"].values():
        g.pop("arrays", None)
    return ms


@pytest.mark.parametrize("budget", [1, 9000, 20000, 1 << 30])
def test_demotion_order_and_memory_stats_equal_reference(budget):
    """Four graphs registered under a budget, touched in a seeded order,
    one accessed (promoted), rebalanced: after every step the two
    packages' ``memory_stats`` (tiers, resident and cold bytes,
    promotions, demotions, headroom) and each rebalance's demotions are
    equal."""
    got = {}
    for who, pkg in _packages().items():
        store = pkg.GraphStore(compact_threshold=None,
                               residency_budget=budget)
        steps = []
        for name, n, edges in _graphs():
            store.add(name, n, edges)
            steps.append(_memory(store))
        for name in ("g2", "g0", "g3"):
            store.touch(name)
        snap = store.acquire("g1")
        snap.csr()
        snap.release()
        steps.append(_memory(store))
        out = store.rebalance()
        steps.append((out, _memory(store)))
        store.touch("nope")  # an unknown name is ignored
        store.close()
        got[who] = steps
    assert got["port"] == got["ref"]
    last = got["port"][-1][1]
    assert last["residency_budget"] == budget
    if budget == 1 << 30:
        assert all(g["tier"] == "hot" for g in last["graphs"].values())
    else:
        assert any(g["demotions"] for g in last["graphs"].values())


def test_promote_is_exact_and_counted():
    """A cold snapshot decodes back bit for bit (its digest recomputed from
    the promoted pairs, its CSR the reference's), counted both ways; a
    retired cold snapshot still answers without caching."""
    from bibfs_tpu.graph.csr import build_csr

    from bibfs_tpu_torch.store import GraphSnapshot, content_digest

    n, edges = _graphs()[2][1:]
    snap = GraphSnapshot.build(n, edges)
    digest = snap.digest
    assert snap.promote() is False  # hot already
    freed = snap.demote()
    assert freed > 0 and snap.tier == "cold" and snap.demote() == 0
    m = snap.memory()
    assert m["cold_bytes"] > 0 and m["demotions"] == 1
    rp, ci = snap.csr()  # the access is the promotion
    want = build_csr(n, edges)
    assert np.array_equal(rp, want[0]) and np.array_equal(ci, want[1])
    assert content_digest(n, snap.pairs) == digest
    assert snap.tier == "hot" and snap.memory()["promotions"] == 1
    snap.demote()
    assert snap.promote() is True and snap.tier == "hot"
    snap.demote()
    assert snap.release() is True
    assert content_digest(n, snap.pairs) == digest
    assert snap.tier == "cold"  # answered, not cached after retirement


def test_memtier_metrics_render_and_track_remap(tmp_path):
    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.store import GraphStore

    store = GraphStore(compact_threshold=None, obs_label="t-mem0")
    r = REGISTRY.render()
    for tier in ("mapped", "hot", "cold"):
        assert f'bibfs_store_tier{{store="t-mem0",tier="{tier}"}} 0' in r
    store.add("g", 10, np.array([[0, 1], [1, 2]]))
    r = REGISTRY.render()
    assert 'bibfs_store_mmap_bytes{store="t-mem0",graph="g"} 0' in r
    assert 'bibfs_store_remap_total{store="t-mem0",graph="g"} 0' in r
    assert 'bibfs_store_tier{store="t-mem0",tier="hot"} 1' in r
    store.close()
    d = _seed_dir(tmp_path)
    GraphStore.from_dir(d, durable=True, compact_threshold=None).close()
    store = GraphStore.from_dir(d, durable=True, compact_threshold=None,
                                obs_label="t-mem1", residency_budget=0)
    r = REGISTRY.render()
    assert 'bibfs_store_remap_total{store="t-mem1",graph="g"} 1' in r
    assert 'bibfs_store_tier{store="t-mem1",tier="mapped"} 1' in r
    ms = store.memory_stats()
    g = ms["graphs"]["g"]
    assert g["tier"] == "mapped" and g["resident_bytes"] == 0
    assert g["demotions"] == 0  # a mapped graph is never demoted
    assert (f'bibfs_store_mmap_bytes{{store="t-mem1",graph="g"}} '
            f'{g["mapped_bytes"]}') in r
    assert ms["headroom_bytes"] == 0 and ms["mmap_arrays"] is True
    store.close()
    with pytest.raises(ValueError, match="residency_budget"):
        GraphStore(residency_budget=-1)


def test_mapped_snapshot_memory_equal_reference(tmp_path):
    """A graph recovered by mapping its sidecar: the same tier, mapped and
    resident bytes in both packages."""
    got = {}
    for who, pkg in _packages().items():
        d = _seed_dir(tmp_path / who)
        pkg.GraphStore.from_dir(d, durable=True, compact_threshold=None).close()
        store = pkg.GraphStore.from_dir(d, durable=True,
                                        compact_threshold=None)
        got[who] = store.memory_stats()
        store.close()
    assert got["port"] == got["ref"]
    assert got["port"]["graphs"]["g"]["mapped_bytes"] > 0


def test_host_route_is_zero_copy_on_a_mapped_snapshot(tmp_path):
    """A runtime over a mapped snapshot hands the native solver the
    sidecar's int32 columns themselves (the mapping, no copy), answers
    equal the reference's serial solver, and serving leaves the snapshot
    with no resident bytes."""
    from bibfs_tpu.solvers.serial import solve_serial

    from bibfs_tpu_torch.serve.engine import _GraphRuntime
    from bibfs_tpu_torch.store import GraphStore

    d = _seed_dir(tmp_path)
    GraphStore.from_dir(d, durable=True, compact_threshold=None).close()
    store = GraphStore.from_dir(d, durable=True, compact_threshold=None)
    snap = store.acquire("g")
    try:
        assert snap.tier == "mapped"
        rt = _GraphRuntime(snap, layout="ell", device="cpu")
        solver = rt.get_host_solver()
        if rt.host_backend_resolved != "native":
            pytest.skip("the native runtime does not build here")
        assert isinstance(rt.host_native_graph.col_ind, np.memmap)
        for s, t in ((0, N - 1), (3, 40), (7, 7)):
            assert solver(s, t).hops == solve_serial(N, EDGES, s, t).hops
        assert snap.resident_bytes() == 0
    finally:
        snap.release()
        store.close()


def test_mapped_snapshot_survives_retirement_reads(tmp_path):
    """A pinned mapped snapshot keeps serving the same bytes after the
    store swaps it out and retires it: release drops references, never
    unmaps."""
    from bibfs_tpu_torch.store import GraphStore

    d = _seed_dir(tmp_path)
    GraphStore.from_dir(d, durable=True, compact_threshold=None).close()
    store = GraphStore.from_dir(d, durable=True, compact_threshold=None)
    snap = store.acquire("g")
    assert snap.tier == "mapped"
    before = snap.pairs.copy()
    store.update("g", adds=[(0, 45)])
    store.compact("g")
    assert np.array_equal(snap.pairs, before)
    assert snap.csr()[0][-1] == before.shape[0]
    assert snap.release() is True
    assert np.array_equal(snap.pairs, before)
    store.close()


def test_tables_from_a_readonly_mapping_upload_as_private_copies(tmp_path):
    """The ELL, tile and CSR tables of a mapped snapshot are read-only
    mappings; the device graph, the tile graph and the sweep's CSR take
    private writable copies, with no warning, equal to a hot snapshot's."""
    import torch

    from bibfs_tpu_torch.graph.generate import grid_graph
    from bibfs_tpu_torch.ops import msbfs_device as md
    from bibfs_tpu_torch.solvers.dense import BlockedDeviceGraph, DeviceGraph
    from bibfs_tpu_torch.store import GraphSnapshot, load_sidecar, write_sidecar

    n = 20 * 18
    hot = GraphSnapshot.build(n, grid_graph(20, 18, perforation=0.05, seed=2))
    hot.ell()
    hot.blocked()
    d = write_sidecar(str(tmp_path), "g", hot)
    mapped = GraphSnapshot.from_sidecar(load_sidecar(tmp_path / d))
    assert isinstance(mapped.ell().nbr, np.memmap)
    assert not mapped.ell().nbr.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g = DeviceGraph.from_ell(mapped.ell(), device="cpu")
        bg = BlockedDeviceGraph.from_host(mapped.blocked(), device="cpu")
        rp, ci = md.upload_csr(*mapped.csr(), device="cpu")
    want = DeviceGraph.from_ell(hot.ell(), device="cpu")
    assert torch.equal(g.nbr, want.nbr) and torch.equal(g.deg, want.deg)
    g.nbr[0, 0] += 1  # private: the mapping is untouched
    assert torch.equal(bg.tab, torch.from_numpy(np.array(hot.blocked().tab)))
    assert torch.equal(rp, torch.from_numpy(hot.csr()[0]))
    assert torch.equal(ci.long(), torch.from_numpy(hot.csr()[1]))
    assert np.array_equal(mapped.ell().nbr, hot.ell().nbr)


def _engine_pair(kind, ref_store, port_store):
    from bibfs_tpu.serve.engine import QueryEngine as JQ
    from bibfs_tpu.serve.pipeline import PipelinedQueryEngine as JP

    from bibfs_tpu_torch.serve import PipelinedQueryEngine as TP
    from bibfs_tpu_torch.serve import QueryEngine as TQ

    kw = dict(device_batches=True, flush_threshold=4)
    if kind == "pipelined":
        kw.update(max_wait_ms=None, flush_threshold=4096)
        return JP(store=ref_store, **kw), TP(store=port_store, device="cpu",
                                              **kw)
    return JQ(store=ref_store, **kw), TQ(store=port_store, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["sync", "pipelined"])
def test_engines_serve_mapped_and_cold_graphs_like_reference(tmp_path, kind):
    """Both packages recover one durable directory (one graph mapped from
    its sidecar, one rebuilt hot and then demoted past the budget) and
    serve the same seeded pairs on each graph: every answer, every counter
    and the tiers afterwards are equal; the cold graph came back hot by a
    counted promote."""
    from bibfs_tpu_torch.graph.generate import grid_graph

    n = 24 * 20
    graphs = (("grid", n, grid_graph(24, 20, perforation=0.05, seed=3)),
              ("line", N, EDGES))
    d = _seed_dir(tmp_path / "w", graphs)
    pk = _packages()
    pk["port"].GraphStore.from_dir(d, durable=True,
                                   compact_threshold=None).close()
    stores, got = {}, {}
    for who, pkg in pk.items():
        import shutil

        copy = str(shutil.copytree(d, tmp_path / who))
        store = pkg.GraphStore.from_dir(copy, durable=True,
                                        compact_threshold=None)
        store.update("line", adds=[(0, N - 1)])
        store.compact("line")  # line: a hot snapshot
        store.residency_budget = 0
        store.rebalance()
        stores[who] = store
    for who, store in stores.items():
        ms = store.memory_stats()["graphs"]
        assert (ms["grid"]["tier"], ms["line"]["tier"]) == ("mapped", "cold")
    engines = _engine_pair(kind, stores["ref"], stores["port"])
    rng = np.random.default_rng(5)
    try:
        for graph, size in (("grid", n), ("line", N)):
            qp = rng.integers(0, size, size=(24, 2))
            res = [eng.query_many(qp, graph=graph) for eng in engines]
            assert [_fields(r) for r in res[1]] == [_fields(r) for r in res[0]]
        for name in ("queries", "device_queries", "host_queries",
                     "cache_served", "device_batches"):
            assert engines[1].counters[name] == engines[0].counters[name], name
        for who, store in stores.items():
            got[who] = {k: (g["tier"], g["promotions"], g["demotions"])
                        for k, g in store.memory_stats()["graphs"].items()}
    finally:
        for eng in engines:
            eng.close()
        for store in stores.values():
            store.close()
    assert got["port"] == got["ref"]
    assert got["port"]["line"] == ("hot", 1, 1)
    assert got["port"]["grid"][0] == "mapped"
