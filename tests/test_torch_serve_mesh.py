"""The port's mesh route (``serve/routes/mesh.py`` over a
``parallel/pool.py`` rank pool; the engines' ``mesh=``) against the JAX
package's on the CPU: the cases of ``tests/test_serve_mesh.py`` at 2 and
4 gloo ranks (the reference on its virtual CPU mesh of as many devices).
Both sub-paths (the vertex-sharded batch and the data-parallel batch) on
random and grid graphs, a hot swap under traffic on both engines, the
exchange accounting, the families at zero, the shards gauge and the
calibrated crossovers. Every mesh-served answer equals the reference
mesh engine's (found, hops, path) and the port's single-device engine's
(found, hops, path), and the routing counters equal the reference's. One
pool per world size serves the module (``MeshConfig(pool=...)``); the
gauge case starts and closes an engine's own pool."""

import multiprocessing

import numpy as np
import pytest

from bibfs_tpu.obs.names import MESH_METRIC_FAMILIES

WORLDS = (2, 4)
FIELDS = ("found", "hops", "path")


@pytest.fixture(scope="module")
def pools():
    import torch

    from bibfs_tpu_torch.parallel.pool import MeshPool

    torch.set_num_threads(2)
    made = {w: MeshPool(w, "cpu", timeout_s=300) for w in WORLDS}
    yield made
    for p in made.values():
        p.close()


def _gnp(n, seed=11):
    from bibfs_tpu.graph.generate import gnp_random_graph

    return gnp_random_graph(n, 2.2 / n, seed=seed)


def _grid(w, h, seed=1):
    from bibfs_tpu.graph.generate import grid_graph

    return grid_graph(w, h, perforation=0.05, seed=seed)


def _pairs(n, count, seed=0):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, n, size=(3 * count, 2)), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]  # trivial pairs resolve inline
    rng.shuffle(pairs)
    assert pairs.shape[0] >= count
    return [(int(s), int(d)) for s, d in pairs[:count]]


def _fields(r):
    return tuple(getattr(r, f) for f in FIELDS)


def _port(n, edges, world, pools, **cfg):
    from bibfs_tpu_torch.serve import QueryEngine
    from bibfs_tpu_torch.serve.routes import MeshConfig

    return QueryEngine(n, edges, mesh=MeshConfig(pool=pools[world], **cfg),
                       flush_threshold=4, device="cpu")


def _ref(n, edges, world, **cfg):
    from bibfs_tpu.serve.engine import QueryEngine
    from bibfs_tpu.serve.routes import MeshConfig

    return QueryEngine(n, edges, mesh=MeshConfig(devices=world, **cfg),
                       flush_threshold=4)


def _single(n, edges, pairs):
    """The port's single-device engine (its device route forced on the
    CPU)."""
    from bibfs_tpu_torch.serve import QueryEngine

    eng = QueryEngine(n, edges, device="cpu", device_batches=True,
                      flush_threshold=4)
    try:
        return eng.query_many(pairs)
    finally:
        eng.close()


def _check(n, edges, pairs, got, want, single=True):
    from bibfs_tpu.solvers.serial import solve_serial

    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    if single:
        assert [_fields(r) for r in got] == [
            _fields(r) for r in _single(n, edges, pairs)]
    for (s, d), res in zip(pairs, got):
        ref = solve_serial(n, edges, s, d)
        assert (res.found, res.hops) == (ref.found, ref.hops), (s, d)


def _routing(st) -> dict:
    mesh = st["routes"]["mesh"]
    return dict(mesh_queries=st["mesh_queries"], batches=mesh["batches"],
                reroutes=mesh["crossover_reroutes"], shards=mesh["shards"])


def _same_run(n, edges, pairs, world, pools, **cfg):
    """Both packages' mesh engines on the same pairs: answers and routing
    counters equal; returns the port engine's stats."""
    port, ref = _port(n, edges, world, pools, **cfg), _ref(n, edges, world,
                                                           **cfg)
    try:
        got, want = port.query_many(pairs), ref.query_many(pairs)
        _check(n, edges, pairs, got, want)
        st = port.stats()
        assert _routing(st) == _routing(ref.stats())
        return st
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_sharded_exact_on_random_graph(world, pools):
    n = 500
    edges = _gnp(n)
    pairs = _pairs(n, 24)
    st = _same_run(n, edges, pairs, world, pools, shard_min_n=0)
    assert st["mesh_queries"] == len(pairs)
    assert st["routes"]["mesh"]["batches"]["sharded"] >= 1


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_sharded_exact_on_grid_graph(world, pools):
    w = h = 16
    n = w * h
    edges = _grid(w, h)
    pairs = _pairs(n, 20, seed=2)
    st = _same_run(n, edges, pairs, world, pools, shard_min_n=0,
                   mode="fused")
    assert st["mesh_queries"] == len(pairs)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_dp_exact_and_counted(world, pools):
    n = 500
    edges = _gnp(n)
    pairs = _pairs(n, 24, seed=3)
    st = _same_run(n, edges, pairs, world, pools, dp_min_batch=8, dp_min_n=0)
    assert st["mesh_queries"] == len(pairs)
    assert st["routes"]["mesh"]["batches"]["dp"] >= 1
    # the dp path is collective-free: no exchange bytes accounted
    assert st["routes"]["mesh"]["exchange_bytes"]["packed"] == 0


def test_mesh_scale_graph_never_takes_dp(pools):
    """A graph at or above shard_min_n takes the vertex-sharded path even
    when the batch clears the dp crossover."""
    n = 500
    edges = _gnp(n, seed=12)
    pairs = _pairs(n, 16, seed=8)
    st = _same_run(n, edges, pairs, 2, pools, shard_min_n=0, dp_min_batch=8,
                   dp_min_n=0)
    batches = st["routes"]["mesh"]["batches"]
    assert batches["sharded"] >= 1
    assert batches["dp"] == 0


def _store_engines(n, edges, pools, pipelined):
    from bibfs_tpu.serve.engine import QueryEngine as RefEngine
    from bibfs_tpu.serve.pipeline import PipelinedQueryEngine as RefPipe
    from bibfs_tpu.serve.routes import MeshConfig as RefConfig
    from bibfs_tpu.store import GraphStore as RefStore

    from bibfs_tpu_torch.serve import PipelinedQueryEngine, QueryEngine
    from bibfs_tpu_torch.serve.routes import MeshConfig
    from bibfs_tpu_torch.store import GraphStore

    store, rstore = GraphStore(compact_threshold=None), RefStore(
        compact_threshold=None)
    store.add("g", n, edges)
    rstore.add("g", n, edges)
    cls, rcls = ((PipelinedQueryEngine, RefPipe) if pipelined
                 else (QueryEngine, RefEngine))
    port = cls(store=store, graph="g", device="cpu", flush_threshold=4,
               mesh=MeshConfig(pool=pools[2], shard_min_n=0))
    ref = rcls(store=rstore, graph="g", flush_threshold=4,
               mesh=RefConfig(devices=2, shard_min_n=0))
    return store, rstore, port, ref


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_mesh_hot_swap_mid_traffic_exact(pipelined, pools):
    """A mesh-served store graph hot-swaps under traffic (a live update
    and a forced compaction): every post-swap answer is exact on the new
    edge set and equals the reference's, the new snapshot is shipped to
    the ranks anew (a second sharded batch, a second graph) and the old
    one is released when it retires."""
    n = 400
    edges = _gnp(n, seed=5 + pipelined)
    store, rstore, port, ref = _store_engines(n, edges, pools, pipelined)
    try:
        pairs = _pairs(n, 16, seed=4)
        pre = store.current("g").digest
        _check(n, edges, pairs, port.query_many(pairs), ref.query_many(pairs),
               single=False)
        rt_old = port._graph_rt("g")
        adds = [[0, n - 1], [5, n - 7]]
        for s in (store, rstore):
            s.update("g", adds=adds)
            s.compact("g")
        edges2 = np.vstack([edges, adds])
        assert store.current("g").digest != pre
        assert store.current("g").digest == rstore.current("g").digest
        _check(n, edges2, pairs, port.query_many(pairs),
               ref.query_many(pairs), single=False)
        st = port.stats()
        assert st["mesh_queries"] == 2 * len(pairs)
        assert st["routes"]["mesh"]["batches"]["sharded"] >= 2
        assert _routing(st) == _routing(ref.stats())
        rt_new = port._graph_rt("g")
        assert rt_new is not rt_old
        old_keys = {v[1] for v in rt_old.mesh_shipped.values()}
        new_keys = {v[1] for v in rt_new.mesh_shipped.values()}
        assert old_keys and new_keys and not old_keys & new_keys
        assert rt_old.snapshot.retired  # and its graph released on the ranks
    finally:
        port.close()
        ref.close()


def test_mesh_exchange_bytes_packed_vs_bool(pools):
    """The sharded sub-path's accounting: each query's levels, a packed
    plane a rank, exactly; the bool counterfactual at least 4x larger (8x
    at whole words)."""
    from bibfs_tpu_torch.parallel.collectives import frontier_exchange_bytes
    from bibfs_tpu_torch.serve.buckets import repad_rows

    n = 500
    edges = _gnp(n, seed=7)
    eng = _port(n, edges, 4, pools, shard_min_n=0)
    try:
        res = eng.query_many(_pairs(n, 16, seed=6))
        exch = eng.stats()["routes"]["mesh"]["exchange_bytes"]
        n_loc = repad_rows(eng._current_rt().snapshot.ell(), 4).n_pad // 4
        planes = sum(r.levels for r in res) * 4
        assert exch["packed"] == planes * frontier_exchange_bytes(n_loc) > 0
        assert exch["bool"] == planes * n_loc
        assert exch["bool"] >= 4 * exch["packed"]
    finally:
        eng.close()


def test_mesh_metric_families_render_at_zero(pools):
    """Every ``bibfs_mesh_*`` family of the reference renders from
    construction alone."""
    from bibfs_tpu_torch.obs.metrics import REGISTRY

    n = 300
    eng = _port(n, _gnp(n, seed=8), 2, pools, shard_min_n=0)
    try:
        render = REGISTRY.render()
        for fam in MESH_METRIC_FAMILIES:
            assert fam in render, fam
    finally:
        eng.close()


def test_mesh_shards_gauge():
    """``mesh=N`` starts the engine's own pool of N ranks (the gauge reads
    N, the fallback and retry cells of the mesh rung are minted) and
    ``close()`` ends it, leaving no child process."""
    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.serve import QueryEngine

    n = 300
    eng = QueryEngine(n, _gnp(n, seed=9), mesh=2, device="cpu")
    pool = eng.routes["mesh"].pool
    pids = pool.pids()
    try:
        gauge = REGISTRY.get("bibfs_mesh_shards").labels(engine=eng.obs_label)
        assert gauge.value == 2
        assert pool.up and len(pool.pids()) == 2
        res = eng.stats()["resilience"]
        assert {"mesh->device", "mesh->host"} <= set(res["fallbacks"])
    finally:
        eng.close()
    assert not pool.up
    live = {p.pid for p in multiprocessing.active_children()}
    assert not live & set(pids)


def test_mesh_crossover_defaults_from_calibration(pools):
    """With no overrides the route takes the calibrated constants or the
    defaults: the CPU block was measured on 8 devices, so a mesh of 2
    takes the defaults, as the reference's does; below-crossover traffic
    goes to the single-device rungs, counted as reroutes."""
    n = 300
    edges = _gnp(n, seed=10)
    port, ref = _port(n, edges, 2, pools), _ref(n, edges, 2)
    try:
        cross = port.routes["mesh"].stats()["crossover"]
        assert cross == ref.routes["mesh"].stats()["crossover"]
        assert cross["dp_min_batch"] >= 8
        assert cross["dp_min_n"] > n
        pairs = _pairs(n, 12, seed=7)
        _check(n, edges, pairs, port.query_many(pairs), ref.query_many(pairs),
               single=False)
        st = port.stats()
        assert st["mesh_queries"] == 0
        assert st["routes"]["mesh"]["crossover_reroutes"] >= 1
        assert _routing(st) == _routing(ref.stats())
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_serve_cli_mesh(pipeline, tmp_path, capsys):
    """``bibfs-torch-serve --mesh 2 --mesh-shard-min-n 0`` serves a pairs
    file through the mesh rung (the summary counts every query as mesh)
    and prints the lines ``bibfs-serve --mesh`` prints; malformed mesh
    flags exit 2 before any rank starts."""
    from bibfs_tpu.serve.cli import main as ref_main

    from bibfs_tpu_torch.graph.io import write_graph_bin
    from bibfs_tpu_torch.serve.cli import main

    n = 400
    edges = _gnp(n, seed=13)
    gpath = str(tmp_path / "g.bin")
    write_graph_bin(gpath, n, edges)
    pairs = _pairs(n, 12, seed=9)
    ppath = str(tmp_path / "p.txt")
    np.savetxt(ppath, np.array(pairs), fmt="%d")
    extra = ["--pipeline"] if pipeline else []
    argv = [gpath, "--pairs", ppath, "--mesh", "2", "--mesh-shard-min-n",
            "0", "--threshold", "4", *extra]
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert ref_main(argv) == 0
    want = capsys.readouterr()
    assert got.out == want.out
    assert f"{len(pairs)} queries: {len(pairs)} mesh" in got.err
    for bad in (["--mesh", "0"], ["--mesh", "banana"],
                ["--mesh-shard-min-n", "5"]):
        with pytest.raises(SystemExit):
            main([gpath, "--pairs", ppath, "--device", "cpu", *bad])
