"""The port's 2D block-partitioned search (``solvers/sharded2d.py`` on a
``make_2d_mesh`` grid of gloo ranks, run by a ``parallel/pool.py`` pool)
against the JAX package's on its virtual CPU mesh: the cases of
``tests/test_sharded2d.py`` at 1x2, 2x1 and 2x2. The raw outputs
``(best, meet, par_s, par_t, levels, edges)`` equal the reference
program's exactly (integers: no tolerance) on random, grid, RMAT and hub
graphs in ``sync`` and ``alt``; the block tables (``bnbr``, ``bcnt``,
``deg`` and the hub tiers) equal the reference's ``Sharded2DGraph``
arrays; ``frontier_exchange_bytes_2d`` equals the reference's; the batch,
the timing protocol, the CLI and a tiered checkpoint round trip hold."""

import os

import numpy as np
import pytest

SHAPES = ((1, 2), (2, 1), (2, 2))
FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")


@pytest.fixture(scope="module")
def pools():
    import torch

    from bibfs_tpu_torch.parallel.pool import MeshPool

    torch.set_num_threads(2)
    made = {w: MeshPool(w, "cpu", timeout_s=300) for w in (2, 4)}
    yield made
    for p in made.values():
        p.close()


_HOSTS: dict = {}


def _host(key, n, edges, R, C, pools):
    """The port's blocks of a graph for an R x C grid, registered on the
    pool of ``R C`` ranks once."""
    from bibfs_tpu_torch.solvers.sharded2d import Sharded2DHost

    name = f"{key}-{R}x{C}"
    if name not in _HOSTS:
        pool = pools[R * C]
        host = Sharded2DHost.build(n, edges, R, C)
        pool.graph(name, host.save(os.path.join(pool.workdir, name)))
        _HOSTS[name] = host
    return name, _HOSTS[name]


def _jobs(pools, R, C, jobs):
    return pools[R * C].call("jobs", jobs)["results"]


def _ref_graph(n, edges, R, C):
    from bibfs_tpu.parallel.mesh import make_2d_mesh
    from bibfs_tpu.solvers.sharded2d import Sharded2DGraph

    return Sharded2DGraph(n, edges, make_2d_mesh(R, C))


def _ref_raw(g, s, d, mode="sync"):
    import jax.numpy as jnp

    from bibfs_tpu.solvers.sharded2d import _compiled_2d

    fn = _compiled_2d(g.mesh, g.R, g.C, mode, g.tier_meta)
    o = fn(g.bnbr, g.bcnt, g.deg, g.aux, jnp.int32(s), jnp.int32(d))
    return (int(o[0]), int(o[1]), np.asarray(o[2]), np.asarray(o[3]),
            int(o[4]), int(o[5]))


def _same_raw(got, want, what):
    assert got[:2] == want[:2] and got[4:] == want[4:], (what, got, want)
    assert np.array_equal(got[2], want[2]), what
    assert np.array_equal(got[3], want[3]), what


def _check_raw(key, n, edges, R, C, pools, pairs, modes=("sync", "alt")):
    """Every (mode, pair) on the port's grid against the reference's
    program on the same shape."""
    name, _h = _host(key, n, edges, R, C, pools)
    cases = [(m, s, d) for m in modes for s, d in pairs]
    got = _jobs(pools, R, C, [dict(kind="solve2d", graph=name, src=s, dst=d,
                                   mode=m, raw=True) for m, s, d in cases])
    g = _ref_graph(n, edges, R, C)
    for (m, s, d), o in zip(cases, got):
        _same_raw(o, _ref_raw(g, s, d, m), (key, R, C, m, s, d))
    return got


def _gnp(n, deg, seed):
    from bibfs_tpu.graph.generate import gnp_random_graph

    return gnp_random_graph(n, deg / n, seed=seed)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_shapes_match_reference(shape, pools):
    n = 300
    edges = _gnp(n, 5.0, 13)
    got = _check_raw("gnp300", n, edges, *shape, pools,
                     [(0, n - 1), (5, 5), (3, 250)])
    assert got[0][0] < 1 << 30 and got[2][0] < 1 << 30  # paths, not only
    # the self pair


@pytest.mark.parametrize("mode", ["sync", "alt"])
def test_random_cases_match_reference(mode, pools):
    from tests.conftest import random_graph_cases

    for i, (n, edges, s, d) in enumerate(random_graph_cases(num=8, seed=77)):
        _check_raw(f"case{i}", n, edges, 2, 2, pools, [(s, d)], (mode,))


def test_rmat_skewed_degrees(pools):
    """Power-law degrees: block widths differ widely across blocks."""
    from bibfs_tpu.graph.generate import rmat_graph

    n, edges = rmat_graph(9, seed=5)
    deg = np.bincount(np.concatenate([edges[:, 0], edges[:, 1]]), minlength=n)
    hub = int(np.argmax(deg))
    _check_raw("rmat9", n, edges, 2, 2, pools,
               [(hub, (hub + 200) % n), (0, hub)])


def test_unreachable_and_self(pools):
    n = 96
    edges = np.array([[0, 1], [1, 2], [50, 51]], dtype=np.uint32)
    name, _h = _host("tiny", n, edges, 2, 2, pools)
    res = _jobs(pools, 2, 2, [dict(kind="solve2d", graph=name, src=0, dst=51),
                              dict(kind="solve2d", graph=name, src=7, dst=7)])
    assert not res[0].found
    assert res[1].found and res[1].hops == 0
    _check_raw("tiny", n, edges, 2, 2, pools, [(0, 51), (7, 7), (0, 2)])


def test_timing_protocol(pools):
    from bibfs_tpu.solvers.sharded2d import solve_sharded2d_graph

    n = 256
    edges = _gnp(n, 3.0, 3)
    name, _h = _host("gnp256", n, edges, 2, 2, pools)
    res = _jobs(pools, 2, 2, [dict(kind="solve2d", graph=name, src=0,
                                   dst=n - 1, repeats=3)])[0]
    want = solve_sharded2d_graph(_ref_graph(n, edges, 2, 2), 0, n - 1)
    assert [getattr(res, f) for f in FIELDS] == [getattr(want, f)
                                                 for f in FIELDS]
    assert res.time_s > 0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_block_tables_equal_reference(shape):
    """Every directed edge in one block at the reference's localized
    slot: the port's host blocks equal the reference's device arrays, and
    the per-vertex block counts sum to the true degrees."""
    from bibfs_tpu_torch.solvers.sharded2d import Sharded2DHost

    n = 200
    edges = _gnp(n, 4.0, 9)
    h = Sharded2DHost.build(n, edges, *shape)
    g = _ref_graph(n, edges, *shape)
    assert (h.n_pad, h.n_loc, h.width, h.max_group, h.num_edges) == (
        g.n_pad, g.n_loc, g.width, g.max_group, g.num_edges)
    for name in ("bnbr", "bcnt", "deg"):
        assert np.array_equal(getattr(h, name), np.asarray(getattr(g, name)))
    assert h.tier_meta == g.tier_meta
    nr = h.n_pad // h.R
    per_vertex = np.zeros(h.n_pad, dtype=np.int64)
    for r in range(h.R):
        for c in range(h.C):
            per_vertex[r * nr:(r + 1) * nr] += h.bcnt[r, c]
    assert np.array_equal(per_vertex, h.deg)


def test_traffic_accounting():
    from bibfs_tpu.solvers.sharded2d import frontier_exchange_bytes_2d as ref

    from bibfs_tpu_torch.solvers.sharded2d import frontier_exchange_bytes_2d

    for n_pad, R, C in ((1 << 20, 4, 2), (1 << 20, 2, 2), (4096, 1, 2)):
        assert frontier_exchange_bytes_2d(n_pad, R, C) == ref(n_pad, R, C)
    fx = frontier_exchange_bytes_2d(1 << 20, 4, 2)
    assert fx["expand_all_gather_r"] + fx["transpose_ppermute"] < (
        fx["oneD_all_gather_equiv"])


def test_grid_validation():
    """A 1D mesh is refused by the 2D graph; a grid needs a process group
    whose size it covers; a given shape must cover the device count."""
    from bibfs_tpu_torch.parallel.mesh import Mesh, make_2d_mesh
    from bibfs_tpu_torch.solvers.sharded2d import (
        Sharded2DGraph,
        Sharded2DHost,
        grid_shape,
    )

    n = 64
    host = Sharded2DHost.build(n, _gnp(n, 3.0, 1), 2, 2)
    with pytest.raises(ValueError, match="2D mesh"):
        Sharded2DGraph(host, Mesh(0, 4, "cpu", "gloo"))
    with pytest.raises(RuntimeError, match="process group"):
        make_2d_mesh(2, 2)
    with pytest.raises(ValueError, match="disagrees"):
        grid_shape(4, 2, 4)


def test_devices_flag_honored():
    """The squarest factorization of the device count, as the reference
    picks it; an explicit shape must agree with the count."""
    from bibfs_tpu_torch.solvers.sharded2d import grid_shape

    assert grid_shape(4) == (2, 2)
    assert grid_shape(2) == (1, 2)
    assert grid_shape(8) == (2, 4)
    assert grid_shape(4, 1, 4) == (1, 4)
    with pytest.raises(ValueError, match="disagrees"):
        grid_shape(4, 2, 4)


def test_batch_matches_reference(pools):
    """The 2D batch (its queries one after another) equals the reference's
    vmapped batch, field by field."""
    from bibfs_tpu.solvers.sharded2d import solve_batch_sharded2d_graph

    n = 300
    edges = _gnp(n, 3.0, 21)
    pairs = [(0, n - 1), (5, 5), (3, 250), (7, 100)]
    name, _h = _host("gnp300b", n, edges, 2, 2, pools)
    got = _jobs(pools, 2, 2, [dict(kind="batch2d", graph=name, pairs=pairs)])
    want = solve_batch_sharded2d_graph(_ref_graph(n, edges, 2, 2), pairs)
    assert [[getattr(r, f) for f in FIELDS] for r in got[0]] == [
        [getattr(r, f) for f in FIELDS] for r in want]


def _hub_graph(n=512, hubs=200, seed=4):
    rng = np.random.default_rng(seed)
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    star = np.stack([np.zeros(hubs, dtype=np.int64),
                     rng.choice(np.arange(1, n), hubs, replace=False)], axis=1)
    return np.concatenate([ring, star], axis=0)


def test_tiered_blocks_on_hub_graph(pools):
    """A hub whose block groups dwarf the typical group forces overflow
    tiers: the tier tables equal the reference's, the padded footprint
    beats the single-width layout, and the search equals the reference's
    through the tier spill."""
    from bibfs_tpu_torch.solvers.sharded2d import Sharded2DHost

    n = 512
    edges = _hub_graph(n)
    h = Sharded2DHost.build(n, edges, 2, 2)
    g = _ref_graph(n, edges, 2, 2)
    assert h.tier_meta and h.tier_meta == g.tier_meta
    assert h.width < h.max_group
    for (tn, ti), (rtn, rti) in zip(h.tiers, g.aux):
        assert np.array_equal(tn, np.asarray(rtn))
        assert np.array_equal(ti, np.asarray(rti))
    assert h.padded_slots == g.padded_slots
    assert h.padded_slots < h.R * h.C * (h.n_pad // h.R) * h.max_group
    _check_raw("hub", n, edges, 2, 2, pools, [(0, n // 2), (3, n - 2)])


def test_tiered_checkpoint_roundtrip(pools, tmp_path):
    """A chunked search on the tiered 2D graph stopped after one chunk and
    resumed equals the one-shot search's fields."""
    from bibfs_tpu.solvers.serial import solve_serial

    n = 512
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    star = np.stack([np.zeros(150, dtype=np.int64), np.arange(2, 152)], axis=1)
    edges = np.concatenate([ring, star], axis=0)
    name, h = _host("hub-ck", n, edges, 2, 2, pools)
    assert h.tier_meta
    src, dst = 1, n // 2 + 3
    path = str(tmp_path / "t2d.ckpt")
    job = dict(graph=name, substrate="2d", src=src, dst=dst)
    got = _jobs(pools, 2, 2, [
        dict(kind="solve2d", graph=name, src=src, dst=dst),
        dict(kind="checkpoint", chunk=1, path=path, max_chunks=1, **job),
        dict(kind="resume", chunk=4, path=path, **job)])
    one, stopped, res = got
    assert stopped is None
    assert [getattr(res, f) for f in FIELDS] == [getattr(one, f)
                                                 for f in FIELDS]
    ref = solve_serial(n, edges, src, dst)
    assert (res.found, res.hops) == (ref.found, ref.hops)


def _write_graph(tmp_path, n, edges):
    from bibfs_tpu_torch.graph.io import write_graph_bin

    gpath = str(tmp_path / "g.bin")
    write_graph_bin(gpath, n, edges)
    return gpath


def test_cli_sharded2d(tmp_path, capsys):
    """``bibfs-torch-solve --backend sharded2d --grid 2x2`` prints the
    reference CLI's answer lines, and refuses what it refuses."""
    from bibfs_tpu.solvers.serial import solve_serial

    from bibfs_tpu_torch.cli.solve import main

    n = 256
    edges = _gnp(n, 3.0, 3)
    ref = solve_serial(n, edges, 0, n - 1)
    gpath = _write_graph(tmp_path, n, edges)
    rc = main([gpath, "0", str(n - 1), "--backend", "sharded2d", "--grid",
               "2x2", "--no-path", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert (f"Shortest path length = {ref.hops}" if ref.found
            else "No path found.") in out
    for bad in (["--backend", "sharded2d", "--grid", "banana"],
                ["--backend", "dense", "--grid", "2x4"],
                ["--backend", "sharded2d", "--mode", "beamer"],
                ["--backend", "sharded2d", "--layout", "tiered"]):
        with pytest.raises(SystemExit):
            main([gpath, "0", "1", "--device", "cpu"] + bad)


def test_cli_pairs_sharded2d(tmp_path, capsys):
    from bibfs_tpu.solvers.serial import solve_serial

    from bibfs_tpu_torch.cli.solve import main

    n = 256
    edges = _gnp(n, 3.0, 3)
    gpath = _write_graph(tmp_path, n, edges)
    pfile = str(tmp_path / "p.txt")
    with open(pfile, "w") as f:
        f.write(f"0 {n - 1}\n4 4\n")
    rc = main([gpath, "--backend", "sharded2d", "--pairs", pfile, "--grid",
               "1x2", "--no-path", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    ref = solve_serial(n, edges, 0, n - 1)
    if ref.found:
        assert f"length = {ref.hops}" in out
    assert "length = 0" in out  # the self pair


def test_exchange_job_reports_the_reference_bytes(pools):
    """The ``exchange2d`` job times the three exchanges of a round on the
    ranks and reports the reference's per-side bytes."""
    from bibfs_tpu.solvers.sharded2d import frontier_exchange_bytes_2d as ref

    n = 300
    name, h = _host("gnp300", n, _gnp(n, 5.0, 13), 2, 2, pools)
    ex = _jobs(pools, 2, 2, [dict(kind="exchange2d", graph=name, reps=2)])[0]
    assert ex["bytes_per_side"] == ref(h.n_pad, 2, 2)
    assert ex["transport"] == "gloo" and ex["grid"] == [2, 2]
    assert min(ex["transpose_ms"], ex["gather_ms"], ex["fold_ms"]) > 0
