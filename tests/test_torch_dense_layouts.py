"""The PyTorch port's dense solver against bibfs_tpu on a grid and on a
tiered RMAT graph in all nine modes, and its edge cases: src == dst,
disconnected pairs, unroll, the tiered route of the fused modes, and no
silent CPU fallback."""

import numpy as np
import pytest

from tests.test_torch_dense import MODES, assert_same_raw, compare_graph


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _grid():
    from bibfs_tpu.graph.generate import grid_graph

    return 15 * 12, grid_graph(15, 12, perforation=0.1, seed=2)


def _rmat():
    from bibfs_tpu.graph.generate import rmat_graph

    return rmat_graph(10, edge_factor=4, seed=7)


@pytest.mark.parametrize("mode", MODES)
def test_grid_matches_reference(mode):
    n, edges = _grid()
    compare_graph(n, edges, mode, [(0, n - 1), (7, 100), (33, 33)])


@pytest.mark.parametrize("mode", MODES)
def test_tiered_rmat_matches_reference(mode):
    n, edges = _rmat()
    g = compare_graph(n, edges, mode, [(0, 5), (1, n - 1), (12, 300)],
                      layout="tiered")
    assert g.tier_meta


def test_src_eq_dst_and_disconnected():
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    e = np.array([[0, 1], [1, 2], [3, 4], [4, 5]], np.int64)
    gj = jd.DeviceGraph.build(6, e)
    gt = td.DeviceGraph.build(6, e, device="cpu")
    for mode in MODES:
        r = td.solve_dense_graph(gt, 2, 2, mode=mode)
        assert r.found and r.hops == 0 and r.path == [2] and r.levels == 0
        r2 = td.solve_dense_graph(gt, 0, 5, mode=mode)
        assert not r2.found and r2.path is None
        r3 = td.solve_dense_graph(gt, 0, 2, mode=mode)
        assert r3.found and r3.hops == 2 and r3.path == [0, 1, 2]
        for s, d in ((2, 2), (0, 5), (0, 2)):
            a = jd.solve_dense_graph(gj, s, d, mode=mode)
            b = td.solve_dense_graph(gt, s, d, mode=mode)
            assert (a.found, a.hops, a.path, a.levels, a.edges_scanned) == (
                b.found, b.hops, b.path, b.levels, b.edges_scanned)


@pytest.mark.parametrize("mode", MODES)
def test_degenerate_graphs_match_reference(mode):
    """A single vertex, and two vertices with no edge (ELL width 1, every
    slot dead)."""
    for n, pairs in ((1, [(0, 0)]), (2, [(0, 1), (1, 1)])):
        compare_graph(n, np.zeros((0, 2), np.int64), mode, pairs)


@pytest.mark.parametrize("mode", MODES)
def test_unroll_is_exact(mode):
    """unroll 1 and 3 give identical raw outputs; the fused modes read
    the device state fewer times with the larger unroll."""
    from bibfs_tpu.graph.generate import gnp_random_graph

    from bibfs_tpu_torch.solvers import dense as td

    n = 1500
    edges = gnp_random_graph(n, 2.5 / n, seed=9)
    g = td.DeviceGraph.build(n, edges, device="cpu")
    for s, d in ((0, n - 1), (4, 4), (10, 700)):
        outs, syncs = [], []
        for unroll in (1, 3):
            stats = {"host_syncs": 0}
            k = td._get_kernel(mode, td.kernel_cap(mode, g.n_pad, g.device.type),
                               g.tier_meta,
                               unroll)
            outs.append(k(g.nbr, g.deg, g.aux, s, d, cache=g.tables, stats=stats))
            syncs.append(stats["host_syncs"])
        a, b = outs
        assert a[0] == b[0] and a[1] == b[1] and a[4:] == b[4:]
        assert np.array_equal(a[2].numpy(), b[2].numpy())
        assert np.array_equal(a[3].numpy(), b[3].numpy())
        if mode.startswith("fused") and a[4] > 3:
            assert syncs[1] < syncs[0]


@pytest.mark.parametrize("mode", ["fused", "fused_alt"])
def test_fused_unroll_matches_reference_unroll(mode):
    from bibfs_tpu.graph.generate import gnp_random_graph
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    n = 800
    edges = gnp_random_graph(n, 2.5 / n, seed=6)
    gj = jd.DeviceGraph.build(n, edges)
    gt = td.DeviceGraph.build(n, edges, device="cpu")
    kj = jd._get_kernel(mode, 0, (), jd._geom_of(gj), 3)
    kt = td._get_kernel(mode, 0, (), 3)
    for s, d in ((0, n - 1), (3, 400)):
        assert_same_raw(
            kj(gj.nbr, gj.deg, gj.aux, jd._device_scalar(s), jd._device_scalar(d)),
            kt(gt.nbr, gt.deg, gt.aux, s, d, cache=gt.tables))


def test_tiered_fused_runs_as_pallas():
    """The layout route is the one degrade kept, and it is visible: the
    result records the mode that ran."""
    from bibfs_tpu_torch.solvers.dense import (
        DeviceGraph,
        resolve_mode,
        solve_dense_graph,
    )
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n, edges = _rmat()
    g = DeviceGraph.build(n, edges, layout="tiered", device="cpu")
    want = solve_serial(n, edges, 0, 5)
    for mode, ran in (("fused", "pallas"), ("fused_alt", "pallas_alt"),
                      ("pallas", "pallas"), ("sync", "sync")):
        assert resolve_mode(mode, g.tier_meta) == ran
        got = solve_dense_graph(g, 0, 5, mode=mode)
        assert got.mode == ran
        assert got.found == want.found and got.hops == want.hops
    plain = DeviceGraph.build(n, edges, layout="ell", device="cpu")
    assert solve_dense_graph(plain, 0, 5, mode="fused").mode == "fused"
    with pytest.raises(ValueError):
        resolve_mode("nope")


def test_no_device_and_no_cuda_raises(monkeypatch):
    """Entry points default to CUDA and never fall back to the CPU."""
    import torch

    from bibfs_tpu_torch.solvers.api import solve
    from bibfs_tpu_torch.solvers.dense import DeviceGraph, solve_dense
    from bibfs_tpu_torch.utils.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = np.array([[0, 1], [1, 2]], np.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceGraph.build(3, e)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_dense(3, e, 0, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve("dense", 3, e, 0, 2)
    assert resolve_device("cpu") == torch.device("cpu")
    assert solve("dense", 3, e, 0, 2, device="cpu").hops == 2
    assert solve("serial", 3, e, 0, 2).path == [0, 1, 2]


def test_time_search_on_cpu():
    from bibfs_tpu.graph.generate import gnp_random_graph

    from bibfs_tpu_torch.solvers.dense import DeviceGraph, time_search
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n = 600
    edges = gnp_random_graph(n, 3.0 / n, seed=1)
    g = DeviceGraph.build(n, edges, device="cpu")
    times, res = time_search(g, 0, n - 1, repeats=3, mode="fused", unroll=2)
    assert len(times) == 3 and res.time_s == float(np.median(times))
    assert res.hops == solve_serial(n, edges, 0, n - 1).hops
    with pytest.raises(ValueError):
        time_search(g, 0, n, repeats=1)

