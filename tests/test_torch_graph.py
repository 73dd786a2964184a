"""The PyTorch port's graph layer against bibfs_tpu.graph: byte-identical
``.bin`` files, array-identical CSR/ELL/tiered tables, edge-identical
generators for equal seeds, and the device-graph carry-over."""

import numpy as np
import pytest

from tests.conftest import random_graph_cases


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _grid_cases():
    from bibfs_tpu.graph.generate import grid_graph

    return [(w * h, grid_graph(w, h, perforation=p, seed=3))
            for w, h, p in ((7, 5, 0.0), (12, 9, 0.15))]


def _rmat_case():
    from bibfs_tpu.graph.generate import rmat_graph

    return rmat_graph(10, edge_factor=4, seed=7)


def _graph_cases():
    cases = [(n, e) for n, e, _s, _d in random_graph_cases(12)]
    return cases + _grid_cases() + [_rmat_case()]


GRAPH_IDS = [f"random{i}" for i in range(12)] + ["grid", "grid_perf", "rmat10"]


def test_bin_round_trip_byte_identical(tmp_path):
    from bibfs_tpu.graph import io as jio
    from bibfs_tpu.graph.generate import gnp_random_graph

    from bibfs_tpu_torch.graph import io as tio

    n = 500
    edges = gnp_random_graph(n, 3.0 / n, seed=4)
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    jio.write_graph_bin(a, n, edges)
    tio.write_graph_bin(b, n, edges)
    assert a.read_bytes() == b.read_bytes()
    n2, e2 = tio.read_graph_bin(a)
    n3, e3 = jio.read_graph_bin(b)
    assert n2 == n3 == n and np.array_equal(e2, e3) and np.array_equal(e2, edges)
    ga, gb = tio.ground_truth_path(a), jio.ground_truth_path(b)
    assert ga.endswith("a.json") and gb.endswith("b.json")
    jio.write_ground_truth(ga, 0, 7, 3, [0, 2, 5, 7])
    tio.write_ground_truth(gb, 0, 7, 3, [0, 2, 5, 7])
    assert open(ga, "rb").read() == open(gb, "rb").read()
    assert tio.read_ground_truth(ga) == jio.read_ground_truth(gb)


def test_bin_reader_rejects_bad_files(tmp_path):
    from bibfs_tpu_torch.graph.io import read_graph_bin, write_graph_bin

    p = tmp_path / "t.bin"
    with pytest.raises(ValueError):
        write_graph_bin(p, 3, np.array([[0, 3]]))
    np.array([4, 2, 0, 1], dtype="<u4").tofile(p)  # claims 2 edges, has 1
    with pytest.raises(ValueError, match="payload"):
        read_graph_bin(p)
    np.array([4, 1, 0, 2 ** 31], dtype="<u4").tofile(p)
    with pytest.raises(ValueError, match="negative"):
        read_graph_bin(p)
    np.array([4, 1, 0, 9], dtype="<u4").tofile(p)
    with pytest.raises(ValueError, match="out of range"):
        read_graph_bin(p)


@pytest.mark.parametrize("case", range(len(GRAPH_IDS)), ids=GRAPH_IDS)
def test_builders_array_identical(case):
    from bibfs_tpu.graph import csr as jcsr

    from bibfs_tpu_torch.graph import csr as tcsr

    n, edges = _graph_cases()[case]
    pj, pt = jcsr.canonical_pairs(n, edges), tcsr.canonical_pairs(n, edges)
    assert np.array_equal(pj, pt)
    for a, b in zip(jcsr.build_csr(n, edges), tcsr.build_csr(n, pairs=pt)):
        assert np.array_equal(a, b)
    ej, et = jcsr.build_ell(n, edges), tcsr.build_ell(n, edges)
    for f in ("n", "n_pad", "width", "num_edges"):
        assert getattr(ej, f) == getattr(et, f)
    for f in ("nbr", "deg", "overflow"):
        assert np.array_equal(getattr(ej, f), getattr(et, f))
        assert getattr(ej, f).dtype == getattr(et, f).dtype
    tj, tt = jcsr.build_tiered(n, edges), tcsr.build_tiered(n, edges)
    for f in ("n", "n_pad", "width", "num_edges", "max_deg"):
        assert getattr(tj, f) == getattr(tt, f)
    for f in ("nbr", "deg", "hub_rank", "hub_ids"):
        assert np.array_equal(getattr(tj, f), getattr(tt, f))
    assert len(tj.tiers) == len(tt.tiers)
    for a, b in zip(tj.tiers, tt.tiers):
        assert (a.start, a.count) == (b.start, b.count)
        assert np.array_equal(a.nbr, b.nbr)
    assert jcsr._tier_plan(4, 300) == tcsr._tier_plan(4, 300)


def test_rmat_layout_has_tiers():
    """The rmat case above exercises real hub tiers (not a degenerate
    single-table tiered layout)."""
    from bibfs_tpu_torch.graph.csr import build_tiered

    n, edges = _rmat_case()
    assert build_tiered(n, edges).tiers


@pytest.mark.parametrize(
    "n,p,seed", [(1, 0.5, 0), (50, 0.1, 1), (1000, 0.003, 2), (300, 1.0, 3),
                 (2000, 0.0, 4)])
def test_gnp_edge_identical(n, p, seed):
    from bibfs_tpu.graph.generate import gnp_random_graph as jg

    from bibfs_tpu_torch.graph.generate import gnp_random_graph as tg

    assert np.array_equal(jg(n, p, seed=seed), tg(n, p, seed=seed))


@pytest.mark.parametrize("scale,ef,seed,dedup",
                         [(6, 4, 0, True), (10, 8, 7, True), (8, 16, 3, False)])
def test_rmat_edge_identical(scale, ef, seed, dedup):
    from bibfs_tpu.graph.generate import rmat_graph as jr

    from bibfs_tpu_torch.graph.generate import rmat_graph as tr

    nj, ej = jr(scale, ef, seed=seed, dedup=dedup)
    nt, et = tr(scale, ef, seed=seed, dedup=dedup)
    assert nj == nt and np.array_equal(ej, et)


def test_grid_edge_identical():
    from bibfs_tpu.graph.generate import grid_graph as jgrid

    from bibfs_tpu_torch.graph.generate import grid_graph as tgrid

    for w, h, p in ((1, 1, 0.0), (9, 4, 0.0), (20, 20, 0.3)):
        assert np.array_equal(jgrid(w, h, perforation=p, seed=5),
                              tgrid(w, h, perforation=p, seed=5))


@pytest.mark.parametrize("layout", ["ell", "tiered"])
def test_from_arrays_equals_own_build(layout):
    """The JAX package's host tables, and np.asarray of its device
    graph, carried into the port equal the port's own build."""
    import torch

    from bibfs_tpu.graph.csr import build_ell, build_tiered
    from bibfs_tpu.solvers.dense import DeviceGraph as JaxGraph

    from bibfs_tpu_torch.solvers.dense import DeviceGraph

    n, edges = _rmat_case()
    own = DeviceGraph.build(n, edges, layout=layout, device="cpu")
    if layout == "ell":
        h = build_ell(n, edges)
        carried = DeviceGraph.from_arrays(h.nbr, h.deg, n=h.n,
                                          num_edges=h.num_edges, device="cpu")
    else:
        h = build_tiered(n, edges)
        carried = DeviceGraph.from_arrays(
            h.nbr, h.deg, hub_rank=h.hub_rank,
            tiers=[(t.nbr, h.hub_ids[: t.nbr.shape[0]]) for t in h.tiers],
            tier_meta=[(t.start, t.count, t.nbr.shape[1]) for t in h.tiers],
            n=h.n, num_edges=h.num_edges, device="cpu",
        )
    jg = JaxGraph.build(n, edges, layout=layout)
    from_jax = DeviceGraph.from_arrays(
        np.asarray(jg.nbr), np.asarray(jg.deg),
        hub_rank=None if jg.hub_rank is None else np.asarray(jg.hub_rank),
        tiers=[(np.asarray(a), np.asarray(b)) for a, b in jg.tiers],
        tier_meta=jg.tier_meta, n=jg.n, num_edges=jg.num_edges, device="cpu",
    )
    for g in (carried, from_jax):
        assert (g.n, g.n_pad, g.width, g.num_edges, g.tier_meta) == (
            own.n, own.n_pad, own.width, own.num_edges, own.tier_meta)
        assert torch.equal(g.nbr, own.nbr) and torch.equal(g.deg, own.deg)
        assert (g.hub_rank is None) == (own.hub_rank is None)
        if own.hub_rank is not None:
            assert torch.equal(g.hub_rank, own.hub_rank)
        for (a, b), (c, d) in zip(g.tiers, own.tiers):
            assert torch.equal(a, c) and torch.equal(b, d)
    assert (own.tier_meta != ()) == (layout == "tiered")
