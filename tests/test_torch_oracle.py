"""The port's distance oracle (``bibfs_tpu_torch.oracle``,
``bibfs_tpu_torch.ops.msbfs_device``) against ``bibfs_tpu.oracle`` and
``bibfs_tpu.ops.msbfs_device`` on the CPU, exactly: the K-source sweep
(the port's NumPy sweep and its plain torch level, driven by the device
loop) against the reference's host sweep and its jitted ELL sweep for K
= 1, 31, 32, 33, 64, 65, 100; landmark selection and index builds; every
pair's consult kind and bounds over the reference's own index handed to
the port (``LandmarkIndex.from_arrays``); adds-only repair; the cutoff
serial solve. On a card, the CUDA level equals its plain version."""

import numpy as np
import pytest

K_VALUES = (1, 31, 32, 33, 64, 65, 100)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _grid(rows=24, cols=20, seed=1):
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.graph.generate import grid_graph

    n = rows * cols
    edges = grid_graph(rows, cols, perforation=0.05, seed=seed)
    return n, edges, build_csr(n, edges)


def _components(n=300, seed=3):
    """A sparse G(n, p) below the giant-component threshold: many
    components, isolated vertices included."""
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    edges = gnp_random_graph(n, 1.2 / n, seed=seed)
    return n, edges, build_csr(n, edges)


@pytest.mark.parametrize("k", K_VALUES)
def test_sweeps_equal_reference(k):
    from bibfs_tpu.ops.msbfs_device import msbfs_plane_csr as ref_plane
    from bibfs_tpu.oracle.trees import multi_source_bfs as ref_bfs

    from bibfs_tpu_torch.ops import msbfs_device as md
    from bibfs_tpu_torch.oracle.trees import multi_source_bfs, multi_source_dist

    n, _edges, (rp, ci) = _grid()
    src = np.random.default_rng(k).choice(n, size=k, replace=False)
    want = ref_bfs(n, rp, ci, src)
    assert want.dtype == np.int16 and want.shape == (n, k)
    np.testing.assert_array_equal(np.asarray(ref_plane(n, rp, ci, src)), want)
    np.testing.assert_array_equal(multi_source_bfs(n, rp, ci, src), want)
    before = md.sweeps_run()
    stats = {}
    got = multi_source_dist(n, rp, ci, src, device="cpu", stats=stats)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert md.sweeps_run() == before + 1
    # one host read per CHECK_EVERY launches; levels = the deepest stamp
    assert stats["levels"] == int(want.max())
    assert stats["launches"] == stats["host_reads"] * md.CHECK_EVERY
    assert stats["launches"] - stats["levels"] <= md.CHECK_EVERY


def test_sweep_duplicates_components_and_ell_inputs(monkeypatch):
    from bibfs_tpu.oracle.trees import multi_source_bfs as ref_bfs

    from bibfs_tpu_torch.graph.csr import build_ell
    from bibfs_tpu_torch.ops import msbfs_device as md
    from bibfs_tpu_torch.ops.msbfs_device import (
        msbfs_plane_csr,
        msbfs_plane_ell,
        msbfs_plane_graph,
    )
    from bibfs_tpu_torch.solvers.dense import DeviceGraph

    n, edges, (rp, ci) = _components()
    src = np.array([0, 5, 5, 17, n - 1, 40, 0])  # repeats, isolated ones
    want = ref_bfs(n, rp, ci, src)
    with monkeypatch.context() as m:  # another cadence of host reads
        m.setattr(md, "CHECK_EVERY", 3)
        np.testing.assert_array_equal(
            msbfs_plane_csr(n, rp, ci, src, device="cpu"), want)
    ell = build_ell(n, edges)
    np.testing.assert_array_equal(
        msbfs_plane_ell(n, ell.nbr, ell.deg, src, device="cpu"), want)
    g = DeviceGraph.build(n, edges, device="cpu")
    np.testing.assert_array_equal(msbfs_plane_graph(g, src), want)
    tiered = DeviceGraph.build(n, edges, layout="tiered", device="cpu")
    if tiered.tier_meta:
        with pytest.raises(ValueError, match="plain-ELL"):
            msbfs_plane_graph(tiered, src)
    assert msbfs_plane_csr(n, rp, ci, [], device="cpu").shape == (n, 0)
    for bad in ([-1], [n]):
        with pytest.raises(ValueError, match="out of range"):
            msbfs_plane_csr(n, rp, ci, bad, device="cpu")


def test_diameter_above_int16_raises(monkeypatch):
    """The device loop raises the reference's ValueError when a level
    above the plane's range finds new vertices (the range lowered to 20
    here; a real path graph beyond 32767 hops would take minutes in the
    plain level)."""
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.ops import msbfs_device as md

    n = 30
    rp, ci = build_csr(n, np.array([[i, i + 1] for i in range(n - 1)]))
    monkeypatch.setattr(md, "INT16_MAX", 20)
    with pytest.raises(ValueError, match="int16"):
        md.msbfs_plane_csr(n, rp, ci, [0], device="cpu")  # 29 hops deep
    got = md.msbfs_plane_csr(n, rp, ci, [15], device="cpu")  # 15 deep
    np.testing.assert_array_equal(got[:, 0], np.abs(np.arange(n) - 15))


def test_plain_level_state_and_skip():
    """One plain level on a seeded mid-sweep state: the outputs are the
    level's definition (OR of the neighbours' pending words, new bits
    only), and a level whose predecessor found nothing writes an empty
    frontier and touches nothing."""
    import torch

    from bibfs_tpu_torch.ops.msbfs_device import (
        msbfs_level,
        pack_words,
        unpack_words,
    )

    n, _edges, (rp, ci) = _grid(12, 10)
    rng = np.random.default_rng(5)
    k = 40
    reach_b = rng.random((n, 64)) < 0.4
    reach_b[:, k:] = False
    pend_b = reach_b & (rng.random((n, 64)) < 0.5)
    reach = pack_words(torch.from_numpy(reach_b))
    pending = pack_words(torch.from_numpy(pend_b))
    dist = torch.full((n, k), -1, dtype=torch.int16)
    flag = torch.zeros(1, dtype=torch.int32)
    rpt = torch.from_numpy(rp)
    cit = torch.from_numpy(ci.astype(np.int32))
    reach0 = reach.clone()
    nxt = msbfs_level(rpt, cit, pending, reach, dist, 7, flag)
    acc = np.zeros((n, 64), dtype=bool)
    for v in range(n):
        for u in ci[rp[v]:rp[v + 1]]:
            acc[v] |= pend_b[u]
    new = acc & ~reach_b
    np.testing.assert_array_equal(unpack_words(nxt).numpy(), new)
    np.testing.assert_array_equal(unpack_words(reach).numpy(), reach_b | new)
    np.testing.assert_array_equal(dist.numpy() == 7, new[:, :k])
    assert int(flag) == int(new.any())
    live = torch.zeros(1, dtype=torch.int32)
    reach1, dist1 = reach.clone(), dist.clone()
    skipped = msbfs_level(rpt, cit, nxt, reach, dist, 8, flag, live)
    assert int(skipped.abs().sum()) == 0
    assert torch.equal(reach, reach1) and torch.equal(dist, dist1)
    assert not torch.equal(reach0, reach1)


@pytest.mark.parametrize("graph", ["grid", "components"])
def test_select_landmarks_and_build_index_equal(graph):
    from bibfs_tpu.oracle.landmarks import select_landmarks as ref_select
    from bibfs_tpu.oracle.trees import build_index as ref_build

    from bibfs_tpu_torch.oracle import build_index, select_landmarks

    n, _edges, (rp, ci) = _grid() if graph == "grid" else _components()
    for k in (1, 8, 20, 40):
        want = ref_select(n, rp, ci, k)
        np.testing.assert_array_equal(
            select_landmarks(n, rp, ci, k, device="host"), want)
        ref = ref_build(n, rp, ci, k, digest="d", version=3, gen=2)
        for device in ("host", "cpu"):
            got = build_index(n, rp, ci, k, digest="d", version=3, gen=2,
                              device=device)
            np.testing.assert_array_equal(got.landmarks, ref.landmarks)
            np.testing.assert_array_equal(got.dist, ref.dist)
            assert (got.k, got.gen, got.version) == (ref.k, ref.gen,
                                                     ref.version)
            s_got, s_ref = got.stats(), ref.stats()
            s_got.pop("age_s"), s_ref.pop("age_s")
            assert s_got == s_ref
    with pytest.raises(ValueError, match="at least 1 landmark"):
        select_landmarks(n, rp, ci, 0, device="host")


@pytest.mark.parametrize("entry", ["multi_source_dist", "select_landmarks",
                                   "build_index"])
def test_sweep_entry_points_default_to_cuda(entry, monkeypatch):
    """With no ``device`` every sweep entry point asks for the card; only
    ``device="host"`` runs the NumPy sweep."""
    import torch

    from bibfs_tpu_torch import oracle

    n, _edges, (rp, ci) = _grid(6, 5)
    args = (n, rp, ci, [0, 7]) if entry == "multi_source_dist" else (
        n, rp, ci, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(oracle, entry)(*args)
    got = getattr(oracle, entry)(*args, device="host")
    assert got is not None


@pytest.mark.parametrize("graph", ["grid", "components"])
def test_consult_every_pair_equals_reference(graph):
    """The reference's own index handed to the port's oracle: kinds,
    bounds and results equal for every ordered pair."""
    from bibfs_tpu.oracle import DistanceOracle as RefOracle
    from bibfs_tpu.oracle.trees import build_index as ref_build

    from bibfs_tpu_torch.oracle import DistanceOracle, LandmarkIndex

    n, _edges, (rp, ci) = (_grid(12, 10) if graph == "grid"
                           else _components(160, 4))
    ref_idx = ref_build(n, rp, ci, 6)
    idx = LandmarkIndex.from_arrays(n, ref_idx.landmarks, ref_idx.dist,
                                    digest="x", gen=4)
    ref = RefOracle(ref_idx, metrics_label=f"ref-{graph}")
    port = DistanceOracle(idx, metrics_label=f"port-{graph}")
    kinds = {}
    for s in range(n):
        for d in range(n):
            a, b = ref.consult(s, d), port.consult(s, d)
            if a is None:
                assert b is None, (s, d)
                kinds["miss"] = kinds.get("miss", 0) + 1
                continue
            assert (b.kind, b.lb, b.ub) == (a.kind, a.lb, a.ub), (s, d)
            kinds[a.kind] = kinds.get(a.kind, 0) + 1
            if a.result is None:
                assert b.result is None
            else:
                assert (b.result.found, b.result.hops, b.result.path) == (
                    a.result.found, a.result.hops, a.result.path)
    assert {k: v.value for k, v in port.cells.items()} == {
        k: v.value for k, v in ref.cells.items()}
    assert kinds.get("landmark") and kinds.get("bounds")
    if graph == "components":
        assert kinds.get("disconnected")
    with pytest.raises(ValueError, match="int16"):
        LandmarkIndex.from_arrays(n, ref_idx.landmarks,
                                  ref_idx.dist.astype(np.int32))


def test_repair_adds_equals_reference_and_rebuild():
    from bibfs_tpu.oracle.trees import LandmarkIndex as RefIndex
    from bibfs_tpu.oracle.trees import build_index as ref_build

    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.oracle import LandmarkIndex, build_index

    n, edges, (rp, ci) = _components(200, 7)
    base = ref_build(n, rp, ci, 10)
    ref_idx = RefIndex(n, base.landmarks, base.dist, gen=1)
    port_idx = LandmarkIndex.from_arrays(n, base.landmarks, base.dist, gen=1)
    rng = np.random.default_rng(8)
    have = {tuple(sorted(e)) for e in edges.tolist()}
    adds = []
    while len(adds) < 12:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        e = (min(u, v), max(u, v))
        if u != v and e not in have:
            have.add(e)
            adds.append(e)
    add_adj: dict = {}
    for u, v in adds:
        add_adj.setdefault(u, []).append(v)
        add_adj.setdefault(v, []).append(u)
    want = ref_idx.repair_adds(rp, ci, add_adj, adds, gen=5)
    got = port_idx.repair_adds(rp, ci, add_adj, adds, gen=5)
    np.testing.assert_array_equal(got.dist, want.dist)
    assert (got.gen, got.repaired_edges) == (want.gen, want.repaired_edges)
    rp2, ci2 = build_csr(n, np.concatenate([edges, np.array(adds)]))
    fresh = build_index(n, rp2, ci2, 10, landmarks=base.landmarks,
                        device="cpu")
    np.testing.assert_array_equal(got.dist, fresh.dist)


def test_cutoff_serial_solve_exact():
    """The oracle's upper bound seeds the serial search's meet bound: the
    hops equal an unseeded solve, and a stale (too small) cutoff is caught
    by the retry without it."""
    from bibfs_tpu_torch.oracle import DistanceOracle, build_index
    from bibfs_tpu_torch.serve.engine import _solve_serial_cutoff_checked
    from bibfs_tpu_torch.solvers.serial import solve_serial_csr

    n, _edges, (rp, ci) = _grid()
    orc = DistanceOracle(build_index(n, rp, ci, 4, device="host"),
                         metrics_label="cutoff")
    rng = np.random.default_rng(2)
    bounded = 0
    for s, d in rng.integers(0, n, size=(200, 2)):
        ans = orc.consult(int(s), int(d))
        want = solve_serial_csr(n, rp, ci, int(s), int(d))
        if ans is None or ans.kind != "bounds":
            continue
        bounded += 1
        got = _solve_serial_cutoff_checked(n, rp, ci, int(s), int(d), ans.ub)
        assert (got.found, got.hops) == (want.found, want.hops)
        assert got.edges_scanned <= want.edges_scanned
        if want.found and want.hops > 1:
            stale = _solve_serial_cutoff_checked(n, rp, ci, int(s), int(d),
                                                 want.hops - 1)
            assert (stale.found, stale.hops) == (True, want.hops)
            got.validate_path(n, _edges, int(s), int(d))
    assert bounded > 20


def test_oracle_metric_family_renders():
    """A store with an oracle renders every oracle family in both
    packages (the reference's store too, so the two registries mint the
    same families)."""
    from bibfs_tpu.obs.metrics import REGISTRY as REF
    from bibfs_tpu.obs.names import ORACLE_METRIC_FAMILIES
    from bibfs_tpu.store import GraphStore as RefStore

    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.store import GraphStore

    n, edges, _csr = _grid(6, 6)
    for registry, store in ((REF, RefStore(oracle_k=4)),
                            (REGISTRY, GraphStore(oracle_k=4, device="cpu"))):
        store.add("g", n, edges)
        assert store.wait_for_index("g", timeout=30)
        render = registry.render()
        for fam in ORACLE_METRIC_FAMILIES:
            assert fam in render, fam
        store.close()


@pytest.mark.cuda
@pytest.mark.parametrize("k", K_VALUES + (129, 200))
def test_cuda_level_and_sweep_equal_plain(k, monkeypatch):
    """On a card: one level of the sweep kernel equals its plain version on
    every output of a seeded mid-sweep state; a span of levels from the
    next state equals the level-range twin under the dense-pull rule,
    with every level pulled and with every level pushed; a whole sweep is
    one launch and one host read and equals the host sweep; a path deeper
    than the int16 range raises the reference's ValueError; every launch
    leaves the kernel's working block zero. K = 129 and 200 run the
    kernel's loops over more than one vector of words."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.ops import msbfs_device as md
    from bibfs_tpu_torch.oracle.trees import multi_source_bfs

    n, _edges, (rp, ci) = _grid(60, 50)
    src = np.random.default_rng(k).choice(n, size=k, replace=False)
    rpt = torch.from_numpy(rp)
    cit = torch.from_numpy(ci.astype(np.int32))
    reach, pending, dist = md.seed_state(n, torch.from_numpy(src))
    flag = torch.zeros(1, dtype=torch.int32)
    for lvl in range(1, 6):  # a mid-sweep state, built on the CPU
        pending = md.msbfs_level(rpt, cit, pending, reach, dist, lvl, flag)
    dev = torch.device("cuda")
    inputs = [t.to(dev) for t in (rpt, cit, pending, reach, dist)]
    flag.zero_()
    flag_d = torch.zeros(1, dtype=torch.int32, device=dev)
    before = md.msbfs_levels.launches
    nxt_d = md.msbfs_level(*inputs, 6, flag_d)
    torch.cuda.synchronize()
    assert md.msbfs_levels.launches == before + 1
    nxt = md.msbfs_level(rpt, cit, pending, reach, dist, 6, flag)
    assert torch.equal(nxt_d.cpu(), nxt)
    assert torch.equal(inputs[3].cpu(), reach)
    assert torch.equal(inputs[4].cpu(), dist)
    assert int(flag_d) == int(flag)
    with pytest.raises(ValueError, match="live"):  # the CPU loop's alone
        md.msbfs_level(*inputs, 6, flag_d, flag_d)
    # levels 7 .. 70 from that state: the range kernel against its twin
    want_r, want_d = reach.clone(), dist.clone()
    want_p, want_st = md.msbfs_levels(rpt, cit, nxt, want_r, want_d, 7, 70)
    assert want_st["run"] > 1
    for share, mode in ((md.DENSE_SHARE, None), (0.0, "dense"),
                        (2.0, "sparse")):
        monkeypatch.setattr(md, "DENSE_SHARE", share)
        rp_d, ci_d, p_d, r_d, d_d = (t.to(dev) for t in
                                     (rpt, cit, nxt, reach, dist))
        got_p, st = md.msbfs_levels(rp_d, ci_d, p_d, r_d, d_d, 7, 70)
        assert torch.equal(p_d.cpu(), nxt)  # the input is left as it was
        assert torch.equal(got_p.cpu(), want_p), mode
        assert torch.equal(r_d.cpu(), want_r), mode
        assert torch.equal(d_d.cpu(), want_d), mode
        assert (st["levels"], st["run"]) == (want_st["levels"],
                                             want_st["run"])
        assert st["dense_levels"] + st["sparse_levels"] == st["run"]
        if mode is not None:
            assert st[f"{mode}_levels"] == st["run"], (mode, st)
    monkeypatch.undo()
    # a whole sweep: one launch, one host read, the host sweep's plane
    want = multi_source_bfs(n, rp, ci, src)
    before = md.msbfs_levels.launches
    stats: dict = {}
    np.testing.assert_array_equal(
        md.msbfs_plane_csr(n, rp, ci, src, device="cuda", stats=stats), want)
    assert md.msbfs_levels.launches == before + 1
    assert (stats["launches"], stats["host_reads"]) == (1, 1)
    assert stats["levels"] == int(want.max())
    # a path deeper than the int16 range: raised, nothing stamped past it
    n_path = md.INT16_MAX + 40
    prp, pci = build_csr(n_path, np.stack([np.arange(n_path - 1),
                                           np.arange(1, n_path)], axis=1))
    prp_d, pci_d = md.upload_csr(prp, pci, dev)
    reach, pending, dist = md.seed_state(
        n_path, torch.arange(k, device=dev) % 3)
    with pytest.raises(ValueError, match="int16"):
        md.msbfs_levels(prp_d, pci_d, pending, reach, dist, 1,
                        md.INT16_MAX + 1)
    assert int(dist.min()) == -1 and int(dist.max()) == md.INT16_MAX
    assert not bool(md._ctl_block(dev).any())
    # no vertices: one launch of one block that runs no level
    reach, pending, dist = md.seed_state(0, torch.zeros(0, dtype=torch.int64,
                                                        device=dev))
    _p, st = md.msbfs_levels(prp_d[:1], pci_d[:0], pending, reach, dist, 1, 9)
    assert (st["levels"], st["run"], st["grid"]) == (0, 0, 1)
