"""The PyTorch port's blocked tile route below the engines
(``bibfs_tpu_torch.graph.blocked``, ``ops.blocked_expand`` and the blocked
search of ``solvers.dense``) against ``bibfs_tpu``'s on the CPU, on the
same seeded numpy inputs: the tiling (``tab``, ``bcol``, ``deg``, the
meta), the budgets and fit rule, one expansion level by level in both
plane types, and the whole batch search's raw outputs (best, meet, the
dist planes, levels, edges) and paths, all exactly (integers, tolerance
0). The CUDA kernel's tests carry the ``cuda`` marker and skip here."""

import numpy as np
import pytest

from bibfs_tpu.graph.generate import gnp_random_graph, grid_graph

CASES = [
    # (name, n, edges): the JAX package's own cases (tests/test_blocked.py):
    # n not a multiple of 128 throughout; the clustered case leaves whole
    # block rows empty (vertices 150.. are isolated)
    ("random", 300, gnp_random_graph(300, 6 / 300, seed=1)),
    ("dense-ish", 500, gnp_random_graph(500, 24 / 500, seed=2)),
    ("grid", 15 * 17, grid_graph(15, 17, perforation=0.1, seed=3)),
    ("disconnected", 400, gnp_random_graph(400, 0.8 / 400, seed=4)),
    ("empty-block-rows", 600, gnp_random_graph(150, 5 / 150, seed=5)),
    ("edgeless", 200, np.zeros((0, 2), dtype=np.int64)),
]
IDS = [c[0] for c in CASES]
INF32 = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _pairs(n, edges):
    from bibfs_tpu.graph.csr import canonical_pairs

    return canonical_pairs(n, edges)


def _query_mix(n, edges, seed):
    """Seeded pairs plus the edge cases: ``src == dst``, an unreachable
    pair where the graph has one, and the deepest pair from vertex 0 and
    from the last vertex (by the serial oracle)."""
    from bibfs_tpu.graph.csr import build_csr

    rng = np.random.default_rng(seed)
    qp = [list(p) for p in rng.integers(0, n, size=(20, 2))]
    qp += [[0, 0], [n - 1, n - 1]]
    row_ptr, col_ind = build_csr(n, pairs=_pairs(n, edges))
    for root in (0, n - 1):
        dist = np.full(n, -1)
        dist[root] = 0
        front = [root]
        while front:
            nxt = []
            for v in front:
                for u in col_ind[row_ptr[v]:row_ptr[v + 1]]:
                    if dist[u] < 0:
                        dist[u] = dist[v] + 1
                        nxt.append(int(u))
            front = nxt
        qp.append([root, int(np.argmax(dist))])  # the deepest pair
        far = np.flatnonzero(dist < 0)
        if far.size:
            qp.append([root, int(far[0])])  # unreachable
    return np.asarray(qp, dtype=np.int64)


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_build_blocked_matches_reference(name, n, edges):
    from bibfs_tpu.graph import blocked as jb

    from bibfs_tpu_torch.graph import blocked as tb

    pairs = _pairs(n, edges)
    gj = jb.build_blocked(n, pairs=pairs)
    gt = tb.build_blocked(n, edges)  # from raw edges: canonicalized here
    for f in ("n", "n_pad", "tile", "nblocks", "bwidth", "num_edges",
              "nnz_blocks", "tab_bytes", "block_density"):
        assert getattr(gt, f) == getattr(gj, f), f
    for f in ("tab", "bcol", "deg"):
        a, b = getattr(gt, f), getattr(gj, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert tb.blocked_meta(n, pairs) == jb.blocked_meta(n, pairs)
    assert tb.blocked_meta(n, pairs)[:2] == (gt.nblocks, gt.bwidth)
    assert tb.blocked_bucket_key(gt) == jb.blocked_bucket_key(gj)
    assert tb._tile_grid(n, 128) == jb._tile_grid(n, 128)


@pytest.mark.parametrize("itemsize", [1, 4])
def test_fits_and_chunk_rows_match_reference(itemsize):
    from bibfs_tpu.ops import blocked_expand as jx

    from bibfs_tpu_torch.ops import blocked_expand as tx

    assert tx.BLOCKED_CHUNK_BUDGET_BYTES == jx.BLOCKED_CHUNK_BUDGET_BYTES
    assert tx.BLOCKED_TAB_BUDGET_BYTES == jx.BLOCKED_TAB_BUDGET_BYTES
    for nblocks in (1, 8, 33, 1024, 4096, 16384):
        for bwidth in (1, 3, 8, 64, 4096):
            for b in (1, 37, 128, 256, 512, 2048):
                assert (tx.blocked_fits(nblocks, bwidth, b, itemsize)
                        == jx.blocked_fits(nblocks, bwidth, b, itemsize)), (
                    nblocks, bwidth, b)
                for c in (2, 2 * b):
                    assert (tx.chunk_block_rows(bwidth, c, itemsize)
                            == jx.chunk_block_rows(bwidth, c, itemsize))
    # the route's full fit on the card's grid: 3,070 live tiles of 1024
    # block rows, bwidth 3, at B = 256 and int8 planes
    assert tx.blocked_fits(1024, 3, 256, itemsize=1)


def test_resolve_plane_dtype():
    import torch

    from bibfs_tpu_torch.ops.blocked_expand import resolve_plane_dtype

    assert resolve_plane_dtype(None, "cpu") == torch.float32
    assert resolve_plane_dtype(None, torch.device("cuda")) == torch.int8
    assert resolve_plane_dtype("int8", "cpu") == torch.int8
    assert resolve_plane_dtype(torch.float32, "cuda") == torch.float32


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_expand_matches_reference_level_by_level(name, n, edges, dt):
    """One expansion of a two-column plane equals the JAX package's, round
    after round of a BFS from three seeds until it closes, and the numpy
    neighbour set."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.graph import blocked as jb
    from bibfs_tpu.ops import blocked_expand as jx

    from bibfs_tpu_torch.ops import blocked_expand as tx

    pairs = _pairs(n, edges)
    g = jb.build_blocked(n, pairs=pairs)
    adj = [[] for _ in range(n)]
    for u, v in pairs:
        adj[u].append(v)
    npdt = np.dtype(dt)
    rc = min(jx.chunk_block_rows(g.bwidth, 2, npdt.itemsize), g.nblocks)
    tab_j, bcol_j = jnp.asarray(g.tab), jnp.asarray(g.bcol)
    tab_t, bcol_t = torch.from_numpy(g.tab), torch.from_numpy(g.bcol)
    for seed in (0, n // 2, n - 1):
        frontier, visited = {seed}, {seed}
        for _round in range(n):
            fr = np.zeros((g.n_pad, 2), dtype=npdt)
            fr[list(frontier), 0] = 1
            want = np.asarray(jx.expand_blocked_plane(
                jnp.asarray(fr), tab_j, bcol_j, rc=rc))
            got = tx.expand_blocked_plane(torch.from_numpy(fr), tab_t, bcol_t,
                                          rc=rc).numpy()
            assert got.dtype == np.bool_ and np.array_equal(got, want)
            expect = set()
            for v in frontier:
                expect.update(adj[v])
            assert set(np.flatnonzero(got[:, 0])) == expect
            frontier = expect - visited
            if not frontier:
                break
            visited |= frontier


@pytest.mark.parametrize("rc", [1, 2, None])
def test_blocked_level_plain_is_the_body_stamp(rc):
    """The round op on query-major planes: reach by the expansion, then
    ``dist = lvl`` where reached, undiscovered and live, in place; the
    next plane is that mask. Chunked (``rc``) or whole, the same."""
    import torch

    from bibfs_tpu.graph import blocked as jb

    from bibfs_tpu_torch.ops import blocked_expand as tx

    n = 700
    edges = gnp_random_graph(n, 12 / n, seed=9)
    g = jb.build_blocked(n, pairs=_pairs(n, edges))
    rng = np.random.default_rng(3)
    b = 5
    plane = (rng.random((2 * b, g.n_pad)) < 0.05).astype(np.float32)
    dist = np.where(rng.random((2 * b, g.n_pad)) < 0.6, INF32,
                    rng.integers(0, 6, size=(2 * b, g.n_pad))).astype(np.int32)
    live = np.array([1, 0, 1, 1, 0], dtype=np.int32)
    tab, bcol = torch.from_numpy(g.tab), torch.from_numpy(g.bcol)
    d = torch.from_numpy(dist.copy())
    out = tx.blocked_level(tab, bcol, torch.from_numpy(plane), d,
                           torch.from_numpy(live), 7, rc=rc)
    a = np.zeros((g.n_pad, g.n_pad), dtype=np.int64)
    for bi in range(g.nblocks):
        for k in range(g.bwidth):
            bj = g.bcol[bi, k]
            if bj < g.nblocks:
                a[bi * 128:(bi + 1) * 128, bj * 128:(bj + 1) * 128] = g.tab[bi, k]
    reach = (plane.astype(np.int64) @ a.T) > 0  # [2b, n_pad]
    new = reach & (dist >= INF32) & np.tile(live, 2)[:, None].astype(bool)
    assert out.dtype == torch.float32
    assert np.array_equal(out.numpy(), new.astype(np.float32))
    assert np.array_equal(d.numpy(), np.where(new, 7, dist))


def _raw_batch(g, pairs, dt, batch_mod):
    _, thunk = batch_mod.blocked_batch_dispatch(g, pairs, dt=dt)
    return thunk()


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_blocked_batch_matches_reference(name, n, edges, dt):
    """The whole batch search: best, meet, both dist planes, levels and
    edges exactly equal to the JAX package's kernel; every result (paths
    included) equal to its ``solve_blocked_batch``, and to the serial
    oracle's hops, on a mix of seeded, ``src == dst``, unreachable and
    deepest pairs."""
    from bibfs_tpu.graph import blocked as jb
    from bibfs_tpu.graph.csr import build_csr
    from bibfs_tpu.solvers import batch_minor as jbm
    from bibfs_tpu.solvers import dense as jd
    from bibfs_tpu.solvers.serial import solve_serial_csr

    from bibfs_tpu_torch.graph import blocked as tb
    from bibfs_tpu_torch.solvers import batch_minor as tbm
    from bibfs_tpu_torch.solvers import dense as td

    pairs = _pairs(n, edges)
    csr = build_csr(n, pairs=pairs)
    gj = jd.BlockedDeviceGraph.from_host(jb.build_blocked(n, pairs=pairs))
    gt = td.BlockedDeviceGraph.from_host(tb.build_blocked(n, pairs=pairs),
                                         device="cpu")
    qp = _query_mix(n, edges, seed=len(name))
    want = [np.asarray(o) for o in _raw_batch(gj, qp, dt, jbm)]
    got = [o.numpy() for o in _raw_batch(gt, qp, dt, tbm)]
    for key, w, o in zip(("best", "meet", "dist", "levels", "edges"), want,
                         got):
        assert o.shape == w.shape and np.array_equal(o, w), key
    rj = jd.solve_blocked_batch(gj, qp, csr=csr, dt=dt)
    rt = td.solve_blocked_batch(gt, qp, csr=csr, dt=dt)
    for (s, d), a, b in zip(qp, rj, rt):
        assert (b.found, b.hops, b.path, b.meet, b.levels, b.edges_scanned) \
            == (a.found, a.hops, a.path, a.meet, a.levels, a.edges_scanned)
        assert b.mode == "blocked" and b.host_syncs > 0
        ref = solve_serial_csr(n, *csr, int(s), int(d))
        assert (b.found, b.hops) == (ref.found, ref.hops)


def test_blocked_single_query_and_range_check():
    from bibfs_tpu.graph.csr import build_csr
    from bibfs_tpu.solvers.serial import solve_serial_csr

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.solvers import dense as td

    n = 130  # one tile and 2 rows
    edges = gnp_random_graph(n, 4 / n, seed=7)
    pairs = _pairs(n, edges)
    csr = build_csr(n, pairs=pairs)
    g = td.BlockedDeviceGraph.from_host(build_blocked(n, pairs=pairs),
                                        device="cpu")
    ref = solve_serial_csr(n, *csr, 1, n - 1)
    res = td.solve_blocked_graph(g, 1, n - 1, csr=csr)
    assert (res.found, res.hops) == (ref.found, ref.hops)
    with pytest.raises(ValueError):
        td.solve_blocked_graph(g, 0, n, csr=csr)
    with pytest.raises(ValueError):
        td.solve_blocked_batch(g, [(0, 1), (-1, 2)], csr=csr)


def test_snapshot_memoizes_blocked_and_frees_on_retire():
    from bibfs_tpu_torch.store.snapshot import GraphSnapshot

    n = 200
    snap = GraphSnapshot.build(n, gnp_random_graph(n, 3 / n, seed=8))
    b1 = snap.blocked()
    assert snap.blocked() is b1  # memoized, shared by every consumer
    snap.release()
    assert snap._blocked is None  # retirement freed the table
    assert snap.blocked() is not b1  # built anew, not cached


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 37, 1])
def test_cuda_blocked_level_matches_plain(b, cuda_device):
    """The CUDA kernel equals its plain twin bit for bit on a seeded
    mid-search state (next plane and stamped dist), on a grid and a
    dense-ish graph, and counts one launch per call."""
    import torch

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.ops import blocked_expand as tx

    rng = np.random.default_rng(b)
    for n, edges in ((64 * 64, grid_graph(64, 64, perforation=0.02, seed=3)),
                     (2000, gnp_random_graph(2000, 64 / 2000, seed=1))):
        g = build_blocked(n, edges)
        tab = torch.from_numpy(g.tab).to(cuda_device)
        bcol = torch.from_numpy(g.bcol).to(cuda_device)
        plane = torch.from_numpy(
            (rng.random((2 * b, g.n_pad)) < 0.03).astype(np.int8)).to(cuda_device)
        dist = np.where(rng.random((2 * b, g.n_pad)) < 0.7, INF32,
                        rng.integers(0, 9, size=(2 * b, g.n_pad)))
        dist = torch.from_numpy(dist.astype(np.int32)).to(cuda_device)
        live = torch.from_numpy((rng.random(b) < 0.8).astype(np.int32)
                                ).to(cuda_device)
        d_k, d_p = dist.clone(), dist.clone()
        before = tx.blocked_level.launches
        out_k = tx.blocked_level(tab, bcol, plane, d_k, live, 9)
        out_p = tx.blocked_level_plain(tab, bcol, plane, d_p, live, 9)
        torch.cuda.synchronize()
        assert tx.blocked_level.launches == before + 1
        assert torch.equal(out_k, out_p) and torch.equal(d_k, d_p)


@pytest.mark.cuda
def test_cuda_blocked_batch_matches_cpu(cuda_device):
    """The batch on the card (the kernel every round) equals the batch on
    the CPU (the twin, float32 planes) on every raw output."""
    import torch

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.solvers import batch_minor as tbm
    from bibfs_tpu_torch.solvers import dense as td

    n = 64 * 64
    edges = grid_graph(64, 64, perforation=0.02, seed=3)
    bg = build_blocked(n, edges)
    qp = np.random.default_rng(2).integers(0, n, size=(150, 2))
    out = []
    for dev in ("cpu", cuda_device):
        g = td.BlockedDeviceGraph.from_host(bg, device=dev)
        out.append([o.cpu() for o in tbm.blocked_batch_dispatch(g, qp)[1]()])
    for a, b in zip(*out):
        assert torch.equal(a, b)
