"""The PyTorch port's blocked tile route below the engines
(``bibfs_tpu_torch.graph.blocked``, ``ops.blocked_expand`` and the blocked
search of ``solvers.dense``) against ``bibfs_tpu``'s on the CPU, on the
same seeded numpy inputs: the tiling (``tab``, ``bcol``, ``deg``, the
meta), the budgets and fit rule, one expansion level by level in both
plane types, the round's counts, degree sums, meet key and occupancy
flags (against numpy), the column-group map, the fold (against the JAX
body's ``[B]`` updates), the carried meet vote (against the JAX body's
full-plane vote, round by round), and the whole batch search's raw
outputs (best, meet, the dist planes, levels, edges) and paths, all
exactly (integers, tolerance 0). The CUDA kernels' tests carry the
``cuda`` marker and skip here."""

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
    pt = torch.from_numpy(plane)
    vec = _vectors(b, g.deg, live)
    out, _occ = tx.blocked_level(tab, bcol, torch.from_numpy(g.deg), pt, d,
                                 tx.plane_occupancy(pt), vec, 7, rc=rc)
    reach = (plane.astype(np.int64) @ _dense_adjacency(g).T) > 0  # [2b, n_pad]
    new = reach & (dist >= INF32) & np.tile(live, 2)[:, None].astype(bool)
    assert out.dtype == torch.float32
    assert np.array_equal(out.numpy(), new.astype(np.float32))
    assert np.array_equal(d.numpy(), np.where(new, 7, dist))


def _dense_adjacency(g):
    """The tiled table as a dense ``[n_pad, n_pad]`` int64 matrix."""
    a = np.zeros((g.n_pad, g.n_pad), dtype=np.int64)
    for bi in range(g.nblocks):
        for k in range(g.bwidth):
            bj = g.bcol[bi, k]
            if bj < g.nblocks:
                a[bi * 128:(bi + 1) * 128, bj * 128:(bj + 1) * 128] = g.tab[bi, k]
    return a


def _vectors(b, deg, live, seed=0):
    """A round's vectors (``ROUND_VECTORS``) for ``b`` queries with the
    given live mask and empty accumulators; best, meet, levels, edges and
    the current degree sums seeded."""
    import torch

    from bibfs_tpu_torch.ops import blocked_expand as tx

    rng = np.random.default_rng(seed)
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))  # noqa: E731
    live = i32(live)
    return dict(
        best=i32(np.where(rng.random(b) < 0.5, INF32, rng.integers(4, 30, b))),
        meet=i32(rng.integers(-1, len(deg), b)),
        levels=i32(rng.integers(0, 20, b)), edges=i32(rng.integers(0, 999, b)),
        live=live, any=live.amax(0, keepdim=True),
        scan_cur=i32(rng.integers(0, 99, 2 * b)),
        cnt=torch.zeros(2 * b, dtype=torch.int32),
        scan=torch.zeros(2 * b, dtype=torch.int32),
        key=torch.full((b,), tx.KEY_EMPTY, dtype=torch.int64))


def _np_occupancy(new, b):
    """Occupancy flags by the column-group map, in numpy."""
    nblocks = new.shape[1] // 128
    ng = -(-b // 32)
    occ = np.zeros((ng, nblocks), dtype=np.int32)
    for q in range(b):
        for side in (0, 1):
            blk = new[side * b + q].reshape(nblocks, 128).any(1)
            occ[q // 32] |= blk
    return occ


LIVE_KINDS = ["all", "none", "mixed"]


def _live(kind, b, rng):
    if kind == "all":
        return np.ones(b, dtype=np.int32)
    if kind == "none":
        return np.zeros(b, dtype=np.int32)
    return (rng.random(b) < 0.6).astype(np.int32)


@pytest.mark.parametrize("b", [1, 5, 37])
@pytest.mark.parametrize("live_kind", LIVE_KINDS)
def test_twin_counts_vote_and_flags_match_numpy(b, live_kind):
    """The twin's per-row counts and degree sums of the new frontier, the
    meet key (the lowest ``(d_s + d_t) << 32 | u`` over vertices new on
    either side with both sides reached) and the next plane's occupancy
    flags, against numpy on seeded random mid-search planes."""
    import torch

    from bibfs_tpu.graph import blocked as jb

    from bibfs_tpu_torch.ops import blocked_expand as tx

    n = 900
    g = jb.build_blocked(n, pairs=_pairs(n, gnp_random_graph(n, 10 / n,
                                                             seed=b)))
    rng = np.random.default_rng(100 + b)
    plane = (rng.random((2 * b, g.n_pad)) < 0.02).astype(np.float32)
    dist = np.where(rng.random((2 * b, g.n_pad)) < 0.5, INF32,
                    rng.integers(0, 5, size=(2 * b, g.n_pad))).astype(np.int32)
    live = _live(live_kind, b, rng)
    vec = _vectors(b, g.deg, live, seed=b)
    d = torch.from_numpy(dist.copy())
    pt = torch.from_numpy(plane)
    fr, occ = tx.blocked_level(torch.from_numpy(g.tab), torch.from_numpy(g.bcol),
                               torch.from_numpy(g.deg), pt, d,
                               tx.plane_occupancy(pt), vec, 5)
    reach = (plane.astype(np.int64) @ _dense_adjacency(g).T) > 0
    new = reach & (dist >= INF32) & np.tile(live, 2)[:, None].astype(bool)
    after = np.where(new, 5, dist)
    assert np.array_equal(fr.numpy() > 0, new)
    assert np.array_equal(vec["cnt"].numpy(), new.sum(1))
    assert np.array_equal(vec["scan"].numpy(), (new * g.deg).sum(1))
    key = np.full(b, tx.KEY_EMPTY, dtype=np.int64)
    for q in range(b):
        for u in np.flatnonzero(new[q] | new[b + q]):
            ds, dt = after[q, u], after[b + q, u]
            if ds < INF32 and dt < INF32:
                key[q] = min(key[q], (int(ds + dt) << 32) | int(u))
    assert np.array_equal(vec["key"].numpy(), key)
    assert occ.dtype == torch.int32
    assert np.array_equal(occ.numpy(), _np_occupancy(new, b))
    if live_kind == "none":
        assert not new.any() and not occ.numpy().any()


@pytest.mark.parametrize("b", [1, 5, 31, 32, 33, 37, 64, 100])
def test_group_rows_map(b):
    """Group g holds rows ``32g .. 32g + 31`` (source sides) and ``B + 32g
    .. B + 32g + 31`` (target sides), -1 past the last query; the flags of
    a plane follow that map."""
    import torch

    from bibfs_tpu_torch.ops import blocked_expand as tx

    ng = -(-b // 32)
    want = np.full((ng, 64), -1, dtype=np.int64)
    for g in range(ng):
        for i in range(32):
            q = 32 * g + i
            if q < b:
                want[g, i], want[g, 32 + i] = q, b + q
    got = tx.group_rows(b)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    plane = (np.random.default_rng(b).random((2 * b, 384)) < 0.004)
    occ = tx.plane_occupancy(torch.from_numpy(plane.astype(np.int8)))
    assert np.array_equal(occ.numpy(), _np_occupancy(plane, b))


@pytest.mark.parametrize("b", [1, 5, 37])
@pytest.mark.parametrize("seed", [0, 1])
def test_fold_plain_matches_reference_body_updates(b, seed):
    """``blocked_level_plain`` then ``blocked_fold_plain`` give the JAX
    body's ``[B]`` updates (best, meet, levels, edges and the next live
    mask) from one seeded mid-search state: random planes, dist, best
    (never above an old vertex's sum, as in a search), meet, levels, edges
    and round."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.graph import blocked as jb
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.ops import blocked_expand as tx

    n = 600
    g = jb.build_blocked(n, pairs=_pairs(n, gnp_random_graph(n, 8 / n,
                                                             seed=7 + seed)))
    rng = np.random.default_rng(1000 * seed + b)
    rnd = int(rng.integers(1, 6))
    plane = (rng.random((2 * b, g.n_pad)) < 0.03).astype(np.float32)
    dist = np.where(rng.random((2 * b, g.n_pad)) < 0.8, INF32,
                    rng.integers(0, rnd + 1, size=(2 * b, g.n_pad))).astype(np.int32)
    ds, dt = dist[:b], dist[b:]
    old = np.where((ds < INF32) & (dt < INF32), ds + dt, INF32).min(1)
    best = np.minimum(np.where(rng.random(b) < 0.5, INF32,
                               rng.integers(2, 20, b)), old).astype(np.int32)
    meet = rng.integers(-1, n, b).astype(np.int32)
    levels = rng.integers(0, 20, b).astype(np.int32)
    edges = rng.integers(0, 999, b).astype(np.int32)
    cnt_s = (plane[:b] > 0).sum(1).astype(np.int32)
    cnt_t = (plane[b:] > 0).sum(1).astype(np.int32)
    cnt_s[rng.random(b) < 0.2] = 0  # some queries with an empty side
    plane[:b][cnt_s == 0] = 0
    jst = dict(fr=jnp.asarray(plane.T), dist=jnp.asarray(dist.T),
               best=jnp.asarray(best), meet=jnp.asarray(meet),
               cnt_s=jnp.asarray(cnt_s), cnt_t=jnp.asarray(cnt_t),
               levels=jnp.asarray(levels), edges=jnp.asarray(edges),
               rnd=jnp.int32(rnd))
    live = np.asarray(jd._blocked_active(jst)).astype(np.int32)
    body = jd._make_blocked_body(jnp.asarray(g.tab), jnp.asarray(g.bcol),
                                 jnp.asarray(g.deg), b, g.nblocks)
    jout = body(jst)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    vec = dict(best=i32(best), meet=i32(meet), levels=i32(levels),
               edges=i32(edges), live=i32(live), any=i32(live.max(keepdims=True)),
               scan_cur=i32((plane > 0) @ g.deg),
               cnt=torch.zeros(2 * b, dtype=torch.int32),
               scan=torch.zeros(2 * b, dtype=torch.int32),
               key=torch.full((b,), tx.KEY_EMPTY, dtype=torch.int64))
    pt = torch.from_numpy(plane)
    tx.blocked_level_plain(torch.from_numpy(g.tab), torch.from_numpy(g.bcol),
                           torch.from_numpy(g.deg), pt,
                           torch.from_numpy(dist.copy()),
                           tx.plane_occupancy(pt), vec, rnd + 1)
    tx.blocked_fold_plain(vec, rnd + 1)
    for k in ("best", "meet", "levels", "edges"):
        assert np.array_equal(vec[k].numpy(), np.asarray(jout[k])), k
    nxt = np.asarray(jd._blocked_active(jout)).astype(np.int32)
    assert np.array_equal(vec["live"].numpy(), nxt)
    assert int(vec["any"][0]) == int(nxt.any())
    assert not vec["cnt"].any() and not vec["scan"].any()
    assert (vec["key"] == tx.KEY_EMPTY).all()


def test_fold_plain_takes_only_a_strictly_lower_vote():
    """The reference's ``take = mval < best``: a carried vote equal to best
    moves neither best nor meet, a lower one moves both, the empty key
    neither; the accumulators are reset."""
    import torch

    from bibfs_tpu_torch.ops import blocked_expand as tx

    vec = _vectors(3, np.zeros(128, np.int32), [1, 1, 1])
    vec["best"][:] = torch.tensor([5, 5, 5], dtype=torch.int32)
    vec["meet"][:] = torch.tensor([1, 1, 1], dtype=torch.int32)
    vec["key"][:] = torch.tensor([(5 << 32) | 7, (4 << 32) | 9, tx.KEY_EMPTY])
    vec["cnt"][:] = 1
    tx.blocked_fold_plain(vec, 3)
    assert vec["best"].tolist() == [5, 4, 5]
    assert vec["meet"].tolist() == [1, 9, 1]
    assert vec["live"].tolist() == [0, 0, 0]  # 2 * 3 >= best
    assert not vec["cnt"].any() and (vec["key"] == tx.KEY_EMPTY).all()


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_carried_vote_is_the_full_plane_vote(name, n, edges):
    """Round by round over a whole seeded trajectory, the port's body (the
    vote carried from the vertices new each round) and the JAX body (the
    full-plane vote) agree on best and meet, and on dist, levels, edges
    and the live mask."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.graph import blocked as jb
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    g = jb.build_blocked(n, pairs=_pairs(n, edges))
    qp = _query_mix(n, edges, seed=len(name) + 1)
    b = len(qp)
    srcs = torch.from_numpy(qp[:, 0].astype(np.int32))
    dsts = torch.from_numpy(qp[:, 1].astype(np.int32))
    tab, bcol, deg = (torch.from_numpy(a) for a in (g.tab, g.bcol, g.deg))
    st = td._blocked_state(srcs, dsts, deg, torch.float32)
    body = td._make_blocked_body(tab, bcol, deg, g.nblocks)
    jbody = jd._make_blocked_body(jnp.asarray(g.tab), jnp.asarray(g.bcol),
                                  jnp.asarray(g.deg), b, g.nblocks)
    jst = dict(fr=jnp.asarray(st["fr"].numpy().T),
               dist=jnp.asarray(st["dist"].numpy().T),
               best=jnp.asarray(st["best"].numpy()),
               meet=jnp.asarray(st["meet"].numpy()),
               cnt_s=jnp.ones(b, jnp.int32), cnt_t=jnp.ones(b, jnp.int32),
               levels=jnp.zeros(b, jnp.int32), edges=jnp.zeros(b, jnp.int32),
               rnd=jnp.int32(0))
    rounds = 0
    while bool(st["any"]):
        body(st)
        jst = jbody(jst)
        rounds += 1
        for k in ("best", "meet", "levels", "edges"):
            assert np.array_equal(st[k].numpy(), np.asarray(jst[k])), (rounds, k)
        assert np.array_equal(st["dist"].numpy().T, np.asarray(jst["dist"]))
        assert np.array_equal(st["live"].numpy() > 0,
                              np.asarray(jd._blocked_active(jst)))
    assert not bool(jnp.any(jd._blocked_active(jst)))
    assert rounds == int(st["rnd"])


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
    """The CUDA kernels equal their plain twins bit for bit on a seeded
    mid-search state, on a grid and a dense-ish graph: the next plane, the
    stamped dist, the occupancy flags, the counts, degree sums and meet
    key, then every vector of the fold; one launch counted per call."""
    import torch

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.ops import blocked_expand as tx

    rng = np.random.default_rng(b)
    for n, edges in ((64 * 64, grid_graph(64, 64, perforation=0.02, seed=3)),
                     (2000, gnp_random_graph(2000, 64 / 2000, seed=1))):
        g = build_blocked(n, edges)
        tab = torch.from_numpy(g.tab).to(cuda_device)
        bcol = torch.from_numpy(g.bcol).to(cuda_device)
        deg = torch.from_numpy(g.deg).to(cuda_device)
        plane = torch.from_numpy(
            (rng.random((2 * b, g.n_pad)) < 0.03).astype(np.int8)).to(cuda_device)
        dist = np.where(rng.random((2 * b, g.n_pad)) < 0.7, INF32,
                        rng.integers(0, 9, size=(2 * b, g.n_pad)))
        dist = torch.from_numpy(dist.astype(np.int32)).to(cuda_device)
        live = (rng.random(b) < 0.8).astype(np.int32)
        vec = {k: v.to(cuda_device)
               for k, v in _vectors(b, g.deg, live, seed=b).items()}
        vec_p = {k: v.clone() for k, v in vec.items()}
        occ = tx.plane_occupancy(plane)
        d_k, d_p = dist.clone(), dist.clone()
        before = (tx.blocked_level.launches, tx.blocked_fold.launches)
        out_k = tx.blocked_level(tab, bcol, deg, plane, d_k, occ, vec, 9)
        out_p = tx.blocked_level_plain(tab, bcol, deg, plane, d_p, occ, vec_p, 9)
        torch.cuda.synchronize()
        assert torch.equal(out_k[0], out_p[0]) and torch.equal(d_k, d_p)
        assert torch.equal(out_k[1], out_p[1])
        for k in ("cnt", "scan", "key"):
            assert torch.equal(vec[k], vec_p[k]), k
        tx.blocked_fold(vec, 9)
        tx.blocked_fold_plain(vec_p, 9)
        torch.cuda.synchronize()
        assert (tx.blocked_level.launches, tx.blocked_fold.launches) == (
            before[0] + 1, before[1] + 1)
        for k in tx.ROUND_VECTORS:
            assert torch.equal(vec[k], vec_p[k]), k


@pytest.mark.cuda
def test_cuda_blocked_round_wide_rows_and_many_queries(cuda_device):
    """The kernels on a table wider than 32 slots (the slot masks are
    taken 32 slots at a time) and on more queries than the fold's one
    block has threads (a ragged last group too), against the twins on
    every output, for three rounds of the search's own states."""
    import torch

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.ops import blocked_expand as tx
    from bibfs_tpu_torch.solvers import dense as td

    n = 6000
    g = build_blocked(n, gnp_random_graph(n, 40 / n, seed=11))
    assert g.bwidth > 32
    tab, bcol, deg = (torch.from_numpy(a).to(cuda_device)
                      for a in (g.tab, g.bcol, g.deg))
    qp = np.random.default_rng(5).integers(0, n, size=(1100, 2))
    st = td._blocked_state(torch.from_numpy(qp[:, 0].astype(np.int32)).to(cuda_device),
                           torch.from_numpy(qp[:, 1].astype(np.int32)).to(cuda_device),
                           deg, torch.int8)
    for lvl in range(1, 4):
        tw = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in st.items()}
        out_k = tx.blocked_level(tab, bcol, deg, st["fr"], st["dist"],
                                 st["occ"], st, lvl)
        out_p = tx.blocked_level_plain(tab, bcol, deg, tw["fr"], tw["dist"],
                                       tw["occ"], tw, lvl)
        torch.cuda.synchronize()
        assert torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[1], out_p[1])
        assert torch.equal(st["dist"], tw["dist"])
        tx.blocked_fold(st, lvl)
        tx.blocked_fold_plain(tw, lvl)
        torch.cuda.synchronize()
        for k in tx.ROUND_VECTORS:
            assert torch.equal(st[k], tw[k]), (lvl, k)
        st["fr"], st["occ"] = out_k


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
