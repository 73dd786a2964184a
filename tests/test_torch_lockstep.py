"""The PyTorch port's lock-step batch of the per-query modes
(``bibfs_tpu_torch.solvers.dense_batch``, the batched level code of
``ops/expand_batch.py`` and kernels 3 and 4 with a query axis) against
the reference's vmapped batch (``bibfs_tpu.solvers.dense`` under
``solve_batch_graph`` / ``_batch_dispatch``) on the CPU: the raw outputs
exactly (best, meet, both parent rows on the live columns, levels,
edges) and the results (found, hops, path), on random and tiered graphs
with batches that mix a ``src == dst`` query, an unreachable pair, a
1-hop pair and the graph's deepest pair, so finished queries freeze while
others run; the batched plain twins of kernels 3 and 4 against
``jax.vmap`` of the reference's Pallas pull kernels in interpret mode,
on a query-packed plane at ragged batch sizes, and the plane's packer,
seeder and rebuild; the host reads of a batch; forced multi-chunk
gathers. On a CUDA card
only, the batched kernels against their twins."""

import numpy as np
import pytest

INF32 = 1 << 30
MODES = ["sync", "sync_unfused", "alt", "beamer", "beamer_alt", "pallas",
         "pallas_alt", "fused", "fused_alt"]
ROUTED = {"fused": "pallas", "fused_alt": "pallas_alt"}


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


def _np(x):
    import torch

    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hops_from(n, edges, src):
    """BFS distances from ``src`` over the undirected ``edges`` (-1 where
    unreached)."""
    adj = [[] for _ in range(n)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    dist = np.full(n, -1)
    dist[src] = 0
    frontier = [src]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    nxt.append(v)
        frontier = nxt
    return dist


def _freeze_mix(n, edges, seed):
    """Pairs that finish at different rounds: ``src == dst``, a pair to an
    unreachable vertex, a 1-hop pair, the deepest pair found by a double
    sweep, and seeded random pairs."""
    rng = np.random.default_rng(seed)
    a = int(edges[0][0])
    far = _hops_from(n, edges, a)
    u = int(np.argmax(far))
    from_u = _hops_from(n, edges, u)
    v = int(np.argmax(from_u))
    unreached = np.flatnonzero(from_u < 0)
    assert unreached.size and from_u[v] >= 4, "the case needs both"
    pairs = [(a, a), (u, int(unreached[0])), (a, int(edges[0][1])), (u, v),
             (v, u)]
    pairs += [tuple(int(x) for x in p) for p in rng.integers(0, n, (3, 2))]
    return np.array(pairs, dtype=np.int64)


def _gnp_case():
    from bibfs_tpu.graph.generate import gnp_random_graph

    n = 200
    edges = gnp_random_graph(n - 1, 3.0 / n, seed=3)  # vertex n - 1 isolated
    return n, edges, "ell"


def _rmat_case():
    from bibfs_tpu.graph.generate import rmat_graph

    n, edges = rmat_graph(8, edge_factor=6, seed=2)
    return n, edges, "tiered"


CASES = {"gnp-200": _gnp_case, "rmat-8-tiered": _rmat_case}


def _graphs(n, edges, layout):
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    return (jd.DeviceGraph.build(n, edges, layout=layout),
            td.DeviceGraph.build(n, edges, layout=layout, device="cpu"))


def _raw(dense_mod, g, pairs, mode, **kw):
    _, thunk, finish = dense_mod._batch_dispatch(g, pairs, mode, **kw)
    return finish(thunk())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_lockstep_matches_reference(case, mode):
    """Every lock-step mode equals the reference's vmapped batch: the raw
    outputs (both parent rows on the live columns included) and the
    results, with finished queries frozen while the deepest pair runs."""
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    n, edges, layout = CASES[case]()
    gj, gt = _graphs(n, edges, layout)
    if layout == "tiered":
        assert gt.tier_meta, "the case must have hub tiers"
    pairs = _freeze_mix(n, edges, seed=7)
    b = len(pairs)
    stats = {"host_syncs": 0}
    for x, y in zip(_raw(jd, gj, pairs, mode), _raw(td, gt, pairs, mode,
                                                    stats=stats)):
        x, y = _np(x), _np(y)
        assert x.shape[0] == y.shape[0] == b
        if x.ndim == 2:
            x, y = x[:, :n], y[:, :n]
        assert np.array_equal(x, y)
    assert stats["mode"] == ROUTED.get(mode, mode)
    res_j = jd.solve_batch_graph(gj, pairs, mode=mode)
    res_t = td.solve_batch_graph(gt, pairs, mode=mode)
    for x, y in zip(res_j, res_t):
        assert (x.found, x.hops, x.path, x.meet, x.levels, x.edges_scanned) == (
            y.found, y.hops, y.path, y.meet, y.levels, y.edges_scanned)
    assert res_t[0].hops == 0 and not res_t[1].found and res_t[2].hops == 1
    assert res_t[3].hops >= 4


@pytest.mark.parametrize("mode", ["sync", "alt", "beamer", "pallas",
                                  "pallas_alt"])
def test_each_query_is_its_single_search(mode):
    """Each query's raw outputs equal its single-query search's exactly
    (the frozen ones included), and the batch reads the host once per
    round plus once at the end: as often as its deepest query alone,
    and fewer times than its queries one by one."""
    import torch

    from bibfs_tpu_torch.solvers import dense as td

    n, edges, layout = _gnp_case()
    g = td.DeviceGraph.build(n, edges, layout=layout, device="cpu")
    pairs = _freeze_mix(n, edges, seed=11)
    stats = {"host_syncs": 0}
    out = _raw(td, g, pairs, mode, stats=stats)
    reads = []
    for i, (s, d) in enumerate(pairs):
        one_stats = {"host_syncs": 0}
        one = td._run(g, int(s), int(d), mode, 1, one_stats)
        reads.append(one_stats["host_syncs"])
        assert (int(out[0][i]), int(out[1][i]), int(out[4][i]),
                int(out[5][i])) == (one[0], one[1], one[4], one[5])
        assert torch.equal(out[2][i], one[2]) and torch.equal(out[3][i], one[3])
    assert stats["host_syncs"] == max(reads)
    assert stats["host_syncs"] < sum(reads)
    res = td.solve_batch_graph(g, pairs, mode=mode)
    assert {r.host_syncs for r in res} == {max(reads)}


def test_empty_batch():
    from bibfs_tpu_torch.solvers import dense as td

    n, edges, layout = _gnp_case()
    g = td.DeviceGraph.build(n, edges, layout=layout, device="cpu")
    out = _raw(td, g, np.zeros((0, 2), np.int64), "sync")
    assert [tuple(o.shape) for o in out] == [(0,), (0,), (0, g.n_pad),
                                             (0, g.n_pad), (0,), (0,)]
    assert td.solve_batch_graph(g, [], mode="pallas") == []


@pytest.mark.parametrize("mode", ["sync", "beamer_alt", "pallas_alt"])
def test_forced_chunks_match(mode, monkeypatch):
    """A gather budget of a few rows walks the table and each hub tier in
    many chunks: the same outputs as one chunk."""
    from bibfs_tpu_torch.ops import expand_batch as xb
    from bibfs_tpu_torch.solvers import dense as td

    n, edges, layout = _rmat_case()
    g = td.DeviceGraph.build(n, edges, layout=layout, device="cpu")
    pairs = _freeze_mix(n, edges, seed=13)
    want = _raw(td, g, pairs, mode)
    monkeypatch.setattr(xb, "LOCKSTEP_BUDGET_BYTES", 4096)
    assert xb.chunk_rows(g.width, len(pairs)) < g.n_pad // 8
    for x, y in zip(_raw(td, g, pairs, mode), want):
        assert np.array_equal(_np(x), _np(y))


def _pull_state(n, seed, b):
    """A seeded batch of mid-search rows over G(n, 3/n): per side ``[B,
    n_pad]`` frontier and visited rows, plus the port's table. Query 0's
    two sides are equal, as a ``src == dst`` query's are."""
    import torch

    from bibfs_tpu_torch.graph.csr import build_ell
    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.ops import pull_expand as tpe

    rng = np.random.default_rng(seed)
    g = build_ell(n, gnp_random_graph(n, 3.0 / n, seed=seed))
    fr = rng.random((2, b, g.n_pad)) < 0.05
    vis = (rng.random((2, b, g.n_pad)) < 0.3) | fr
    fr[1, 0], vis[1, 0] = fr[0, 0], vis[0, 0]
    fr[:, :, n:] = False
    vis[:, :, n:] = False
    (tt,) = tpe.prepare_pallas_tables(torch.as_tensor(g.nbr),
                                      torch.as_tensor(g.deg))
    return g, fr, vis, tt


def _listed(rng, b):
    """A seeded ascending set of listed queries (query 0 always, some
    others left out) and a side per listed query."""
    qids = np.flatnonzero((rng.random(b) < 0.7) | (np.arange(b) == 0))
    return qids, rng.random(qids.size) < 0.5


@pytest.mark.parametrize("n,seed,b", [
    pytest.param(300, 1, 5, id="300-1"),
    pytest.param(1_001, 2, 5, id="1001-2"),
    pytest.param(300, 3, 1, id="300-3-b1"),
    pytest.param(1_001, 4, 17, id="1001-4-b17"),
    pytest.param(300, 5, 37, id="300-5-b37"),
])
def test_batched_twins_match_vmapped_pallas(n, seed, b):
    """Kernels 3 and 4 with a query axis (plain twins) on a query-packed
    plane: each listed query's next frontier exactly and its parent where
    that is set, as ``jax.vmap`` of the reference's ``run_pull`` /
    ``run_pull_dual`` (interpret mode) gives them, kernel 4 on each listed
    query's side; the next plane is the packed rows with the expanded
    (query, side) rows replaced by ``nf`` and every other bit copied."""
    import jax
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops import pallas_expand as jpe

    from bibfs_tpu_torch.ops import pull_expand as tpe

    g, fr, vis, tt = _pull_state(n, seed, b)
    (jt,) = jpe.prepare_pallas_tables(jnp.asarray(g.nbr), jnp.asarray(g.deg))
    qids, side = _listed(np.random.default_rng(seed + 100), b)
    plane = tpe.pack_plane(torch.as_tensor(fr[0]), torch.as_tensor(fr[1]))
    assert plane.shape == (g.n_pad, -(-b // 16))
    q_t = torch.as_tensor(qids)
    deg = tpe.live_slots(tt)

    def check(nf_j, pc_j, nf_t, pc_t):
        nf_j, pc_j, nf_t, pc_t = (_np(x) for x in (nf_j, pc_j, nf_t, pc_t))
        assert nf_t.shape == pc_t.shape == (qids.size, g.n_pad)
        for i in range(qids.size):
            assert np.array_equal(nf_j[i], nf_t[i])
            assert np.array_equal(pc_j[i][nf_t[i]], pc_t[i][nf_t[i]])
            assert (pc_t[i][~nf_t[i]] == -1).all()

    def next_plane(rows, nfs):
        want = rows.copy()
        for sd, i, nf in nfs:
            want[sd, qids[i]] = _np(nf)
        return tpe.pack_plane(torch.as_tensor(want[0]), torch.as_tensor(want[1]))

    sel = (np.where(side[:, None], fr[1, qids], fr[0, qids]),
           np.where(side[:, None], vis[1, qids], vis[0, qids]))
    nf_j, pc_j = jax.vmap(lambda a, c: jpe.run_pull((jt,), a, c))(
        jnp.asarray(sel[0]), jnp.asarray(sel[1]))
    nf, pc, nxt = tpe.pull_single_batch(
        tt, deg, plane, torch.as_tensor(vis[0, qids]),
        torch.as_tensor(vis[1, qids]), q_t, torch.as_tensor(side))
    check(nf_j, pc_j, nf, pc)
    assert torch.equal(nxt, next_plane(
        fr, [(int(sd), i, nf[i]) for i, sd in enumerate(side)]))

    outs_j = jax.vmap(lambda a, c, d, e: jpe.run_pull_dual((jt,), a, c, d, e))(
        *(jnp.asarray(x[qids]) for x in (fr[0], fr[1], vis[0], vis[1])))
    outs_t = tpe.pull_dual_batch(
        tt, deg, plane, torch.as_tensor(vis[0, qids]),
        torch.as_tensor(vis[1, qids]), q_t)
    check(outs_j[0], outs_j[1], outs_t[0], outs_t[1])
    check(outs_j[2], outs_j[3], outs_t[2], outs_t[3])
    assert torch.equal(outs_t[4], next_plane(
        fr, [(sd, i, outs_t[2 * sd][i]) for i in range(qids.size)
             for sd in (0, 1)]))


@pytest.mark.parametrize("n,b", [(1, 1), (31, 16), (300, 17), (1_001, 37)])
def test_pack_plane_matches_per_query_columns(n, b):
    """The plane holds query ``q``'s sides at bits ``2 (q & 15)`` and
    ``2 (q & 15) + 1`` of word ``q >> 4`` (the batch-minor pair-row order),
    the spare bits of a ragged last word zero."""
    import torch

    from bibfs_tpu_torch.ops import pull_expand as tpe

    rng = np.random.default_rng(n + b)
    fr = torch.as_tensor(rng.random((2, b, n)) < 0.3)
    plane = tpe.pack_plane(fr[0], fr[1])
    assert plane.shape == (n, tpe.plane_words(b)) and plane.dtype == torch.int32
    words = plane.numpy().astype(np.uint32)
    for q in range(16 * plane.shape[1]):
        col = words[:, q >> 4] >> np.uint32(2 * (q & 15))
        for side in (0, 1):
            bits = ((col >> np.uint32(side)) & 1).astype(bool)
            assert np.array_equal(bits, fr[side, q].numpy() if q < b
                                  else np.zeros(n, bool))


@pytest.mark.parametrize("n,b", [(1, 1), (31, 5), (64, 17), (1_001, 37)])
def test_seed_plane_packs_the_starting_frontiers(n, b):
    """The kernel modes' starting plane equals the packed one-hot rows,
    with ``src == dst`` queries and the top bit of a word (query 15) among
    the seeds."""
    import torch

    from bibfs_tpu_torch.ops import pull_expand as tpe

    rng = np.random.default_rng(n * b)
    srcs = torch.as_tensor(rng.integers(0, n, b))
    dsts = torch.as_tensor(rng.integers(0, n, b))
    dsts[0] = srcs[0]
    q = torch.arange(b)
    fr = torch.zeros(2, b, n, dtype=torch.bool)
    fr[0, q, srcs] = True
    fr[1, q, dsts] = True
    assert torch.equal(tpe.seed_plane(srcs, dsts, n), tpe.pack_plane(fr[0], fr[1]))


@pytest.mark.parametrize("b,one", [(1, False), (37, False), (256, False),
                                   (256, True)])
def test_launch_meta_lists_rows_words_and_sides(b, one):
    """The host-made launch metadata of the CUDA kernels: the slot map
    gives each listed query its row and every other query -1, the listed
    words are the distinct words of the listed queries in order (the
    grid's width), and the sides follow."""
    import torch

    from bibfs_tpu_torch.ops import pull_expand as tpe

    qids, side = _listed(np.random.default_rng(b), b)
    if one:
        qids, side = qids[-1:], side[-1:]
    words = tpe.plane_words(b)
    for sd in (None, torch.as_tensor(side)):
        meta, n_listed = tpe.launch_meta(torch.as_tensor(qids), words, sd)
        meta = meta.numpy()
        assert meta.dtype == np.int32
        slot = np.full(16 * words, -1)
        slot[qids] = np.arange(qids.size)
        listed = np.unique(qids >> 4)
        assert n_listed == listed.size
        assert np.array_equal(meta[:16 * words], slot)
        assert np.array_equal(meta[16 * words:16 * words + n_listed], listed)
        rest = meta[16 * words + n_listed:]
        assert np.array_equal(rest, side.astype(np.int32) if sd is not None
                              else np.zeros(0, np.int32))


@pytest.mark.parametrize("budget", [None, 64])
@pytest.mark.parametrize("b", [1, 17, 37])
def test_plane_set_rebuilds_listed_columns(b, budget, monkeypatch):
    """The tiered rounds' rebuild: one side's bits of the listed queries
    replaced by their rows, every other bit (the other side, unlisted
    queries, spare bits) kept, in one chunk or in many."""
    import torch

    from bibfs_tpu_torch.ops import pull_expand as tpe

    if budget is not None:
        monkeypatch.setattr(tpe, "LOCKSTEP_BUDGET_BYTES", budget)
    rng = np.random.default_rng(b)
    n = 203
    fr = rng.random((2, b, n)) < 0.4
    qids, _ = _listed(rng, b)
    rows = rng.random((qids.size, n)) < 0.4
    for side in (0, 1):
        plane = tpe.pack_plane(torch.as_tensor(fr[0]), torch.as_tensor(fr[1]))
        tpe.plane_set(plane, torch.as_tensor(qids), torch.as_tensor(rows), side)
        want = fr.copy()
        want[side, qids] = rows
        assert torch.equal(plane, tpe.pack_plane(torch.as_tensor(want[0]),
                                                 torch.as_tensor(want[1])))


def test_flatnonzero_rows():
    import torch

    from bibfs_tpu_torch.ops import expand_batch as xb
    from bibfs_tpu_torch.solvers.dense import _flatnonzero

    rng = np.random.default_rng(4)
    fr = torch.as_tensor(rng.random((4, 50)) < np.array([0, 0.05, 0.5, 1])[:, None])
    for k in (1, 3, 64):
        got = xb.flatnonzero(fr, k)
        for q in range(4):
            assert torch.equal(got[q], _flatnonzero(fr[q], k))


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,one", [(3_001, 6, False), (20_000, 6, False),
                                     (3_001, 37, False), (3_001, 40, True)])
def test_cuda_batched_pull_matches_plain(n, b, one, cuda_device):
    """On a card: kernels 3 and 4 with a query axis against their plain
    twins on a plane with unlisted queries (one listed query among 40:
    the plane copy and a one-word grid), exactly, with the launch
    counters moving."""
    import torch

    from bibfs_tpu_torch.ops import pull_expand as pe

    g, fr, vis, tt = _pull_state(n, 3, b)
    dev = cuda_device
    tt = tt.to(dev)
    deg = torch.as_tensor(g.deg).to(dev)
    qids, side = _listed(np.random.default_rng(b), b)
    if one:
        qids, side = qids[-1:], side[-1:]
    q = torch.as_tensor(qids)
    plane = pe.pack_plane(torch.as_tensor(fr[0]), torch.as_tensor(fr[1])).to(dev)
    v = [torch.as_tensor(vis[s, qids]).to(dev) for s in (0, 1)]
    args1 = (tt, deg, plane, v[0], v[1], q, torch.as_tensor(side))
    args3 = (tt, deg, plane, v[0], v[1], q)
    before = (pe.pull_single_batch.launches, pe.pull_dual_batch.launches)
    for x, y in zip(pe.pull_single_batch(*args1), pe.pull_single_batch_plain(*args1)):
        assert torch.equal(x, y)
    for x, y in zip(pe.pull_dual_batch(*args3), pe.pull_dual_batch_plain(*args3)):
        assert torch.equal(x, y)
    assert (pe.pull_single_batch.launches, pe.pull_dual_batch.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sync", "beamer_alt", "pallas", "pallas_alt"])
def test_cuda_lockstep_matches_cpu(mode, cuda_device):
    """On a card: a lock-step batch's raw outputs equal the CPU's."""
    from bibfs_tpu_torch.graph.generate import rmat_graph
    from bibfs_tpu_torch.solvers import dense as td

    n, edges = rmat_graph(10, edge_factor=8, seed=4)
    pairs = np.random.default_rng(5).integers(0, n, (16, 2))
    pairs[0, 1] = pairs[0, 0]
    outs = []
    for dev in ("cpu", cuda_device):
        g = td.DeviceGraph.build(n, edges, layout="tiered", device=dev)
        outs.append([_np(o.cpu()) for o in _raw(td, g, pairs, mode)])
    for x, y in zip(*outs):
        assert np.array_equal(x, y)
