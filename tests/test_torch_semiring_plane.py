"""The port's semiring planes (``bibfs_tpu_torch.ops.semiring_plane``,
``graph.blocked.build_blocked_weights``, ``ops.msbfs_device.
msbfs_plane_blocked``) against the JAX package's on the CPU, on the same
seeded inputs: the weight table byte for byte; the two tile products and
the fixpoints' planes bit for bit with the same rounds (integer-valued
data, exact in float32); the triangle chunks' counts exactly; the packed
tile rows word for word against ``np.packbits``, and the twins over the
table unpacked from them; the K-source blocked sweep's int16 plane
exactly; PageRank's ranks within 1e-6 (float sums in another order) with
the same iterations, or one off where the JAX package's last delta lies
within 1e-7 of the tolerance (the two sides straddle it). The graphs:
G(150, 8 / 150) (n not a tile multiple), two components, an empty graph
and a 20x20 grid; the packed rows also on G(2000, 8 / 2000) with a hub of
1,500 neighbours. The kernels of ``csrc/semiring.cu`` against their twins
need the card (``cuda`` marker, skipped here), there also on wider
tables and hub rows (:data:`WIDE`)."""

import numpy as np
import pytest

#: PageRank ranks: float32 sums in another order than XLA's
RANK_TOL = 1e-6
#: how near the tolerance a last delta must lie for one iteration more or
#: less to be the other side of it
STRADDLE = 1e-7


def _graphs():
    from bibfs_tpu_torch.graph.generate import gnp_random_graph, grid_graph

    two = np.concatenate([gnp_random_graph(70, 10 / 70, seed=4),
                          70 + gnp_random_graph(80, 9 / 80, seed=5)])
    return {
        "gnp150": (150, gnp_random_graph(150, 8 / 150, seed=21)),
        "two": (150, two),
        "empty": (150, np.zeros((0, 2), dtype=np.int64)),
        "grid20": (400, grid_graph(20, 20)),
    }


def _hub_edges(n, p, seed, hub):
    """G(n, p) with vertex 0 joined to ``hub`` other vertices besides."""
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    edges = gnp_random_graph(n, p, seed=seed)
    if not hub:
        return edges
    far = np.random.default_rng(seed).choice(np.arange(1, n), size=hub,
                                             replace=False)
    star = np.stack([np.zeros(hub, dtype=far.dtype), far], axis=1)
    return np.concatenate([edges, star.astype(edges.dtype)])


GRAPHS = _graphs()
NAMES = tuple(GRAPHS)
#: a hub row of 1,500 neighbours: more columns than a PageRank warp lists
#: at once (512) in one 128-slot group
HUB = {"hub2000": (2000, _hub_edges(2000, 8 / 2000, 47, 1500))}
#: the ping-pong hazard of the (min, +) worklist: the one edge (5, 130)
#: lowers block row 1 at sweep 0 (130 takes 5's label or distance) while
#: block row 0, the only one it reads, stands still; so at sweep 1 block
#: row 1 is on the worklist only because it changed, and it must still
#: write its value into the other buffer. "hazard" ends after 2 sweeps,
#: "hazard_path" after 40 (a path 260 .. 299 in block row 2): both an even
#: count, so the result lies in the buffer a worklist without the changed
#: rows would leave stale.
HAZARD = {"hazard": (300, np.array([[5, 130]])),
          "hazard_path": (300, np.array([[5, 130]] + [[v, v + 1] for v in
                                                     range(260, 299)]))}


def _blocked(name):
    from bibfs_tpu.graph.blocked import build_blocked as ref_build

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.graph.csr import canonical_pairs

    n, edges = {**GRAPHS, **HUB, **HAZARD}[name]
    pairs = canonical_pairs(n, edges)
    return n, pairs, build_blocked(n, pairs=pairs), ref_build(n, pairs=pairs)


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _j(a):
    import jax.numpy as jnp

    return jnp.asarray(np.array(a))


def _same(a, b) -> bool:
    """Two CPU tensors equal bit for bit."""
    return np.array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", NAMES)
def test_weight_table_byte_for_byte(name, seed):
    from bibfs_tpu.graph.blocked import build_blocked_weights as ref_w

    from bibfs_tpu_torch.graph.blocked import build_blocked_weights

    _n, pairs, bg, rg = _blocked(name)
    got = build_blocked_weights(bg, pairs, seed=seed)
    want = ref_w(rg, pairs, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def _planes(n_pad, c, seed):
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 4, size=(n_pad, c)).astype(np.float32)
    # float values with +inf holes: the (min, +) sums round alike
    floats = rng.random((n_pad, c), dtype=np.float32) * 50
    floats[rng.random((n_pad, c)) < 0.3] = np.inf
    return ints, floats


@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("name", NAMES)
def test_tile_products_equal_jax(name, c):
    from bibfs_tpu.graph.blocked import build_blocked_weights as ref_w
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, pairs, bg, rg = _blocked(name)
    ints, floats = _planes(bg.n_pad, c, c)
    for rc in (1, bg.nblocks):
        got = port.plustimes_plane(_t(ints), _t(bg.tab), _t(bg.bcol), rc=rc)
        want = ref.plustimes_plane(_j(ints), _j(rg.tab), _j(rg.bcol), rc=rc)
        assert np.array_equal(got.numpy(), np.asarray(want))
        got = port.minplus_plane(_t(floats), _t(bg.tab), _t(bg.bcol), rc=rc,
                                 from_tab=True)
        want = ref.minplus_plane(_j(floats), _j(rg.tab), _j(rg.bcol), rc=rc,
                                 from_tab=True)
        assert np.array_equal(got.numpy(), np.asarray(want))
        wtab = ref_w(rg, pairs, seed=2)
        got = port.minplus_plane(_t(floats), _t(wtab), _t(bg.bcol), rc=rc,
                                 from_tab=False)
        want = ref.minplus_plane(_j(floats), _j(wtab), _j(rg.bcol), rc=rc,
                                 from_tab=False)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert port.minplus_chunk_rows(bg.bwidth, c) == ref.minplus_chunk_rows(
        rg.bwidth, c)


def _sssp_init(n, n_pad, c, seed):
    srcs = np.random.default_rng(seed).choice(n, size=c, replace=False)
    init = np.full((n_pad, c), np.inf, dtype=np.float32)
    init[srcs, np.arange(c)] = 0.0
    return init


@pytest.mark.parametrize("name", NAMES)
def test_sssp_blocked_exact_rounds_equal(name):
    from bibfs_tpu.graph.blocked import build_blocked_weights as ref_w
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.graph.blocked import build_blocked_weights
    from bibfs_tpu_torch.ops import semiring_plane as port

    n, pairs, bg, rg = _blocked(name)
    for seed, c in ((0, 3), (1, 1)):
        init = _sssp_init(n, bg.n_pad, c, seed)
        before = port.minplus_fixpoint.launches
        got, rounds = port.sssp_blocked(
            _t(build_blocked_weights(bg, pairs, seed=seed)), _t(bg.bcol),
            _t(init))
        assert port.minplus_fixpoint.launches == before  # the CPU twin
        want, want_rounds = ref.sssp_blocked(
            _j(ref_w(rg, pairs, seed=seed)), _j(rg.bcol), _j(init))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert rounds == int(want_rounds)


@pytest.mark.parametrize("name", NAMES)
def test_components_blocked_exact_rounds_equal(name):
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, _pairs, bg, rg = _blocked(name)
    init = np.arange(bg.n_pad, dtype=np.float32)[:, None]
    got, rounds = port.components_blocked(_t(bg.tab), _t(bg.bcol), _t(init))
    want, want_rounds = ref.components_blocked(_j(rg.tab), _j(rg.bcol),
                                               _j(init))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)


def test_fixpoint_round_cap_like_jax():
    """A cap below the fixpoint stops both after exactly that many
    sweeps, on the same plane."""
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, _pairs, bg, rg = _blocked("grid20")
    init = np.arange(bg.n_pad, dtype=np.float32)[:, None]
    got, rounds = port.minplus_fixpoint_plain(
        _t(bg.tab), _t(bg.bcol), _t(init), from_tab=True, max_rounds=5)
    kern = ref._get_minplus_fixpoint(
        rg.nblocks, rg.bwidth, 1, ref.minplus_chunk_rows(rg.bwidth, 1), 128,
        True, 5)
    want, want_rounds = kern(_j(rg.tab), _j(rg.bcol), _j(init))
    assert rounds == int(want_rounds) == 5
    assert np.array_equal(got.numpy(), np.asarray(want))


def _iters_agree(iters, want_iters, want_delta, tol) -> bool:
    """Equal, or one off where the JAX package's last delta lies within
    :data:`STRADDLE` of the tolerance the two sides resolve."""
    tol_eff = max(float(tol), 5e-7)
    if iters == want_iters:
        return True
    return abs(iters - want_iters) == 1 and abs(want_delta - tol_eff) <= STRADDLE


@pytest.mark.parametrize("tol,max_iters", [(1e-8, 100), (1e-4, 100),
                                           (1e-8, 7)])
@pytest.mark.parametrize("name", NAMES)
def test_pagerank_blocked_within_tolerance(name, tol, max_iters):
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _pairs, bg, rg = _blocked(name)
    kw = dict(n=n, damping=0.85, tol=tol, max_iters=max_iters)
    ranks, iters, delta = port.pagerank_blocked(_t(bg.tab), _t(bg.bcol),
                                                _t(bg.deg), **kw)
    want, want_iters, want_delta = ref.pagerank_blocked(
        _j(rg.tab), _j(rg.bcol), _j(rg.deg), **kw)
    assert np.max(np.abs(ranks.numpy() - np.asarray(want))) <= RANK_TOL
    assert _iters_agree(iters, int(want_iters), float(want_delta), tol)
    assert iters <= max_iters
    assert abs(delta - float(want_delta)) <= RANK_TOL


def _jax_chunk_plane(n, n_pad, pairs, c0):
    """The reference route's host-built chunk plane (its
    ``TrianglesBlockedRoute``)."""
    from bibfs_tpu.graph.csr import build_csr

    rp, ci = build_csr(n, pairs=pairs)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    c1 = min(n, c0 + 256)
    plane = np.zeros((n_pad, 256), np.float32)
    m = (ci >= c0) & (ci < c1)
    plane[src[m], ci[m] - c0] = 1.0
    return plane


@pytest.mark.parametrize("name", NAMES)
def test_triangle_chunks_exact(name):
    import torch

    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.analytics.semiring import ref_triangles_intersect
    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.ops import semiring_plane as port

    n, pairs, bg, rg = _blocked(name)
    total = torch.zeros(1, dtype=torch.int64)
    want_total = 0
    for c0 in range(0, n, 256):
        plane = _jax_chunk_plane(n, bg.n_pad, pairs, c0)
        assert np.array_equal(
            port.triangle_plane(_t(bg.tab), _t(bg.bcol), c0).numpy(), plane)
        got = port.triangles_chunk_blocked(_t(bg.tab), _t(bg.bcol), c0)
        want = int(ref.triangles_chunk_blocked(_j(rg.tab), _j(rg.bcol),
                                               _j(plane)))
        assert int(got) == want
        port.triangles_chunk_blocked(_t(bg.tab), _t(bg.bcol), c0, total)
        want_total += want
    assert int(total) == want_total
    rp, ci = build_csr(n, pairs=pairs)
    assert want_total // 6 == ref_triangles_intersect(n, rp, ci)
    with pytest.raises(ValueError, match="multiple"):
        port.triangles_chunk_blocked(_t(bg.tab), _t(bg.bcol), 3)


@pytest.mark.parametrize("k", [1, 5, 9])
@pytest.mark.parametrize("name", NAMES)
def test_msbfs_plane_blocked_exact(name, k):
    from bibfs_tpu.ops import msbfs_device as ref_ms
    from bibfs_tpu.solvers.dense import BlockedDeviceGraph as RefGraph

    from bibfs_tpu_torch.ops import msbfs_device as port_ms
    from bibfs_tpu_torch.solvers.dense import BlockedDeviceGraph

    n, _pairs, bg, rg = _blocked(name)
    srcs = np.random.default_rng(k).choice(n, size=k, replace=False)
    got = port_ms.msbfs_plane_blocked(BlockedDeviceGraph.from_host(
        bg, device="cpu"), srcs)
    want = ref_ms.msbfs_plane_blocked(RefGraph.from_host(rg), srcs)
    assert got.dtype == np.int16 and np.array_equal(got, want)


def test_msbfs_plane_blocked_edges():
    from bibfs_tpu_torch.ops import msbfs_device as port_ms
    from bibfs_tpu_torch.solvers.dense import BlockedDeviceGraph

    _n, _pairs, bg, _rg = _blocked("gnp150")
    g = BlockedDeviceGraph.from_host(bg, device="cpu")
    assert port_ms.msbfs_plane_blocked(g, []).shape == (150, 0)
    with pytest.raises(ValueError, match="out of range"):
        port_ms.msbfs_plane_blocked(g, [150])


# ---- the (min, +) worklist --------------------------------------------------

WORKLIST_NAMES = NAMES + tuple(HAZARD)


def _wtab(name, seed):
    from bibfs_tpu.graph.blocked import build_blocked_weights as ref_w

    from bibfs_tpu_torch.graph.blocked import build_blocked_weights

    _n, pairs, bg, rg = _blocked(name)
    return build_blocked_weights(bg, pairs, seed=seed), ref_w(rg, pairs,
                                                              seed=seed)


def _hazard_init(name, n, n_pad, c, seed):
    """SSSP sources: on the hazard graphs vertex 5 (the edge's end in block
    row 0) is the first."""
    init = _sssp_init(n, n_pad, c, seed)
    if name in HAZARD:
        init[:, 0] = np.inf
        init[5, 0] = 0.0
    return init


@pytest.mark.parametrize("c", [1, 3, 13])
@pytest.mark.parametrize("name", WORKLIST_NAMES)
def test_worklist_twin_sssp_equals_jax(name, c):
    """The worklist sweeps' planes bit for bit and rounds equal the JAX
    package's SSSP fixpoint and the plain twin's."""
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _pairs, bg, rg = _blocked(name)
    got_w, want_w = _wtab(name, c)
    init = _hazard_init(name, n, bg.n_pad, c, c)
    got, rounds, sweeps = port.minplus_fixpoint_worklist(
        _t(got_w), _t(bg.bcol), _t(init), from_tab=False)
    want, want_rounds = ref.sssp_blocked(_j(want_w), _j(rg.bcol), _j(init))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds) == len(sweeps)
    plain, plain_rounds = port.minplus_fixpoint_plain(
        _t(got_w), _t(bg.bcol), _t(init), from_tab=False)
    assert _same(got, plain) and rounds == plain_rounds
    assert len(sweeps[0]) == bg.nblocks  # sweep 0 takes every block row


@pytest.mark.parametrize("name", WORKLIST_NAMES)
def test_worklist_twin_labels_equal_jax(name):
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, _pairs, bg, rg = _blocked(name)
    init = np.arange(bg.n_pad, dtype=np.float32)[:, None]
    got, rounds, sweeps = port.minplus_fixpoint_worklist(
        _t(bg.tab), _t(bg.bcol), _t(init), from_tab=True)
    want, want_rounds = ref.components_blocked(_j(rg.tab), _j(rg.bcol),
                                               _j(init))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds) == len(sweeps)


def _sweeps_without_changed_rows(table, bcol, init, from_tab):
    """The worklist sweeps WITHOUT the changed block rows themselves (only
    the rows that read one): the ping-pong fault the kernel must not
    have."""
    import torch

    from bibfs_tpu_torch.ops.semiring_plane import (
        minplus_chunk_rows,
        minplus_plane,
    )

    nblocks, bwidth = bcol.shape
    bufs = [init.clone(), torch.full_like(init, float("nan"))]
    bc = bcol.numpy()
    act, rounds = np.arange(nblocks), 0
    rc = minplus_chunk_rows(bwidth, init.shape[1])
    while act.size:
        d, nd = bufs[rounds & 1], bufs[(rounds + 1) & 1]
        rows = torch.as_tensor(act)
        idx = (rows[:, None] * 128 + torch.arange(128)).reshape(-1)
        new = torch.minimum(d[idx], minplus_plane(
            d, table[rows], bcol[rows], rc=rc, from_tab=from_tab))
        lowered = (new < d[idx]).reshape(act.size, -1).any(dim=1).numpy()
        nd[idx] = new
        rounds += 1
        act = np.flatnonzero(np.isin(bc, act[lowered]).any(axis=1))
    return bufs[rounds & 1], rounds


@pytest.mark.parametrize("name", tuple(HAZARD))
def test_worklist_keeps_rows_that_changed_and_stand_still(name):
    """The hazard graphs: block row 1 changes at sweep 0 and none of its
    inputs does, so sweep 1's worklist holds it only as a changed row; the
    twin (which keeps it) equals the JAX package on labels and SSSP, and
    the same sweeps without the changed rows would not (the case bites)."""
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _pairs, bg, rg = _blocked(name)
    bcol = _t(bg.bcol)
    assert list(bg.bcol[1][bg.bcol[1] < bg.nblocks]) == [0]
    labels = np.arange(bg.n_pad, dtype=np.float32)[:, None]
    w, want_w = _wtab(name, 0)
    for table, ref_table, init, from_tab in (
            (_t(bg.tab), rg.tab, labels, True),
            (_t(w), want_w, _hazard_init(name, n, bg.n_pad, 1, 0), False)):
        got, rounds, sweeps = port.minplus_fixpoint_worklist(
            table, bcol, _t(init), from_tab=from_tab)
        kern = ref._get_minplus_fixpoint(
            rg.nblocks, rg.bwidth, 1, ref.minplus_chunk_rows(rg.bwidth, 1),
            128, from_tab, rg.n_pad)
        want, want_rounds = kern(_j(ref_table), _j(rg.bcol), _j(init))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert rounds == int(want_rounds) and rounds % 2 == 0
        assert 1 in sweeps[1]  # on the worklist: it changed at sweep 0
        stale, stale_rounds = _sweeps_without_changed_rows(
            table, bcol, _t(init), from_tab)
        assert stale_rounds == rounds
        assert not np.array_equal(stale.numpy(), np.asarray(want))


@pytest.mark.parametrize("from_tab", [True, False])
def test_worklist_round_cap_like_jax(from_tab):
    """A cap of 5 below the fixpoint stops the worklist sweeps after
    exactly 5, on the JAX package's plane."""
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _pairs, bg, rg = _blocked("grid20")
    w, want_w = _wtab("grid20", 0)
    if from_tab:
        table, ref_table = _t(bg.tab), rg.tab
        init = np.arange(bg.n_pad, dtype=np.float32)[:, None]
    else:
        table, ref_table = _t(w), want_w
        init = _sssp_init(n, bg.n_pad, 2, 0)
    c = init.shape[1]
    got, rounds, sweeps = port.minplus_fixpoint_worklist(
        table, _t(bg.bcol), _t(init), from_tab=from_tab, max_rounds=5)
    kern = ref._get_minplus_fixpoint(
        rg.nblocks, rg.bwidth, c, ref.minplus_chunk_rows(rg.bwidth, c), 128,
        from_tab, 5)
    want, want_rounds = kern(_j(ref_table), _j(rg.bcol), _j(init))
    assert rounds == int(want_rounds) == len(sweeps) == 5
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", WORKLIST_NAMES + tuple(HUB))
def test_packed_rows_set_where_weights_are_finite(name, seed):
    """The kernel lists SSSP's edges from the adjacency's packed rows and
    reads their weights: the unpacked rows are set exactly where the
    seeded weight table (the JAX package's, byte for byte) is finite."""
    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, _pairs, bg, _rg = _blocked(name)
    w, want_w = _wtab(name, seed)
    assert w.tobytes() == want_w.tobytes()
    back = port.unpack_tile_rows(port.pack_tile_rows(_t(bg.tab))).numpy()
    assert np.array_equal(back != 0, np.isfinite(w))


@pytest.mark.parametrize("name", WORKLIST_NAMES)
def test_bits_entry_points_give_jax_answers(name):
    """``sssp_blocked`` and ``components_blocked`` given the packed rows
    (checked, then the CPU twin) answer as the JAX package does."""
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _pairs, bg, rg = _blocked(name)
    bits = port.pack_tile_rows(_t(bg.tab))
    w, want_w = _wtab(name, 1)
    init = _hazard_init(name, n, bg.n_pad, 4, 1)
    before = port.minplus_fixpoint.launches
    got, rounds = port.sssp_blocked(_t(w), _t(bg.bcol), _t(init), bits=bits)
    want, want_rounds = ref.sssp_blocked(_j(want_w), _j(rg.bcol), _j(init))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)
    labels = np.arange(bg.n_pad, dtype=np.float32)[:, None]
    got, rounds = port.components_blocked(_t(bg.tab), _t(bg.bcol),
                                          _t(labels), bits=bits)
    want, want_rounds = ref.components_blocked(_j(rg.tab), _j(rg.bcol),
                                               _j(labels))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)
    assert port.minplus_fixpoint.launches == before  # the CPU twin


def test_worklist_counts_by_hand():
    """The lane groups, the one-block / grid split and the needed bytes of
    the hazard graph's label sweeps, counted by hand: 3 block rows of 1-2
    live slots; sweep 0 all three (every slot's packed rows, the plane rows
    of all three read and written), sweep 1 block rows 0 and 1 (1 has
    changed, 0 reads it)."""
    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, _pairs, bg, _rg = _blocked("hazard")
    labels = np.arange(bg.n_pad, dtype=np.float32)[:, None]
    _plane, rounds, sweeps = port.minplus_fixpoint_worklist(
        _t(bg.tab), _t(bg.bcol), _t(labels), from_tab=True)
    assert rounds == 2
    assert [list(a) for a in sweeps] == [[0, 1, 2], [0, 1]]
    live = (bg.bcol < bg.nblocks).sum(axis=1)
    assert list(live) == [1, 1, 0]
    want = (2 * 128 * 16 + (3 + 3) * 128 * 4) + (2 * 128 * 16
                                                 + (2 + 2) * 128 * 4)
    assert port.minplus_needed_bytes(_t(bg.tab), _t(bg.bcol), sweeps, 1,
                                     from_tab=True) == want
    w, _ = _wtab("hazard", 0)
    # SSSP adds a 32-byte sector an edge of the active block rows: the two
    # directions of (5, 130), in both sweeps
    assert port.minplus_needed_bytes(_t(w), _t(bg.bcol), sweeps, 1,
                                     from_tab=False) == want + 2 * 32 + 2 * 32
    assert [port.minplus_group(b) for b in (1, 3, 4, 5, 40, 79, 157)] == [
        1, 1, 1, 2, 16, 32, 32]
    assert port.minplus_sweep_modes(3, sweeps) == (2, 0)
    assert port.minplus_sweep_modes(79, sweeps) == (0, 2)
    assert port.minplus_group(13) == 4  # 512 lanes a block row
    assert port.MINPLUS_SOLO_ROUNDS * port.MINPLUS_THREADS == 512
    assert port.minplus_sweep_modes(13, [np.arange(1), np.arange(2)]) == (
        1, 1)


# ---- the packed tile rows ----------------------------------------------------

@pytest.mark.parametrize("name", NAMES + tuple(HUB))
def test_pack_tile_rows_twin_is_packbits(name):
    """The pack's twin is ``np.packbits(tab, bitorder="little")`` read as
    little-endian 32-bit words, word for word; sentinel slots pack to zero;
    unpacking gives back the table; on the CPU the wrapper runs the twin
    (no launch counted)."""
    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, _pairs, bg, _rg = _blocked(name)
    before = port.pack_tile_rows.launches
    bits = port.pack_tile_rows(_t(bg.tab))
    assert port.pack_tile_rows.launches == before
    want = np.packbits(bg.tab, axis=-1, bitorder="little")
    want = np.ascontiguousarray(want).view("<u4").astype(np.int64)
    assert bits.dtype.itemsize == 4 and tuple(bits.shape) == (
        bg.nblocks, bg.bwidth, 128, 4)
    got = bits.numpy().astype(np.int64) & 0xFFFFFFFF
    assert np.array_equal(got, want)
    assert np.array_equal(port.pack_tile_rows_plain(_t(bg.tab)).numpy(),
                          bits.numpy())
    assert bits.permute(0, 2, 1, 3).is_contiguous()  # stored slot-minor
    sentinel = bg.bcol >= bg.nblocks
    assert not bits.numpy()[sentinel].any()
    back = port.unpack_tile_rows(bits)
    assert back.dtype == _t(bg.tab).dtype
    assert np.array_equal(back.numpy(), bg.tab)


@pytest.mark.parametrize("name", NAMES + tuple(HUB))
def test_twins_on_the_unpacked_table_give_jax_answers(name):
    """The PageRank and triangle twins, fed the table unpacked from the
    packed rows (and given the rows), answer as the JAX package does on
    the original table: ranks within :data:`RANK_TOL`, iterations equal
    or one off at a straddled tolerance, every chunk's count exactly."""
    from bibfs_tpu.ops import semiring_plane as ref

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, pairs, bg, rg = _blocked(name)
    bits = port.pack_tile_rows(_t(bg.tab))
    tab = port.unpack_tile_rows(bits)
    kw = dict(n=n, damping=0.85, tol=1e-8, max_iters=100)
    ranks, iters, _ = port.pagerank_blocked(tab, _t(bg.bcol), _t(bg.deg),
                                            bits=bits, **kw)
    want, want_iters, want_delta = ref.pagerank_blocked(
        _j(rg.tab), _j(rg.bcol), _j(rg.deg), **kw)
    assert np.max(np.abs(ranks.numpy() - np.asarray(want))) <= RANK_TOL
    assert _iters_agree(iters, int(want_iters), float(want_delta), 1e-8)
    for c0 in range(0, n, 256):
        got = port.triangles_chunk_blocked(tab, _t(bg.bcol), c0, bits=bits)
        plane = _jax_chunk_plane(n, bg.n_pad, pairs, c0)
        assert int(got) == int(ref.triangles_chunk_blocked(
            _j(rg.tab), _j(rg.bcol), _j(plane)))


def _bad_bits(kind, bg):
    import torch

    good = (bg.nblocks, bg.bwidth, 128, 4)
    if kind == "shape":
        return torch.zeros((bg.nblocks, bg.bwidth, 128, 16), dtype=torch.int32)
    if kind == "rows":
        return torch.zeros((bg.nblocks, bg.bwidth + 1, 128, 4),
                           dtype=torch.int32)
    if kind == "dtype":
        return torch.zeros(good, dtype=torch.uint8)
    if kind == "strided":
        return torch.zeros((*good[:3], 8), dtype=torch.int32)[..., ::2]
    if kind == "slot-major":  # the right words, not stored slot-minor
        return torch.zeros(good, dtype=torch.int32)
    return np.zeros(good, dtype=np.int32)  # not a tensor


@pytest.mark.parametrize("kind", ["shape", "rows", "dtype", "strided",
                                  "slot-major", "numpy"])
def test_wrappers_refuse_bits_of_the_wrong_shape_or_type(kind):
    """Every wrapper that takes packed rows (PageRank, triangles, the (min,
    +) fixpoint and its two entry points) refuses rows that are not the
    table's (shape, type, the slot-minor layout), on the CPU as on the
    card, before any work; the twin's packing is accepted."""
    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _pairs, bg, _rg = _blocked("gnp150")
    bits = _bad_bits(kind, bg)
    with pytest.raises(ValueError):
        port.pagerank_blocked(_t(bg.tab), _t(bg.bcol), _t(bg.deg), n=n,
                              damping=0.85, tol=1e-8, max_iters=5, bits=bits)
    with pytest.raises(ValueError):
        port.triangles_chunk_blocked(_t(bg.tab), _t(bg.bcol), 0, bits=bits)
    labels = _t(np.arange(bg.n_pad, dtype=np.float32)[:, None])
    w = _t(_wtab("gnp150", 0)[0])
    before = port.minplus_fixpoint.launches
    with pytest.raises(ValueError):
        port.components_blocked(_t(bg.tab), _t(bg.bcol), labels, bits=bits)
    with pytest.raises(ValueError):
        port.sssp_blocked(w, _t(bg.bcol), _t(_sssp_init(n, bg.n_pad, 2, 0)),
                          bits=bits)
    with pytest.raises(ValueError):
        port.minplus_fixpoint(_t(bg.tab), _t(bg.bcol), labels, from_tab=True,
                              max_rounds=3, bits=bits)
    assert port.minplus_fixpoint.launches == before
    with pytest.raises(ValueError, match="128, 128"):
        port.pack_tile_rows(_t(bg.tab)[..., :64])
    good = port.pack_tile_rows(_t(bg.tab))
    assert good.permute(0, 2, 1, 3).is_contiguous()
    port.triangles_chunk_blocked(_t(bg.tab), _t(bg.bcol), 0, bits=good)
    port.components_blocked(_t(bg.tab), _t(bg.bcol), labels, bits=good)


# ---- the kernels against their twins, on the card --------------------------

def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_graph(name):
    import torch

    from bibfs_tpu_torch.graph.blocked import build_blocked_weights

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.graph.csr import canonical_pairs

    dev = _card()
    n, edges = GRAPHS[name]
    pairs = canonical_pairs(n, edges)
    bg = build_blocked(n, pairs=pairs)  # the port's alone: no JAX on a card
    put = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    w = put(build_blocked_weights(bg, pairs, seed=1))
    return n, bg, put(bg.tab), put(bg.bcol), put(bg.deg), w


def _minplus_on_card(port, table, bcol, init, bits, *, from_tab,
                     max_rounds=None):
    """One launch of the (min, +) kernel against the plain twin (plane bit
    for bit, rounds) and the worklist twin (its sweeps' one-block / grid
    split and active block rows, from the status words); the kernel's
    working words are its own. Returns the status."""
    import torch

    nblocks = bcol.shape[0]
    before = port.minplus_fixpoint.launches
    got, rounds = port.minplus_fixpoint(table, bcol, init, from_tab=from_tab,
                                        max_rounds=max_rounds, bits=bits)
    assert port.minplus_fixpoint.launches == before + 1
    want, want_rounds = port.minplus_fixpoint_plain(
        table, bcol, init, from_tab=from_tab, max_rounds=max_rounds)
    assert torch.equal(got, want) and rounds == want_rounds
    planes, status = port._minplus_launch(
        bits, None if from_tab else table, bcol, init,
        max_rounds=max_rounds or nblocks * 128)
    got_rounds, solo, grid, active = status.tolist()
    _plane, wl_rounds, sweeps = port.minplus_fixpoint_worklist(
        table, bcol, init, from_tab=from_tab, max_rounds=max_rounds)
    assert torch.equal(planes[got_rounds & 1], want)
    assert got_rounds == wl_rounds == rounds
    assert (solo, grid) == port.minplus_sweep_modes(bcol.shape[1], sweeps)
    assert active == sum(len(a) for a in sweeps)
    return status.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4, 8, 13])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_minplus_fixpoint_equals_twin(name, c):
    """The (min, +) kernel over the packed rows against its twins: SSSP at
    C = 1, 4, 8, 13, labels, a cap of 2 sweeps; without the packed rows the
    wrapper raises on the card."""
    import torch

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, bg, tab, bcol, _deg, w = _card_graph(name)
    bits = port.pack_tile_rows(tab)
    init = torch.from_numpy(_sssp_init(n, bg.n_pad, c, c)).to(tab.device)
    before = port.minplus_fixpoint.launches
    got, rounds = port.sssp_blocked(w, bcol, init, bits=bits)
    assert port.minplus_fixpoint.launches == before + 1
    want, want_rounds = port.minplus_fixpoint_plain(w, bcol, init,
                                                    from_tab=False)
    assert torch.equal(got, want) and rounds == want_rounds
    _minplus_on_card(port, w, bcol, init, bits, from_tab=False)
    labels = torch.arange(bg.n_pad, dtype=torch.float32,
                          device=tab.device)[:, None]
    got, rounds = port.components_blocked(tab, bcol, labels, bits=bits)
    want, want_rounds = port.minplus_fixpoint_plain(tab, bcol, labels,
                                                    from_tab=True)
    assert torch.equal(got, want) and rounds == want_rounds
    _minplus_on_card(port, tab, bcol, labels, bits, from_tab=True,
                     max_rounds=2)
    with pytest.raises(ValueError, match="bits"):
        port.components_blocked(tab, bcol, labels)
    assert port.minplus_fixpoint.launches == before + 6  # two a comparison


def _path_into_lattice(path: int, width: int, height: int) -> tuple:
    """A path 0 .. path - 1 whose end joins corner 0 of a width x height
    lattice (ids from ``path``, row-major): every block row reads at most
    its two neighbours, so a lane takes a row alone."""
    from bibfs_tpu_torch.graph.generate import grid_graph

    edges = np.concatenate([
        np.array([[v, v + 1] for v in range(path)]),
        path + grid_graph(width, height)])
    return path + width * height, edges


@pytest.mark.cuda
def test_cuda_minplus_grid_to_one_block_and_back():
    """SSSP from the end of a 300-vertex path into a 128 x 64 lattice:
    sweep 0 on the grid (every block row), the wavefront along the path in
    one block, the grid again once the front spans more block rows than
    one block's passes hold, then one block as it narrows; labels too. Both
    equal the twins, split as the worklist twin says."""
    import torch

    from bibfs_tpu_torch.graph.blocked import build_blocked, build_blocked_weights
    from bibfs_tpu_torch.graph.csr import canonical_pairs
    from bibfs_tpu_torch.ops import semiring_plane as port

    dev = _card()
    n, edges = _path_into_lattice(300, 128, 64)
    pairs = canonical_pairs(n, edges)
    bg = build_blocked(n, pairs=pairs)
    assert port.minplus_group(bg.bwidth) == 1
    put = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    tab, bcol = put(bg.tab), put(bg.bcol)
    bits = port.pack_tile_rows(tab)
    w = put(build_blocked_weights(bg, pairs, seed=2))
    init = np.full((bg.n_pad, 1), np.inf, np.float32)
    init[0, 0] = 0.0
    rounds, solo, grid, _active = _minplus_on_card(
        port, w, bcol, put(init), bits, from_tab=False)
    assert solo > 0 and grid > 1 and rounds == solo + grid
    _plane, _r, sweeps = port.minplus_fixpoint_worklist(
        w, bcol, put(init), from_tab=False)
    cap = port.MINPLUS_SOLO_ROUNDS * port.MINPLUS_THREADS
    wide = [len(a) * 128 > cap for a in sweeps]
    back = [i for i in range(2, len(wide)) if wide[i] and not wide[i - 1]]
    assert wide[0] and not wide[1] and back
    labels = put(np.arange(bg.n_pad, dtype=np.float32)[:, None])
    _minplus_on_card(port, tab, bcol, labels, bits, from_tab=True)


def test_path_into_lattice_sweeps_change_mode():
    """The card test's graph on the CPU: the worklist twin equals the plain
    twin, and its sweeps go from the grid to one block and back by the
    kernel's rule (so the card test sees both transitions)."""
    from bibfs_tpu_torch.graph.blocked import build_blocked, build_blocked_weights
    from bibfs_tpu_torch.graph.csr import canonical_pairs
    from bibfs_tpu_torch.ops import semiring_plane as port

    n, edges = _path_into_lattice(300, 128, 64)
    pairs = canonical_pairs(n, edges)
    bg = build_blocked(n, pairs=pairs)
    assert port.minplus_group(bg.bwidth) == 1
    w = _t(build_blocked_weights(bg, pairs, seed=2))
    init = np.full((bg.n_pad, 1), np.inf, np.float32)
    init[0, 0] = 0.0
    got, rounds, sweeps = port.minplus_fixpoint_worklist(
        w, _t(bg.bcol), _t(init), from_tab=False)
    cap = port.MINPLUS_SOLO_ROUNDS * port.MINPLUS_THREADS
    wide = [len(a) * 128 > cap for a in sweeps]
    assert wide[0] and not wide[1]
    assert any(wide[i] and not wide[i - 1] for i in range(2, len(wide)))
    solo, grid = port.minplus_sweep_modes(bg.bwidth, sweeps)
    assert solo == wide.count(False) and grid == wide.count(True) > 1
    want, want_rounds = port.minplus_fixpoint_plain(
        w, _t(bg.bcol), _t(init), from_tab=False)
    assert np.array_equal(got.numpy(), want.numpy()) and rounds == want_rounds


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-8, 1e-4])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_pagerank_equals_twin(name, tol):
    import torch

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _bg, tab, bcol, deg, _w = _card_graph(name)
    kw = dict(n=n, damping=0.85, tol=tol, max_iters=100)
    ranks, iters, delta = port.pagerank_blocked(tab, bcol, deg, **kw)
    again, iters2, _ = port.pagerank_blocked(tab, bcol, deg, **kw)
    assert torch.equal(ranks, again) and iters == iters2  # run to run
    want, want_iters, want_delta = port.pagerank_blocked_plain(
        tab, bcol, deg, **kw)
    assert float((ranks - want).abs().max()) <= RANK_TOL
    assert _iters_agree(iters, want_iters, want_delta, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_tricount_equals_twin(name):
    import torch

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _bg, tab, bcol, _deg, _w = _card_graph(name)
    for c0 in range(0, n, 256):
        before = port.triangles_chunk_blocked.launches
        got = port.triangles_chunk_blocked(tab, bcol, c0)
        assert port.triangles_chunk_blocked.launches == before + 1
        want = port.triangles_chunk_blocked_plain(tab, bcol, c0)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_pack_equals_twin(name):
    """``pack_tile_rows_kernel`` against its twin bit for bit, one launch
    counted; sentinel slots zero."""
    import torch

    from bibfs_tpu_torch.ops import semiring_plane as port

    _n, bg, tab, _bcol, _deg, _w = _card_graph(name)
    before = port.pack_tile_rows.launches
    bits = port.pack_tile_rows(tab)
    torch.cuda.synchronize()
    assert port.pack_tile_rows.launches == before + 1
    assert bits.is_cuda and bits.dtype == torch.int32
    assert bits.permute(0, 2, 1, 3).is_contiguous()
    assert torch.equal(bits.cpu(), port.pack_tile_rows_plain(tab.cpu()))
    assert not bits.cpu().numpy()[bg.bcol >= bg.nblocks].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_kernels_with_packed_rows_equal_twins(name):
    """Both kernels given the packed rows: no pack launched, PageRank
    within :data:`RANK_TOL` of its twin with its iterations and the same
    ranks bit for bit on a second run, every triangle chunk equal."""
    import torch

    from bibfs_tpu_torch.ops import semiring_plane as port

    n, _bg, tab, bcol, deg, _w = _card_graph(name)
    bits = port.pack_tile_rows(tab)
    packs = port.pack_tile_rows.launches
    kw = dict(n=n, damping=0.85, tol=1e-8, max_iters=100)
    ranks, iters, _ = port.pagerank_blocked(tab, bcol, deg, bits=bits, **kw)
    again, iters2, _ = port.pagerank_blocked(tab, bcol, deg, bits=bits, **kw)
    assert torch.equal(ranks, again) and iters == iters2
    want, want_iters, want_delta = port.pagerank_blocked_plain(
        tab, bcol, deg, **kw)
    assert float((ranks - want).abs().max()) <= RANK_TOL
    assert _iters_agree(iters, want_iters, want_delta, 1e-8)
    for c0 in range(0, n, 256):
        got = port.triangles_chunk_blocked(tab, bcol, c0, bits=bits)
        assert torch.equal(got, port.triangles_chunk_blocked_plain(
            tab, bcol, c0))
    assert port.pack_tile_rows.launches == packs


#: wider tables than the four small graphs, n no chunk multiple: block rows
#: of 47 and 71 slots (two and three 32-slot pieces a triangle block); a
#: hub row of 1,500 and one of 3,000 neighbours (more columns in one
#: 128-slot group than a PageRank warp lists at once: 512); and 157 slots
#: with a hub of 5,000 (two 128-slot groups a PageRank row, both over 512
#: columns on the hub's row; five pieces a triangle block). name -> (n, p,
#: seed, hub degree)
WIDE = {"gnp6000": (6000, 64 / 6000, 31, 0),
        "gnp9000": (9000, 40 / 9000, 37, 0),
        "hub2000": (2000, 8 / 2000, 47, 1500),
        "hub8000": (8000, 16 / 8000, 41, 3000),
        "wide20000": (20000, 24 / 20000, 43, 5000)}


def _group_columns(bits):
    """The most set columns a row holds in one 128-slot group of its
    block row (what ``pagerank_kernel``'s warp lists for that group)."""
    words = bits.cpu().numpy().view(np.uint32)  # [nblocks, bwidth, 128, 4]
    per_slot = np.unpackbits(words.view(np.uint8), axis=-1).reshape(
        *words.shape[:3], -1).sum(axis=-1)
    return max(int(per_slot[:, s0:s0 + 128].sum(axis=1).max())
               for s0 in range(0, words.shape[1], 128))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE))
def test_cuda_wide_tables_equal_twins(name):
    """The pack, PageRank (ranks, iterations, the same ranks on a second
    run), every triangle chunk and the (min, +) fixpoint (labels, SSSP at C
    = 8) on tables whose block rows span more than one 32-slot piece, hub
    rows whose columns fill a warp's list more than once, and block rows of
    two 128-slot groups, against their twins."""
    import torch

    from bibfs_tpu_torch.graph.blocked import build_blocked
    from bibfs_tpu_torch.graph.csr import canonical_pairs
    from bibfs_tpu_torch.ops import semiring_plane as port

    dev = _card()
    n, p, seed, hub = WIDE[name]
    bg = build_blocked(n, pairs=canonical_pairs(
        n, _hub_edges(n, p, seed, hub)))
    assert bg.bwidth > (128 if name == "wide20000" else 32 if not hub else 8)
    tab, bcol, deg = (torch.from_numpy(np.array(a)).to(dev)
                      for a in (bg.tab, bg.bcol, bg.deg))
    bits = port.pack_tile_rows(tab)
    assert torch.equal(bits.cpu(), port.pack_tile_rows_plain(tab.cpu()))
    if hub:
        assert _group_columns(bits) > 512
    kw = dict(n=n, damping=0.85, tol=1e-8, max_iters=100)
    ranks, iters, _ = port.pagerank_blocked(tab, bcol, deg, bits=bits, **kw)
    again, iters2, _ = port.pagerank_blocked(tab, bcol, deg, bits=bits, **kw)
    assert torch.equal(ranks, again) and iters == iters2
    want, want_iters, want_delta = port.pagerank_blocked_plain(
        tab, bcol, deg, **kw)
    assert float((ranks - want).abs().max()) <= RANK_TOL
    assert _iters_agree(iters, want_iters, want_delta, 1e-8)
    for c0 in range(0, n, 256):
        got = port.triangles_chunk_blocked(tab, bcol, c0, bits=bits)
        assert torch.equal(got, port.triangles_chunk_blocked_plain(
            tab, bcol, c0)), c0
    # the (min, +) kernel on the same rows: labels, and SSSP at C = 8
    from bibfs_tpu_torch.graph.blocked import build_blocked_weights

    labels = torch.arange(bg.n_pad, dtype=torch.float32, device=dev)[:, None]
    _minplus_on_card(port, tab, bcol, labels, bits, from_tab=True)
    w = torch.from_numpy(build_blocked_weights(bg, canonical_pairs(
        n, _hub_edges(n, p, seed, hub)), seed=1)).to(dev)
    init = torch.from_numpy(_sssp_init(n, bg.n_pad, 8, 8)).to(dev)
    _minplus_on_card(port, w, bcol, init, bits, from_tab=False)
