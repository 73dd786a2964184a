"""The four level kernels of the PyTorch port: their plain torch versions
(what a CPU tensor runs) against the Pallas kernels of bibfs_tpu in
interpret mode, exactly, on seeded random mid-search states; the fold;
the no-fallback build; and, on a CUDA card only, each CUDA kernel (the
batch-minor level included) against its plain version."""

import numpy as np
import pytest

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


def _setup(n, avg, seed, kind="random", fr_density=0.05):
    """Seeded mid-search state over G(n, avg/n): numpy arrays plus the ELL
    tables. ``kind``: "random", "empty" (no frontier anywhere) or
    "src_eq_dst" (both searches at one vertex, level 0)."""
    # the port's builders (array-identical to the reference's, see
    # test_torch_graph.py), so the CUDA cases need no JAX on the card's host
    from bibfs_tpu_torch.graph.csr import build_ell
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    rng = np.random.default_rng(seed)
    g = build_ell(n, gnp_random_graph(n, avg / n, seed=seed))
    n_pad = g.n_pad
    fr_s = np.zeros(n_pad, bool)
    fr_t = np.zeros(n_pad, bool)
    dist_s = np.full(n_pad, INF32, np.int32)
    dist_t = np.full(n_pad, INF32, np.int32)
    if kind == "random":
        fr_s[rng.integers(0, n, max(1, int(n * fr_density)))] = True
        fr_t[rng.integers(0, n, max(1, int(n * fr_density)))] = True
        dist_s = np.where(rng.random(n_pad) < 0.1, rng.integers(0, 5, n_pad),
                          INF32).astype(np.int32)
        dist_t = np.where(rng.random(n_pad) < 0.1, rng.integers(0, 5, n_pad),
                          INF32).astype(np.int32)
        dist_s[fr_s] = 3
        dist_t[fr_t] = 2
    elif kind == "src_eq_dst":
        v = int(rng.integers(0, n))
        fr_s[v] = fr_t[v] = True
        dist_s[v] = dist_t[v] = 0
    dist_s[n:] = INF32
    dist_t[n:] = INF32
    par = np.where(dist_s < INF32, rng.integers(0, n, n_pad), -1).astype(np.int32)
    return g, fr_s, fr_t, dist_s, dist_t, par


CASES = [(1_000, 2.2, 0, "random"), (4_000, 3.0, 1, "random"),
         (3_001, 1.5, 2, "random"),  # a row count that is a multiple of no block
         (2_000, 2.5, 3, "empty"), (2_000, 2.5, 4, "src_eq_dst"),
         (1_500, 14.0, 5, "random")]  # rows whose first hit needs a 2nd chunk
IDS = [f"{c[3]}-{c[0]}-{c[2]}" for c in CASES]


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _assert_same_live_table(jt, tt, n_rows):
    """The reference's padded table holds the port's unpadded one: the
    live region agrees, with the reference's sentinel read as the port's
    (``n_rows``), and everything outside it is a sentinel."""
    j, t = _np(jt), _np(tt)
    width = t.shape[0]
    assert t.shape == (width, n_rows) and j.shape[0] >= width
    live = j[:width, :n_rows]
    assert np.array_equal(np.where(live >= n_rows, n_rows, live), t)
    assert (j[width:] >= n_rows).all() and (j[:, n_rows:] >= n_rows).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pull_plain_matches_pallas(case):
    """Kernels 3 and 4 (plain versions): next frontier exactly; parent
    where the next frontier is set (the Pallas raw parent is key garbage
    elsewhere, the port's is -1)."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops import pallas_expand as jpe

    from bibfs_tpu_torch.ops import pull_expand as tpe

    g, fr_s, fr_t, dist_s, dist_t, _par = _setup(*case)
    (jt,) = jpe.prepare_pallas_tables(jnp.asarray(g.nbr), jnp.asarray(g.deg))
    (tt,) = tpe.prepare_pallas_tables(torch.as_tensor(g.nbr), torch.as_tensor(g.deg))
    _assert_same_live_table(jt, tt, g.n_pad)
    vs, vt = dist_s < INF32, dist_t < INF32
    nf_j, pc_j = jpe.run_pull((jt,), jnp.asarray(fr_s), jnp.asarray(vs))
    nf_t, pc_t = tpe.run_pull((tt,), torch.as_tensor(fr_s), torch.as_tensor(vs))
    nf_j, nf_t = _np(nf_j), _np(nf_t)
    assert np.array_equal(nf_j, nf_t)
    assert np.array_equal(_np(pc_j)[nf_j], _np(pc_t)[nf_t])
    assert (_np(pc_t)[~nf_t] == -1).all()
    outs_j = [_np(x) for x in jpe.run_pull_dual(
        (jt,), jnp.asarray(fr_s), jnp.asarray(fr_t), jnp.asarray(vs),
        jnp.asarray(vt))]
    outs_t = [_np(x) for x in tpe.run_pull_dual(
        (tt,), torch.as_tensor(fr_s), torch.as_tensor(fr_t),
        torch.as_tensor(vs), torch.as_tensor(vt))]
    for i in (0, 2):
        assert np.array_equal(outs_j[i], outs_t[i])
        nf = outs_t[i]
        assert np.array_equal(outs_j[i + 1][nf], outs_t[i + 1][nf])
        assert (outs_t[i + 1][~nf] == -1).all()
    if case[3] == "empty":
        assert not nf_t.any() and not outs_t[0].any() and not outs_t[2].any()


def _tiered_setup(scale, ef, seed):
    """A seeded mid-search state over the port's tiered RMAT build: the
    base table (width 8 or so) holds hub rows whose degree exceeds it."""
    from bibfs_tpu_torch.graph.csr import build_tiered
    from bibfs_tpu_torch.graph.generate import rmat_graph

    rng = np.random.default_rng(seed)
    n, edges = rmat_graph(scale, edge_factor=ef, seed=seed)
    h = build_tiered(n, edges)
    assert h.tiers and (h.deg > h.nbr.shape[1]).any()
    n_pad = h.n_pad
    fr = rng.random((2, n_pad)) < 0.05
    fr[:, n:] = False
    dist = np.where(rng.random((2, n_pad)) < 0.1, 1, INF32).astype(np.int32)
    dist[0][fr[0]] = 3
    dist[1][fr[1]] = 2
    dist[:, n:] = INF32
    tiers = [(t.start, t.count, t.nbr, h.hub_ids[: t.nbr.shape[0]])
             for t in h.tiers]
    return h, fr[0], fr[1], dist[0], dist[1], tiers


TIERED = [(11, 8, 3), (12, 4, 7)]
TIERED_IDS = [f"rmat{c[0]}-ef{c[1]}-{c[2]}" for c in TIERED]


@pytest.mark.parametrize("case", TIERED, ids=TIERED_IDS)
def test_pull_plain_matches_pallas_tiered(case):
    """Kernels 3 and 4 (plain versions) at a tiered base table whose hub
    rows have ``deg > width``: the row bound ``min(deg, width)`` (the true
    degree, or the table's own live slots by default) reads the whole hub
    row, as the reference's sentinel walk does."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops import pallas_expand as jpe

    from bibfs_tpu_torch.ops import bitmap as bm
    from bibfs_tpu_torch.ops import pull_expand as tpe

    h, fr_s, fr_t, dist_s, dist_t, _tiers = _tiered_setup(*case)
    (jt,) = jpe.prepare_pallas_tables(jnp.asarray(h.nbr), jnp.asarray(h.deg))
    (tt,) = tpe.prepare_pallas_tables(torch.as_tensor(h.nbr),
                                      torch.as_tensor(h.deg))
    _assert_same_live_table(jt, tt, h.n_pad)
    deg = torch.as_tensor(h.deg)
    assert torch.equal(tpe.live_slots(tt), deg.clamp(max=tt.shape[0]))
    vs, vt = dist_s < INF32, dist_t < INF32
    want1 = [_np(x) for x in jpe.run_pull((jt,), jnp.asarray(fr_s), jnp.asarray(vs))]
    want2 = [_np(x) for x in jpe.run_pull_dual(
        (jt,), jnp.asarray(fr_s), jnp.asarray(fr_t), jnp.asarray(vs),
        jnp.asarray(vt))]
    # the functional forms (rows bounded by the table's live slots), and
    # the kernels' plain twins bounded by the true degree as the solver
    # passes it
    t_fs, t_ft = torch.as_tensor(fr_s), torch.as_tensor(fr_t)
    t_vs, t_vt = torch.as_tensor(vs), torch.as_tensor(vt)
    bits = bm.pack_bits(t_fs, bm.frontier_words(h.n_pad))
    pair = tpe.pack_front(t_fs, t_ft, h.n_pad)
    for got1, got2 in (
            (tpe.run_pull((tt,), t_fs, t_vs),
             tpe.run_pull_dual((tt,), t_fs, t_ft, t_vs, t_vt)),
            (tpe.pull_single_plain(tt, deg, bits, t_vs)[:2],
             tpe.pull_dual_plain(tt, deg, pair, t_vs, t_vt)[:4])):
        for want, got in ((want1, got1), (want2, got2)):
            got = [_np(x) for x in got]
            for i in range(0, len(got), 2):
                nf = got[i]
                assert np.array_equal(want[i], nf)
                assert np.array_equal(want[i + 1][nf], got[i + 1][nf])
                assert (got[i + 1][~nf] == -1).all()
    hubs = h.deg > h.nbr.shape[1]
    assert (want1[0] & hubs[: len(want1[0])]).any() or (want2[0] & hubs).any()


HANDOVER = [("ell", 0), ("ell", 5), ("tiered", 0), ("tiered", 1)]


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("case", HANDOVER, ids=[f"{c[0]}-{c[1]}" for c in HANDOVER])
def test_pull_rounds_hand_over_the_frontier(case, dual):
    """Two rounds in a row through the level code the solver runs
    (``pull_round`` / ``pull_round_dual``), the second taking the
    frontier the first wrote (the kernel's next bitmap, or on a tiered
    graph the one rebuilt after the tier pass), against two calls of the
    reference's ``pallas_pull_level`` / ``pallas_pull_level_dual``; the
    port's functional forms of those give the same each round."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops import pallas_expand as jpe

    from bibfs_tpu_torch.ops import bitmap as bm
    from bibfs_tpu_torch.ops import pull_expand as tpe

    layout, k = case
    if layout == "tiered":
        h, fr_s, fr_t, dist_s, dist_t, tiers = _tiered_setup(*TIERED[k])
        nbr, deg = h.nbr, h.deg
    else:
        g, fr_s, fr_t, dist_s, dist_t, _par = _setup(*CASES[k])
        nbr, deg, tiers = g.nbr, g.deg, []
    n_pad = nbr.shape[0]
    par = np.full(n_pad, -1, np.int32)
    (jt,) = jpe.prepare_pallas_tables(jnp.asarray(nbr), jnp.asarray(deg))
    (tt,) = tpe.prepare_pallas_tables(torch.as_tensor(nbr), torch.as_tensor(deg))
    jtiers = tuple((s, c, jnp.asarray(a), jnp.asarray(b)) for s, c, a, b in tiers)
    ttiers = tuple((s, c, torch.as_tensor(a), torch.as_tensor(b))
                   for s, c, a, b in tiers)
    tdeg = torch.as_tensor(deg)
    j = [jnp.asarray(x) for x in (fr_s, fr_t, par, dist_s, par, dist_t)]
    t = [torch.as_tensor(x) for x in (fr_s, fr_t, par, dist_s, par, dist_t)]
    words = bm.frontier_words(n_pad)
    if dual:
        front = tpe.pack_front(t[0], t[1], n_pad)
    else:
        front = bm.pack_bits(t[0], words)
    for lvl in (4, 5):
        if dual:
            a = jpe.pallas_pull_level_dual(*j, (jt,), jnp.asarray(deg), jtiers,
                                           jnp.int32(lvl), jnp.int32(lvl - 1),
                                           inf=INF32)
            *b, front = tpe.pull_round_dual(
                *t[:2], front, *t[2:], tt, tdeg, ttiers, lvl, lvl - 1, inf=INF32)
            # the functional form (bool rows in, the JAX contract out)
            c = tpe.pallas_pull_level_dual(*t, (tt,), tdeg, ttiers, lvl,
                                           lvl - 1, inf=INF32)
            j = [a[0], a[4], a[1], a[2], a[5], a[6]]
            t = [b[0], b[4], b[1], b[2], b[5], b[6]]
            assert torch.equal(front, tpe.pack_front(b[0], b[4], n_pad))
        else:
            a = jpe.pallas_pull_level(j[0], j[2], j[3], (jt,), jnp.asarray(deg),
                                      jtiers, jnp.int32(lvl), inf=INF32)
            nf, front, par_t, dist_t2, md = tpe.pull_round(
                t[0], front, t[2], t[3], tt, tdeg, ttiers, lvl, inf=INF32)
            c = tpe.pallas_pull_level(t[0], t[2], t[3], (tt,), tdeg, ttiers,
                                      lvl, inf=INF32)
            b = [nf, par_t, dist_t2, md]
            j = [a[0], j[1], a[1], a[2], j[4], j[5]]
            t = [nf, t[1], par_t, dist_t2, t[4], t[5]]
            assert torch.equal(front, bm.pack_bits(nf, words))
        assert len(a) == len(b) == len(c)
        for x, y, z in zip(a, b, c):
            assert np.array_equal(_np(x), _np(y))
            assert np.array_equal(_np(x), _np(z))
        assert _np(b[0]).any()  # each round reaches new vertices


def _state_rows(g, fr_s, fr_t, dist_s, dist_t, par, rows):
    """The state rows as numpy, padded to ``rows`` with unreached rows."""

    def lift(a, fill):
        return np.pad(a, (0, rows - g.n_pad), constant_values=fill)

    dual = lift(fr_s.astype(np.int32) | (fr_t.astype(np.int32) << 1), 0)
    return dict(dual=dual, dist_s=lift(dist_s, INF32),
                dist_t=lift(dist_t, INF32), par_s=lift(par, -1),
                par_t=lift(par[::-1].copy(), -1))


def _fused_rows(g, fr_s, fr_t, dist_s, dist_t, par):
    """The port's fused tables (unpadded) and its torch state rows."""
    import torch

    from bibfs_tpu_torch.ops import fused_level as tfl

    nbr_tt, deg2_t = tfl.prepare_fused_tables(torch.as_tensor(g.nbr),
                                              torch.as_tensor(g.deg))
    host = _state_rows(g, fr_s, fr_t, dist_s, dist_t, par, g.n_pad)
    t = {k: torch.as_tensor(v) for k, v in host.items()}
    t["dual"] = t["dual"].to(torch.uint8)
    return nbr_tt, deg2_t, t


def _fused_inputs(g, fr_s, fr_t, dist_s, dist_t, par):
    """Both packages' fused tables and state rows (the reference's padded
    to its 4096-row tiles); the tables must agree on the live region."""
    import jax.numpy as jnp

    from bibfs_tpu.ops import pallas_fused as jpf

    nbr_tt, deg2_t, t = _fused_rows(g, fr_s, fr_t, dist_s, dist_t, par)
    nbr_tj, deg2_j = jpf.prepare_fused_tables(jnp.asarray(g.nbr), jnp.asarray(g.deg))
    _assert_same_live_table(nbr_tj, nbr_tt, g.n_pad)
    assert np.array_equal(_np(deg2_j)[0, :g.n_pad], _np(deg2_t))
    assert not _np(deg2_j)[0, g.n_pad:].any()
    rows = nbr_tj.shape[1]
    host = _state_rows(g, fr_s, fr_t, dist_s, dist_t, par, rows)
    j = {k: jnp.asarray(v).reshape(1, rows) for k, v in host.items()}
    return (nbr_tj, deg2_j, j), (nbr_tt, deg2_t, t), jpf.key_stride(g.n_pad)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_dual_plain_matches_pallas(case):
    """Kernel 1 (plain version) against ``fused_dual_level``: every output
    row in full and every scalar (the meet index where a meet exists)."""
    import jax.numpy as jnp

    from bibfs_tpu.ops import pallas_fused as jpf

    from bibfs_tpu_torch.ops import fused_level as tfl

    (nj, dj, j), (nt, dt, t), ks = _fused_inputs(*_setup(*case))
    a = jpf.fused_dual_level(j["dual"], nj, dj, j["dist_s"], j["dist_t"],
                             j["par_s"], j["par_t"], jnp.int32(4),
                             jnp.int32(3), ks=ks)
    b = tfl.fused_dual_level(t["dual"], nt, dt, t["dist_s"], t["dist_t"],
                             t["par_s"], t["par_t"], 4, 3)
    for x, y in zip(a[:5], b[:5]):  # the port's rows are the unpadded ones
        assert np.array_equal(_np(x)[0, :len(y)], _np(y).astype(np.int32))
    assert [int(x) for x in a[5:12]] == list(b[5:12])
    if int(a[11]) < INF32:
        assert int(a[12]) == b[12]
    else:
        assert b[12] == -1


@pytest.mark.parametrize("bit", [0, 1])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_single_plain_matches_pallas(case, bit):
    """Kernel 2 (plain version) against ``fused_single_level`` for each
    advancing side: the passive side's frontier bit passes through."""
    from bibfs_tpu.ops import pallas_fused as jpf

    from bibfs_tpu_torch.ops import fused_level as tfl

    (nj, dj, j), (nt, dt, t), ks = _fused_inputs(*_setup(*case))
    act, pas = ("dist_s", "dist_t") if bit == 0 else ("dist_t", "dist_s")
    par = "par_s" if bit == 0 else "par_t"
    a = jpf.fused_single_level(j["dual"], nj, dj, j[act], j[pas], j[par], 4,
                               bit=bit, ks=ks)
    b = tfl.fused_single_level(t["dual"], nt, dt, t[act], t[pas], t[par], 4,
                               bit=bit)
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(_np(x)[0, :len(y)], _np(y).astype(np.int32))
    assert [int(x) for x in a[3:7]] == list(b[3:7])
    if int(a[6]) < INF32:
        assert int(a[7]) == b[7]


def test_deep_case_needs_a_second_chunk():
    """In the last case some unvisited row's first frontier hit lies past
    the kernels' first chunk of 8 slots, so the chunked claim must go on
    to a second chunk (and the case is the same for the CUDA test)."""
    from bibfs_tpu_torch.ops.pull_expand import CHUNK

    g, fr_s, fr_t, dist_s, dist_t, _par = _setup(*CASES[-1])
    deep = 0
    for fr, dist in ((fr_s, dist_s), (fr_t, dist_t)):
        hit = fr[np.where(g.nbr >= 0, g.nbr, 0)]
        hit &= np.arange(g.nbr.shape[1])[None, :] < g.deg[:, None]
        first = np.where(hit.any(1), hit.argmax(1), -1)
        deep += int(((first >= CHUNK) & (dist >= INF32)).sum())
    assert g.nbr.shape[1] > 2 * CHUNK and deep > 0


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 3_001])
def test_pack_bits_round_trip(n):
    """The bitmap words round-trip a bool row at row counts that are not a
    multiple of 32, the bits past ``n`` are zero, and the bit order is the
    reference's ``parallel/collectives.pack_bits``."""
    import torch

    from bibfs_tpu.parallel.collectives import pack_bits as jpack

    from bibfs_tpu_torch.ops import fused_level as fl

    fr = np.random.default_rng(n).random(n) < 0.4
    fr[-1] = True
    words = fl.frontier_words(n)
    assert words % 4 == 0 and words * 32 >= n
    w = fl.pack_bits(torch.as_tensor(fr), words)
    assert w.dtype == torch.int32 and w.shape == (words,)
    assert np.array_equal(fl.unpack_bits(w, n).numpy(), fr)
    assert not fl.unpack_bits(w, words * 32)[n:].any()
    ref = np.asarray(jpack(fr)).astype(np.uint32)
    assert np.array_equal(w.numpy()[:ref.shape[0]].view(np.uint32), ref)
    seed = fl.new_frontier(n - 1, 0, n, "cpu")
    assert seed.shape == (2, 2, words) and int(seed.ne(0).sum()) == 2
    assert fl.unpack_bits(seed[0, 0], n)[n - 1] and fl.unpack_bits(seed[1, 0], n)[0]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 100, 3_001])
def test_pack_pairs_round_trip(n):
    """The dual kernel's pair row (2 bits per vertex, 16 vertices a word)
    round-trips both sides' rows, agrees bit for bit with the two bitmaps,
    and leaves the bits past ``n`` zero."""
    import torch

    from bibfs_tpu_torch.ops import bitmap as bm

    rng = np.random.default_rng(n)
    fr_s, fr_t = (torch.as_tensor(rng.random(n) < 0.4) for _ in range(2))
    words = 2 * bm.frontier_words(n)
    row = bm.pack_pairs(fr_s, fr_t, words)
    assert row.dtype == torch.int32 and row.shape == (words,)
    s, t = bm.unpack_pairs(row, n)
    assert torch.equal(s, fr_s) and torch.equal(t, fr_t)
    s, t = bm.unpack_pairs(row, words * 16)
    assert not s[n:].any() and not t[n:].any()
    for side, fr in ((0, fr_s), (1, fr_t)):
        bits = bm.pack_bits(fr, bm.frontier_words(n))
        u = torch.arange(n)
        via_row = (row.long()[u >> 4] >> (2 * (u & 15) + side)) & 1
        via_bits = (bits.long()[u >> 5] >> (u & 31)) & 1
        assert torch.equal(via_row, via_bits)


def test_alt_rounds_keep_the_passive_bitmap():
    """A fused_alt search driven round by round through the level-parity
    bitmaps: each round rewrites only the advancing side's other parity,
    both sides advance over the search, and the result is the
    reference's ``fused_alt`` solve exactly."""
    import torch

    from bibfs_tpu.graph.generate import gnp_random_graph
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.ops import fused_level as fl
    from bibfs_tpu_torch.solvers import dense as td

    n = 2_000
    edges = gnp_random_graph(n, 2.5 / n, seed=11)
    gj = jd.DeviceGraph.build(n, edges)
    gt = td.DeviceGraph.build(n, edges, device="cpu")
    nbr_t, deg = fl.prepare_fused_tables(gt.nbr, gt.deg)
    kj = jd._get_kernel("fused_alt", 0, (), jd._geom_of(gj), 1)
    for s, d in ((0, n - 1), (7, 1_234)):
        dist_s = torch.full((gt.n_pad,), INF32, dtype=torch.int32)
        dist_t = dist_s.clone()
        dist_s[s] = 0
        dist_t[d] = 0
        par_s = torch.full((gt.n_pad,), -1, dtype=torch.int32)
        par_t = par_s.clone()
        bits = fl.new_frontier(s, d, gt.n_pad, "cpu")
        state = fl.new_state(s, d, deg)
        acc, key = fl.new_scratch("cpu")
        sides = set()
        while fl.active(state.tolist()):
            st = state.tolist()
            side = 0 if st[fl.S["cnt_s"]] <= st[fl.S["cnt_t"]] else 1
            lvl = st[fl.S["lvl_s"] + side]
            before = bits.clone()
            fl.fused_single_round(nbr_t, deg, bits, dist_s, dist_t, par_s,
                                  par_t, state, acc, key)
            fl.fold_round(state, acc, key, alt=True)
            assert torch.equal(bits[1 - side], before[1 - side])
            assert torch.equal(bits[side, lvl & 1], before[side, lvl & 1])
            assert state.tolist()[fl.S["lvl_s"] + side] == lvl + 1
            sides.add(side)
        assert sides == {0, 1}
        st = state.tolist()
        oj = kj(gj.nbr, gj.deg, gj.aux, jd._device_scalar(s), jd._device_scalar(d))
        assert [int(oj[0]), int(oj[1]), int(oj[4]), int(oj[5])] == [
            st[fl.S["best"]], st[fl.S["meet"]], st[fl.S["levels"]],
            st[fl.S["edges"]]]
        assert np.array_equal(np.asarray(oj[2]), par_s.numpy())
        assert np.array_equal(np.asarray(oj[3]), par_t.numpy())


@pytest.mark.parametrize("alt", [False, True])
def test_fold_round_plain(alt):
    """The fold applies one round to the state as the JAX solver's scalar
    fixup does, then clears the accumulators; an inactive state only has
    its accumulators cleared."""
    import torch

    from bibfs_tpu_torch.ops import fused_level as fl

    st0 = [2, 1, 9, 4, 5, 3, 6, 7, 40, 30, 6, 100]
    state = torch.tensor(st0, dtype=torch.int32)
    acc = torch.tensor([11, 12, 13, 14, 15, 16], dtype=torch.int32)
    key = torch.tensor([(5 << 32) | 77], dtype=torch.int64)
    fl.fold_round(state, acc, key, alt=alt)
    want = list(st0)
    want[fl.S["best"]], want[fl.S["meet"]] = 5, 77
    if alt:  # cnt_s 5 > cnt_t 3: the target side advanced
        want[fl.S["edges"]] += 30
        want[fl.S["lvl_t"]] += 1
        want[fl.S["cnt_t"]], want[fl.S["md_t"]], want[fl.S["ds_t"]] = 12, 14, 16
        want[fl.S["levels"]] += 1
    else:
        want[fl.S["edges"]] += 70
        want[fl.S["lvl_s"]] += 1
        want[fl.S["lvl_t"]] += 1
        want[fl.S["cnt_s"]:fl.S["ds_t"] + 1] = [11, 12, 13, 14, 15, 16]
        want[fl.S["levels"]] += 2
    assert state.tolist() == want
    assert acc.tolist() == [0] * 6 and key.tolist() == [fl.NO_MEET]
    # a stopped search (lvl_s + lvl_t >= best) is left as it is
    done = torch.tensor(want, dtype=torch.int32)
    done[fl.S["best"]] = 3
    before = done.tolist()
    acc.fill_(9)
    key.fill_(1)
    fl.fold_round(done, acc, key, alt=alt)
    assert done.tolist() == before
    assert acc.tolist() == [0] * 6 and key.tolist() == [fl.NO_MEET]


def test_meet_key_round_trip():
    from bibfs_tpu_torch.ops.fused_level import INF32 as FINF
    from bibfs_tpu_torch.ops.fused_level import NO_MEET, decode_meet

    assert decode_meet(NO_MEET) == (FINF, -1)
    assert decode_meet(((2 * FINF - 2) << 32) | 123) == (2 * FINF - 2, 123)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: with no nvcc a kernel library cannot load and
    the loader raises."""
    import shutil

    from bibfs_tpu_torch.ops import _cuda

    for p in _cuda.CSRC.glob("*.cu*"):
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "_libs", {})
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    real_exists = _cuda.os.path.exists
    monkeypatch.setattr(_cuda.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc") else real_exists(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.lib("pull_expand")
    assert not (tmp_path / "build").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_kernels_match_plain(case, cuda_device):
    """On a card: each CUDA kernel against its plain version on the same
    device inputs, exactly, with the launch counters moving."""
    import torch

    from bibfs_tpu_torch.ops import bitmap as bm
    from bibfs_tpu_torch.ops import fused_level as fl
    from bibfs_tpu_torch.ops import pull_expand as pe

    g, fr_s, fr_t, dist_s, dist_t, par = _setup(*case)
    dev = cuda_device
    (nbr_t,) = pe.prepare_pallas_tables(torch.as_tensor(g.nbr).to(dev),
                                        torch.as_tensor(g.deg).to(dev))
    deg = torch.as_tensor(g.deg).to(dev)
    f_s = torch.as_tensor(fr_s).to(dev)
    f_t = torch.as_tensor(fr_t).to(dev)
    v_s = torch.as_tensor(dist_s < INF32).to(dev)
    v_t = torch.as_tensor(dist_t < INF32).to(dev)
    bits = bm.pack_bits(f_s, bm.frontier_words(g.n_pad))
    pair = pe.pack_front(f_s, f_t, g.n_pad)
    before = (pe.pull_single.launches, pe.pull_dual.launches)
    for x, y in zip(pe.pull_single(nbr_t, deg, bits, v_s),
                    pe.pull_single_plain(nbr_t, deg, bits, v_s)):
        assert torch.equal(x, y)
    for x, y in zip(pe.pull_dual(nbr_t, deg, pair, v_s, v_t),
                    pe.pull_dual_plain(nbr_t, deg, pair, v_s, v_t)):
        assert torch.equal(x, y)
    assert (pe.pull_single.launches, pe.pull_dual.launches) == (
        before[0] + 1, before[1] + 1)
    nt, d2, t = _fused_rows(g, fr_s, fr_t, dist_s, dist_t, par)
    t = {k: v.to(dev) for k, v in t.items()}
    nt, d2 = nt.to(dev), d2.to(dev)
    n_rows = nt.shape[1]
    # kernel 1, and both instantiations of kernel 2: the wrapper stages at
    # these sizes, the private launcher does not
    shapes = {False: [fl.fused_dual_round],
              True: [fl.fused_single_round, fl._single_round_unstaged]}
    assert fl.stage_fits(fl.frontier_words(n_rows))
    for alt, cnt_s in ((False, 1), (True, 1), (True, 2)):
        def run(fn, fold):
            st = torch.tensor([3, 2, INF32, -1, cnt_s, 1, 0, 0, 4, 5, 6, 7],
                              dtype=torch.int32, device=dev)
            acc, key = fl.new_scratch(dev)
            rows = [fl._bits_of_row(t["dual"], 3, 2, n_rows), t["dist_s"].clone(),
                    t["dist_t"].clone(), t["par_s"].clone(), t["par_t"].clone()]
            fn(nt, d2, *rows, st, acc, key)
            fold(st, acc, key, alt=alt)
            return rows + [st, acc, key]

        want = run(fl.fused_single_round_plain if alt
                   else fl.fused_dual_round_plain, fl.fold_round_plain)
        for fn in shapes[alt]:
            for x, y in zip(run(fn, fl.fold_round), want):
                assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ell", "tiered"])
def test_cuda_solve_matches_cpu(layout, cuda_device):
    """On a card: every mode's raw outputs through the CUDA kernels equal
    the plain versions' on the CPU (ragged row count; unroll 3 on the
    card, 1 on the CPU)."""
    import torch

    from bibfs_tpu_torch.graph.generate import gnp_random_graph, rmat_graph
    from bibfs_tpu_torch.solvers import dense as td

    if layout == "tiered":
        n, edges = rmat_graph(11, edge_factor=8, seed=3)
    else:
        n = 3001
        edges = gnp_random_graph(n, 3.0 / n, seed=2)
    gc = td.DeviceGraph.build(n, edges, layout=layout, device="cpu")
    gg = td.DeviceGraph.build(n, edges, layout=layout, device=cuda_device)
    for mode in td.DENSE_MODES:
        for s, d in ((0, n - 1), (5, 17), (9, 9)):
            a = td._run(gc, s, d, mode, 1, None)
            b = td._run(gg, s, d, mode, 3, None)
            assert a[0] == b[0] and a[1] == b[1] and a[4:] == b[4:], (mode, s, d)
            assert torch.equal(a[2], b[2].cpu()) and torch.equal(a[3], b[3].cpu())


def _minor_state(g, b, dt8, seed, device):
    """A seeded mid-search state of the batch-minor planes (``[rows, b]``,
    a few pad rows past the table), as tensors on ``device``."""
    import torch

    rng = np.random.default_rng(seed)
    inf = 127 if dt8 else INF32
    rows = g.n_pad + 37

    def side():
        d = np.full((rows, b), inf, np.int64)
        vis = rng.random((g.n, b)) < 0.3
        d[: g.n][vis] = rng.integers(0, 3, int(vis.sum()))
        return d

    ds, dt = side(), side()
    dual = (ds == 2).astype(np.int64) | ((dt == 2).astype(np.int64) << 1)
    hi = g.nbr.shape[1] if dt8 else g.n
    ps = np.where(ds < inf, rng.integers(0, hi, ds.shape), -1)
    pt = np.where(dt < inf, rng.integers(0, hi, dt.shape), -1)
    pdt = np.int8 if dt8 else np.int32
    planes = [torch.from_numpy(x.astype(pdt)).to(device)
              for x in (dual, ds, dt, ps, pt)]
    active = torch.from_numpy((rng.random(b) < 0.8).astype(np.int32)).to(device)
    return planes, active


def _hub_edges(n, seed):
    """G(n, 3/n) plus five hubs of about 90 neighbours each: ELL rows past
    the 32 slots the level kernel stages."""
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    rng = np.random.default_rng(seed)
    hubs = [(h, int(v)) for h in range(5)
            for v in rng.choice(np.arange(5, n), 90, replace=False)]
    return np.concatenate([gnp_random_graph(n, 3.0 / n, seed=seed),
                           np.array(hubs)])


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["gnp", "hubs"])
@pytest.mark.parametrize("dt8", [False, True], ids=["minor", "minor8"])
def test_cuda_minor_level_matches_plain(dt8, graph, cuda_device):
    """On a card: the batch-minor level kernel (both instantiations)
    against its packed plain twin on the same device state, exactly (the
    frontier and visited words, the planes, the counters and the key),
    with the instantiation's launch counter moving. The input key is the
    full vote of the input state. ``hubs`` has rows wider than the
    kernel's staged slots."""
    import torch

    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.ops import minor_level as ml
    from bibfs_tpu_torch.solvers import dense as td

    n = 3001
    edges = (gnp_random_graph(n, 3.0 / n, seed=5) if graph == "gnp"
             else _hub_edges(n, 5))
    g = td.DeviceGraph.build(n, edges, device=cuda_device)
    assert graph == "gnp" or g.width > 32
    nbr_t = td._kernel_table(g.tables, g.nbr, g.deg)
    (dual, *planes), active = _minor_state(g, 256, dt8, 4, cuda_device)
    front = ml.pack_front(dual)
    key = ml.meet_vote(planes[0], planes[1])
    planes = [ml.pack_vis(planes[0], planes[1])] + planes
    kp = [p.clone() for p in planes]
    name = "minor8" if dt8 else "minor"
    before = ml.minor_level.launches[name]
    got = ml.minor_level(nbr_t, g.deg, front, *kp, 3, active, key)
    want = ml.minor_level_packed_plain(nbr_t, g.deg, front, *planes, 3, active,
                                       key, tc=64)
    for x, y in zip(list(got) + kp, list(want) + planes):
        assert torch.equal(x, y)
    assert ml.minor_level.launches[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["minor8", "minor"])
def test_cuda_minor_batch_matches_cpu(mode, cuda_device):
    """On a card: a batch through the level kernel equals the same batch
    on the CPU (the plain twin), answers and raw outputs."""
    import torch

    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.solvers import dense as td

    n = 3001
    edges = gnp_random_graph(n, 3.0 / n, seed=2)
    gc = td.DeviceGraph.build(n, edges, device="cpu")
    gg = td.DeviceGraph.build(n, edges, device=cuda_device)
    pairs = np.random.default_rng(1).integers(0, n, (200, 2))
    pairs[7] = (4, 4)
    outs = []
    for g in (gc, gg):
        _, thunk, finish = td._batch_dispatch(g, pairs, mode)
        outs.append([o.cpu() for o in finish(thunk())])
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    a = td.solve_batch_graph(gc, pairs, mode=mode)
    b = td.solve_batch_graph(gg, pairs, mode=mode)
    for x, y in zip(a, b):
        assert (x.found, x.hops, x.path, x.meet, x.levels, x.edges_scanned) == (
            y.found, y.hops, y.path, y.meet, y.levels, y.edges_scanned)


def test_cuda_marker_is_registered(pytestconfig):
    markers = pytestconfig.getini("markers")
    assert any(m.startswith("cuda") for m in markers)
