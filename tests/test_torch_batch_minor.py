"""The PyTorch port's batched search (``bibfs_tpu_torch.solvers.batch_minor``
and the batch entry points of its dense solver) against
``bibfs_tpu.solvers.batch_minor`` / ``bibfs_tpu.solvers.dense`` on the CPU:
the raw batch outputs exactly (best, meet, live parent rows, levels,
edges, the int8 cap flags), one level of the plain twin against the
reference's ``_level_scan`` (forced multi-chunk scans included), the
edge cases, the refill paths, routing and errors, the per-query batch
modes and the timing protocol."""

import types

import numpy as np
import pytest

from tests.conftest import random_graph_cases

CASES = random_graph_cases(num=12, seed=77)
INF32 = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _graphs(n, edges, layout="ell"):
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    return (jd.DeviceGraph.build(n, edges, layout=layout),
            td.DeviceGraph.build(n, edges, layout=layout, device="cpu"))


def _raw(dense_mod, g, pairs, mode):
    """``(thunk output, finished output)`` of one batch dispatch."""
    _, thunk, finish = dense_mod._batch_dispatch(g, pairs, mode)
    raw = thunk()
    return raw, finish(raw)


def _np(x):
    import torch

    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_batch(n, edges, pairs, mode, layout="ell"):
    """The port's and the reference's batch outputs agree exactly: every
    per-query scalar, the live region of the parent rows, and under
    ``minor8`` the raw cap flags."""
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    gj, gt = _graphs(n, edges, layout)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    rj, oj = _raw(jd, gj, pairs, mode)
    rt, ot = _raw(td, gt, pairs, mode)
    b = len(pairs)
    assert len(oj) == len(ot) == 6
    for a, c in zip(oj, ot):
        a, c = _np(a)[:b], _np(c)[:b]
        if a.ndim == 2:
            a, c = a[:, :n], c[:, :n]
        assert np.array_equal(a, c)
    if mode == "minor8":
        assert np.array_equal(_np(rj[-1]), _np(rt[-1]))
    res_j = jd.solve_batch_graph(gj, pairs, mode=mode)
    res_t = td.solve_batch_graph(gt, pairs, mode=mode)
    for x, y in zip(res_j, res_t):
        assert (x.found, x.hops, x.path, x.meet, x.levels, x.edges_scanned) == (
            y.found, y.hops, y.path, y.meet, y.levels, y.edges_scanned)
    return res_t


@pytest.mark.parametrize("mode", ["minor", "minor8"])
@pytest.mark.parametrize("case", range(0, len(CASES), 2))
def test_batch_matches_reference_on_random_graphs(case, mode):
    n, edges, _, _ = CASES[case]
    rng = np.random.default_rng(5)
    pairs = rng.integers(0, n, size=(9, 2))
    pairs[3] = (min(2, n - 1), min(2, n - 1))  # src == dst
    got = assert_same_batch(n, edges, pairs, mode)
    assert all(r.mode == mode and r.host_syncs >= 1 for r in got)


def _star(n=600):
    return n, np.array([[0, i] for i in range(1, n)] + [[n - 1, n - 2]])


@pytest.mark.parametrize("graph", ["rmat-8", "star-600"])
def test_minor_matches_reference_on_tiered_graphs(graph):
    from bibfs_tpu.graph.generate import rmat_graph

    if graph == "rmat-8":
        n, edges = rmat_graph(8, edge_factor=6, seed=1)
        rng = np.random.default_rng(3)
        pairs = rng.integers(0, n, size=(9, 2))
        pairs[2] = (5, 5)
    else:
        n, edges = _star()
        pairs = [(1, n - 2), (0, n - 1), (4, 4)]
    _, gt = _graphs(n, edges, "tiered")
    assert gt.tier_meta, "the case must have hub tiers"
    assert_same_batch(n, edges, pairs, "minor", "tiered")


@pytest.mark.parametrize("mode", ["minor", "minor8"])
@pytest.mark.parametrize("kind", ["line-pad", "disconnected", "tiny-2",
                                  "tiny-3", "tiny-5", "deep-line"])
def test_batch_edge_cases_match_reference(kind, mode):
    """Padding far below 128 lanes stays inert; unreachable and
    ``src == dst`` queries; degenerate graphs; a query deeper than the
    int8 cap comes back exact through the refill."""
    line = lambda k: np.array([[i, i + 1] for i in range(k - 1)])  # noqa: E731
    n, edges, pairs = {
        "line-pad": (40, line(40), [(0, 39), (3, 3), (5, 20)]),
        "disconnected": (5, np.array([[0, 1], [1, 2], [3, 4]]),
                         [(0, 4), (0, 2)]),
        "tiny-2": (2, np.array([[0, 1]]), [(0, 1), (0, 0), (0, 1)]),
        "tiny-3": (3, np.array([[0, 1]]), [(0, 2), (0, 0), (0, 1)]),
        "tiny-5": (5, np.array([[0, 1], [1, 2], [3, 4]]),
                   [(0, 4), (0, 0), (0, 1)]),
        "deep-line": (400, line(400), [(0, 399), (0, 10), (5, 5)]),
    }[kind]
    got = assert_same_batch(n, edges, pairs, mode)
    if kind == "deep-line":
        assert got[0].path == list(range(n)) and got[2].path == [5]
    if kind == "line-pad":
        assert [r.hops for r in got] == [39, 0, 15]


def _level_state(seed, n, b, dt8):
    """A seeded mid-search state over G(n, 3/n): the planes as numpy."""
    rng = np.random.default_rng(seed)
    inf = 127 if dt8 else INF32
    from bibfs_tpu_torch.graph.csr import build_ell
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    g = build_ell(n, gnp_random_graph(n, 3.0 / n, seed=seed))
    n_pad2 = g.n_pad + 13

    def side():
        d = np.full((n_pad2, b), inf, np.int64)
        vis = rng.random((n, b)) < 0.3
        d[:n][vis] = rng.integers(0, 3, int(vis.sum()))
        return d

    ds, dt = side(), side()
    dual = (ds == 2).astype(np.int64) | ((dt == 2).astype(np.int64) << 1)
    hi = g.nbr.shape[1] if dt8 else n
    ps = np.where(ds < inf, rng.integers(0, hi, ds.shape), -1)
    pt = np.where(dt < inf, rng.integers(0, hi, dt.shape), -1)
    active = (rng.random(b) < 0.8).astype(np.int32)
    pdt = np.int8 if dt8 else np.int32
    return g, [x.astype(pdt) for x in (dual, ds, dt, ps, pt)], active


@pytest.mark.parametrize("tc", [8, 64, None], ids=["tc8", "tc64", "whole"])
@pytest.mark.parametrize("dt8", [False, True], ids=["int32", "int8"])
def test_level_plain_matches_level_scan(dt8, tc):
    """One level of the plain twin against the reference's ``_level_scan``
    on the same state: the next dual plane, the rewritten dist and parent
    planes, the counts, the scanned edges and the meet vote."""
    import jax.numpy as jnp
    import torch

    from bibfs_tpu.ops.pallas_expand import _slot_pad, sentinel_transposed_table
    from bibfs_tpu.solvers.batch_minor import _level_scan

    from bibfs_tpu_torch.ops.minor_level import decode_meet, minor_level_plain
    from bibfs_tpu_torch.ops.pull_expand import sentinel_transposed_table as stt

    g, (dual, ds, dt, ps, pt), active = _level_state(3, 300, 128, dt8)
    n_pad2 = dual.shape[0]
    tc = n_pad2 if tc is None else tc
    rows = -(-n_pad2 // tc) * tc  # the reference scans whole chunks
    pad = lambda a, v: np.pad(a, ((0, rows - n_pad2), (0, 0)),  # noqa: E731
                              constant_values=v)
    inf = 127 if dt8 else INF32
    wp = _slot_pad(g.width)
    nbr_tj = sentinel_transposed_table(jnp.asarray(g.nbr), jnp.asarray(g.deg),
                                       rows, rows, wp)
    deg2 = jnp.pad(jnp.asarray(g.deg), (0, rows - g.n_pad))
    out = _level_scan(
        jnp.asarray(pad(dual, 0)),
        tuple(jnp.asarray(pad(x, v)) for x, v in ((ds, inf), (dt, inf),
                                                  (ps, -1), (pt, -1))),
        nbr_tj, deg2, tc=tc, ks=rows + 1, lvl=jnp.int32(3),
        active_i=jnp.asarray(active), inf_d=inf, slot_par=dt8)
    want = [np.asarray(x) for x in out]

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    planes = [t(x) for x in (ds, dt, ps, pt)]
    nbr = t(g.nbr)
    deg = t(g.deg)
    dual_n, counts, key = minor_level_plain(stt(nbr, deg), deg, t(dual),
                                            *planes, 3, t(active), tc=tc)
    mval, midx = decode_meet(key)
    got = [dual_n, *planes, counts[0], counts[1], counts[2], mval, midx]
    for w, x in zip(want, got):
        if w.ndim == 2:
            w = w[:n_pad2]
        assert np.array_equal(w, x.numpy())
    assert (mval < INF32).any() and counts[0].sum() > 0


@pytest.mark.parametrize("b", [128, 256])
@pytest.mark.parametrize("dt8", [False, True], ids=["int32", "int8"])
def test_packed_state_round_trip(dt8, b):
    """The packed frontier and visited words round-trip their planes, pad
    rows past the table included, in the pair-row bit order of
    ``ops/bitmap.py``: bit ``2 (q & 15)`` (source) and ``2 (q & 15) + 1``
    (target) of word ``q >> 4``."""
    import torch

    from bibfs_tpu_torch.ops import bitmap
    from bibfs_tpu_torch.ops import minor_level as ml

    g, (dual, ds, dt, _ps, _pt), _active = _level_state(7, 200, b, dt8)
    assert dual.shape[0] > g.n_pad  # pad rows past the table
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    front = ml.pack_front(t(dual))
    assert front.shape == (dual.shape[0], b // 16) and front.dtype == torch.int32
    assert torch.equal(ml.unpack_front(front, t(dual).dtype), t(dual))
    vis = ml.pack_vis(t(ds), t(dt))
    inf = 127 if dt8 else INF32
    got_s, got_t = ml.unpack_sides(vis)
    assert np.array_equal(got_s.numpy(), ds < inf)
    assert np.array_equal(got_t.numpy(), dt < inf)
    for v in (0, 3, g.n - 1, dual.shape[0] - 1):
        row = bitmap.pack_pairs(t(ds[v] < inf), t(dt[v] < inf), b // 16)
        assert torch.equal(vis[v], row)
    assert (vis[g.n:] == 0).all() and (front[g.n:] == 0).all()


@pytest.mark.parametrize("tc", [8, 64, None], ids=["tc8", "tc64", "whole"])
@pytest.mark.parametrize("dt8", [False, True], ids=["int32", "int8"])
def test_packed_twin_matches_plain(dt8, tc):
    """The packed level (the twin the CPU runs) against ``minor_level_plain``
    on the same seeded state: the packed next frontier, the visited words
    rebuilt from the updated planes, the planes, the counts and the key;
    the input key is the full vote of the input state, so the output key
    is the full vote of the output state."""
    import torch

    from bibfs_tpu_torch.ops import minor_level as ml
    from bibfs_tpu_torch.ops.pull_expand import sentinel_transposed_table as stt

    g, (dual, ds, dt, ps, pt), active = _level_state(5, 300, 128, dt8)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    nbr_t = stt(t(g.nbr), t(g.deg))
    deg = t(g.deg)
    plain = [t(x) for x in (ds, dt, ps, pt)]
    dual_n, counts, key = ml.minor_level_plain(nbr_t, deg, t(dual), *plain, 3,
                                               t(active), tc=tc)
    packed = [t(x) for x in (ds, dt, ps, pt)]
    vis = ml.pack_vis(packed[0], packed[1])
    key_in = ml.meet_vote(packed[0], packed[1])
    front_n, counts_p, key_p = ml.minor_level(nbr_t, deg, ml.pack_front(t(dual)),
                                              vis, *packed, 3, t(active), key_in,
                                              tc=tc)
    for x, y in zip(plain, packed):
        assert torch.equal(x, y)
    assert torch.equal(front_n, ml.pack_front(dual_n))
    assert torch.equal(vis, ml.pack_vis(plain[0], plain[1]))
    assert torch.equal(counts_p, counts)
    assert torch.equal(key_p, key) and torch.equal(key_p, ml.meet_vote(*plain[:2]))
    assert (key != ml.NO_MEET).any() and counts[0].sum() > 0


def _level_checks(monkeypatch):
    """Wrap the loop's level call: at every level the key going in is the
    full vote of the planes going in, and the key coming out the full vote
    of the planes coming out. Returns the list of levels seen."""
    from bibfs_tpu_torch.ops import minor_level as ml
    from bibfs_tpu_torch.solvers import batch_minor as bm

    real = bm.minor_level
    seen = []

    def checked(nbr_t, deg, front, vis, ds, dt, ps, pt, lvl, active, key,
                **kw):
        import torch

        assert torch.equal(key, ml.meet_vote(ds, dt))
        assert torch.equal(vis, ml.pack_vis(ds, dt))
        out = real(nbr_t, deg, front, vis, ds, dt, ps, pt, lvl, active, key,
                   **kw)
        assert torch.equal(out[2], ml.meet_vote(ds, dt))
        seen.append(lvl)
        return out

    monkeypatch.setattr(bm, "minor_level", checked)
    return seen


@pytest.mark.parametrize("mode", ["minor", "minor8"])
@pytest.mark.parametrize("case", [0, 3, 6, 9])
def test_carried_key_is_the_full_vote(case, mode, monkeypatch):
    """A real search, level by level, on the reference's random cases: the
    key the loop carries equals the full-plane vote at every level, and
    the batch still equals the reference's."""
    seen = _level_checks(monkeypatch)
    n, edges, _, _ = CASES[case]
    rng = np.random.default_rng(11)
    pairs = rng.integers(0, n, size=(7, 2))
    pairs[2] = (1, 1)
    assert_same_batch(n, edges, pairs, mode)
    assert seen and seen[0] == 1


@pytest.mark.parametrize("graph", ["rmat-8", "star-600"])
def test_carried_key_is_the_full_vote_tiered(graph, monkeypatch):
    """The same on tiered graphs, where the hub claims after each level
    enter the visited words and the vote carried to the next level."""
    from bibfs_tpu.graph.generate import rmat_graph

    seen = _level_checks(monkeypatch)
    if graph == "rmat-8":
        n, edges = rmat_graph(8, edge_factor=6, seed=1)
        pairs = np.random.default_rng(4).integers(0, n, size=(9, 2))
    else:
        n, edges = _star()
        pairs = [(1, n - 2), (0, n - 1), (4, 4), (2, 3)]
    assert_same_batch(n, edges, pairs, "minor", "tiered")
    assert len(seen) >= 2


def test_refill_capped_geometry_fallback(monkeypatch):
    """Where the int32 planes are refused, the capped queries finish on the
    per-query sync path inside the untimed finish."""
    from bibfs_tpu_torch.solvers import batch_minor as bm
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n, edges, _, _ = CASES[1]
    _, g = _graphs(n, edges)
    pairs = np.array([[0, n - 1], [1, 2]])
    real = bm.batch_dispatch
    calls = []

    def failing_int32(g_, pairs_, dt8=False, stats=None):
        calls.append(dt8)
        if not dt8:
            raise ValueError("forced: int32 minor geometry rejected")
        return real(g_, pairs_, dt8, stats)

    monkeypatch.setattr(bm, "batch_dispatch", failing_int32)
    _, thunk, finish = real(g, pairs, dt8=True)
    out = list(thunk())
    out[-1] = out[-1].clone()
    out[-1][0] = True  # force the refill of query 0
    res = finish(tuple(out))
    assert calls == [False]
    ref = solve_serial(n, edges, 0, n - 1)
    assert (int(res[0][0]) < INF32) == ref.found
    if ref.found:
        assert int(res[0][0]) == ref.hops


def test_refill_capped_applies_finish_hook(monkeypatch):
    """The refill runs the sub-dispatch's OWN finish hook: a hook that
    undoes an offset the thunk adds must run for the splice to be right."""
    import torch

    from bibfs_tpu_torch.solvers import batch_minor as bm
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n, edges, _, _ = CASES[1]
    _, g = _graphs(n, edges)
    pairs = np.array([[0, n - 1], [1, 2]])
    real = bm.batch_dispatch
    ran = {}

    def hooked(g_, pairs_, dt8=False, stats=None):
        p, thunk, fin = real(g_, pairs_, dt8, stats)
        if dt8:
            return p, thunk, fin

        def dec_finish(out):
            ran["finish"] = True
            return tuple(torch.as_tensor(o) - 5 for o in fin(out))

        return p, lambda: tuple(o + 5 for o in thunk()), dec_finish

    monkeypatch.setattr(bm, "batch_dispatch", hooked)
    _, thunk, finish = real(g, pairs, dt8=True)
    out = list(thunk())
    out[-1] = torch.zeros_like(out[-1])
    out[-1][0] = True
    res = finish(tuple(out))
    assert ran.get("finish")
    ref = solve_serial(n, edges, 0, n - 1)
    assert (int(res[0][0]) < INF32) == ref.found
    if ref.found:
        assert int(res[0][0]) == ref.hops


def test_auto_routing_matches_reference():
    from bibfs_tpu.graph.generate import rmat_graph
    from bibfs_tpu.solvers import batch_minor as jbm

    from bibfs_tpu_torch.solvers import batch_minor as tbm

    assert tbm.small_batch_threshold("cpu") == jbm.small_batch_threshold()
    assert tbm.SMALL_BATCH_SYNC == jbm.SMALL_BATCH_SYNC
    n, edges, _, _ = CASES[0]
    nt, et = rmat_graph(8, edge_factor=6, seed=1)
    ns, es = _star(300)
    for args in ((n, edges, "ell"), (nt, et, "tiered"), (ns, es, "ell")):
        gj, gt = _graphs(*args)
        for b in (1, 31, 32, 33, 200, 5000):
            assert tbm.auto_batch_mode(gt, b) == jbm.auto_batch_mode(gj, b)
    # and through the solve: >= the threshold, the plain-ELL batch is minor8
    pairs = [(0, n - 1), (1, 1)] + [(i % n, (3 * i) % n) for i in range(32)]
    got = assert_same_batch(n, edges, pairs, "auto")
    assert {r.mode for r in got} == {"minor8"}


def test_geometry_rules_match_reference():
    from bibfs_tpu.solvers import batch_minor as jbm

    from bibfs_tpu_torch.solvers import batch_minor as tbm

    for fn in ("pad_batch",):
        for b in (0, 1, 127, 128, 129, 1000):
            assert getattr(tbm, fn)(b) == getattr(jbm, fn)(b)
    for wp, b, n_pad, item in [(8, 128, 100, 4), (32, 256, 1 << 20, 1),
                               (32, 256, 1 << 20, 4), (4096, 128, 5000, 4),
                               (49152, 128, 1 << 15, 4), (8, 4096, 10, 1)]:
        assert tbm.chunk_rows(wp, b, n_pad, item) == jbm.chunk_rows(wp, b, n_pad, item)
    for tw, b in [(8, 128), (3584, 256), (11522, 256), (100000, 128)]:
        assert tbm.tier_slab_rows(tw, b) == jbm.tier_slab_rows(tw, b)
    for n_pad in (100, 100_000, 1 << 20, 1 << 28):
        for width in (3, 27, 64, 120, 200, 50_000):
            for b in (1, 128, 1024, 4096):
                for item in (1, 4):
                    assert tbm.minor_fits(n_pad, width, b, item) == \
                        jbm.minor_fits(n_pad, width, b, item)
                    for tiers in ((), ((8, 3, 3584),)):
                        g = types.SimpleNamespace(n_pad=n_pad, width=width,
                                                  tier_meta=tiers)
                        for dt8 in (False, True):
                            try:
                                want = jbm._minor_geometry(g, b, dt8)
                            except ValueError as e:
                                with pytest.raises(ValueError) as got:
                                    tbm._minor_geometry(g, b, dt8)
                                assert str(got.value) == str(e)
                            else:
                                assert tbm._minor_geometry(g, b, dt8) == want


@pytest.mark.parametrize("kind", ["range", "minor8-tiered", "wide-minor8"])
def test_batch_errors_match_reference(kind):
    from bibfs_tpu.graph.generate import rmat_graph
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    if kind == "range":
        args, pairs, mode = (4, np.array([[0, 1]]), "ell"), [(0, 9)], "minor"
    elif kind == "minor8-tiered":
        n, e = rmat_graph(7, edge_factor=6, seed=1)
        args, pairs, mode = (n, e, "tiered"), [(0, 1)], "minor8"
    else:  # an ELL row of 199 slots: int8 parents cannot hold its slots
        n, e = _star(200)
        args, pairs, mode = (n, e, "ell"), [(0, 1)], "minor8"
    gj, gt = _graphs(*args)
    with pytest.raises(ValueError) as want:
        jd.solve_batch_graph(gj, pairs, mode=mode)
    with pytest.raises(ValueError) as got:
        td.solve_batch_graph(gt, pairs, mode=mode)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["sync", "alt", "beamer", "pallas", "fused"])
def test_per_query_batch_modes_match_reference(mode):
    """The per-query batch modes, run lock-step, give the reference's
    vmapped answers: hops, levels and edges (and the path). The batch
    reads the host once a round and once at the end, as often as its
    deepest query alone."""
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td

    for n, edges, s, d in random_graph_cases(2, seed=5):
        gj, gt = _graphs(n, edges)
        pairs = [(s, d), (d, s), (0, n - 1), (s, s)]
        a = jd.solve_batch_graph(gj, pairs, mode=mode)
        b = td.solve_batch_graph(gt, pairs, mode=mode)
        for x, y in zip(a, b):
            assert (x.found, x.hops, x.levels, x.edges_scanned, x.path) == (
                y.found, y.hops, y.levels, y.edges_scanned, y.path)
        ran = {"fused": "pallas"}.get(mode, mode)
        assert {r.mode for r in b} == {ran}
        assert b[0].host_syncs == max(
            td.solve_dense_graph(gt, p, q, mode=ran).host_syncs
            for p, q in pairs)


@pytest.mark.parametrize("mode", ["minor8", "sync"])
def test_batch_timing_protocol(mode, monkeypatch):
    """``time_batch_graph`` times ``repeats`` forced runs after one warm-up
    and stamps their median into every result; ``time_batch_only``
    returns the times alone."""
    from bibfs_tpu_torch.solvers import dense as td
    from bibfs_tpu_torch.solvers import timing
    from bibfs_tpu_torch.solvers.serial import solve_serial

    n, edges, _, _ = CASES[2]
    _, g = _graphs(n, edges)
    pairs = [(0, n - 1), (1, 2)]
    runs = []
    real = td._batch_dispatch

    def counted(*args, **kw):
        p, thunk, fin = real(*args, **kw)
        return p, lambda: runs.append(1) or thunk(), fin

    monkeypatch.setattr(td, "_batch_dispatch", counted)
    times, got = td.time_batch_graph(g, pairs, repeats=3, mode=mode)
    assert len(times) == 3 and len(runs) == 4 and len(got) == 2
    assert all(r.time_s == float(np.median(times)) for r in got)
    assert got[0].found == solve_serial(n, edges, 0, n - 1).found
    assert got[0].host_syncs == td.solve_batch_graph(g, pairs, mode=mode)[0].host_syncs
    assert len(td.time_batch_only(g, pairs, repeats=2, mode=mode)) == 2
    with pytest.raises(ValueError):
        timing.timed_batch_repeats(lambda: None, 0)
