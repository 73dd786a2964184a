"""The port's query kinds on the host (``bibfs_tpu_torch.query``: the
weight hash, delta-stepping, Dijkstra, Yen's k-shortest, the multi-source
answering and the one-query dispatch; ``solvers.api.solve_query``, its
device tier on CPU tensors and its default to the card; the query-mix
sampler; ``bibfs-torch-solve --sources/--weighted/--kshortest``) against
the JAX package's on the CPU: weights bit for bit, every result field but
the time, identical paths, identical printed lines. The graphs
are the reference's own small ones (gnp 300, grid 6x8, a subcritical
G(200, 1.5 / 200))."""

import dataclasses

import numpy as np
import pytest


def _graphs():
    from bibfs_tpu_torch.graph.generate import gnp_random_graph, grid_graph

    return {
        "gnp": (300, gnp_random_graph(300, 8 / 300, seed=2)),
        "grid": (48, grid_graph(6, 8)),
        "subcritical": (200, gnp_random_graph(200, 1.5 / 200, seed=7)),
    }


GRAPHS = _graphs()
NAMES = tuple(GRAPHS)


def _csr(name):
    from bibfs_tpu.graph.csr import build_csr

    n, edges = GRAPHS[name]
    rp, ci = build_csr(n, edges)
    return n, rp, ci


def _fields(res, like=None) -> dict:
    """A result's fields but its time (only those of ``like`` when given:
    the port's ``BFSResult`` adds ``mode`` and ``host_syncs``)."""
    keys = dataclasses.asdict(res if like is None else like)
    return {k: v for k, v in dataclasses.asdict(res).items()
            if k != "time_s" and k in keys}


def _pairs(n, seed, k):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(k)]


# ---- weights ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5, -3])
@pytest.mark.parametrize("max_w", [1, 9, 255])
def test_edge_weight_hash_bit_for_bit(seed, max_w):
    from bibfs_tpu.query import weighted as ref

    from bibfs_tpu_torch.query import weighted as port

    rng = np.random.default_rng(abs(seed) % 97)
    a = rng.integers(0, 2**31, 500)
    b = rng.integers(0, 2**31, 500)
    got = port.edge_weight_hash(a, b, seed, max_w=max_w)
    want = ref.edge_weight_hash(a, b, seed, max_w=max_w)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # symmetric: the canonical pair is hashed
    assert np.array_equal(got, port.edge_weight_hash(b, a, seed, max_w=max_w))
    assert got.min() >= 1 and got.max() <= max_w


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("name", NAMES)
def test_synthetic_and_ell_weights_bit_for_bit(name, seed):
    from bibfs_tpu.graph.csr import build_ell
    from bibfs_tpu.query import weighted as ref

    from bibfs_tpu_torch.query import weighted as port

    n, rp, ci = _csr(name)
    want = ref.synthetic_weights(rp, ci, seed)
    got = port.synthetic_weights(rp, ci, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ell = build_ell(n, GRAPHS[name][1])
    want = ref.ell_weights(ell.nbr, ell.deg, seed)
    got = port.ell_weights(ell.nbr, ell.deg, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ---- delta-stepping and Dijkstra --------------------------------------------

@pytest.mark.parametrize("delta", [None, 0.5, 2.0, 20.0])
@pytest.mark.parametrize("name", NAMES)
def test_delta_stepping_equals_reference(name, delta):
    """Every field but the time: dist, hops, path, relaxations, buckets
    (delta 0.5: every edge heavy; 20: every edge light)."""
    from bibfs_tpu.query import weighted as ref

    from bibfs_tpu_torch.query import weighted as port

    n, rp, ci = _csr(name)
    w = ref.synthetic_weights(rp, ci, 4)
    for s, d in _pairs(n, 5, 8) + [(0, 0)]:
        want = ref.delta_stepping(n, rp, ci, w, s, d, delta=delta)
        got = port.delta_stepping(n, rp, ci, w, s, d, delta=delta)
        assert _fields(got) == _fields(want), (s, d)
        if got.found:
            assert port.path_weight(rp, ci, w, got.path) == got.dist


@pytest.mark.parametrize("name", NAMES)
def test_dijkstra_equals_reference(name):
    from bibfs_tpu.query import weighted as ref

    from bibfs_tpu_torch.query import weighted as port

    n, rp, ci = _csr(name)
    w = ref.synthetic_weights(rp, ci, 1)
    for s, d in _pairs(n, 2, 5):
        for dst in (d, None):
            wd, wp = ref.dijkstra_numpy(n, rp, ci, w, s, dst)
            gd, gp = port.dijkstra_numpy(n, rp, ci, w, s, dst)
            assert np.array_equal(gd, wd) and np.array_equal(gp, wp)
    with pytest.raises(ValueError, match="misaligned"):
        port.delta_stepping(n, rp, ci, w[:-1], 0, 1)
    with pytest.raises(ValueError, match="delta"):
        port.delta_stepping(n, rp, ci, w, 0, 1, delta=0.0)
    with pytest.raises(ValueError, match="not in graph"):
        port.path_weight(rp, ci, w, [0, 0])


# ---- Yen's k-shortest --------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("name", NAMES)
def test_yen_k_shortest_identical_paths(name, k):
    from bibfs_tpu.query import kshortest as ref

    from bibfs_tpu_torch.query import kshortest as port

    n, rp, ci = _csr(name)
    for s, d in _pairs(n, 13 + k, 5):
        want = ref.yen_k_shortest(n, rp, ci, s, d, k)
        got = port.yen_k_shortest(n, rp, ci, s, d, k)
        assert _fields(got) == _fields(want), (s, d)
        for p in got.paths:
            assert len(p) == len(set(p)) and p[0] == s and p[-1] == d


@pytest.mark.parametrize("name", NAMES)
def test_yen_first_path_through_a_given_batch_solver(name):
    """A given ``spur_batch`` also finds the first path (one candidate,
    nothing banned): the host solver's canonical path, unreachable pairs
    and ``src == dst`` included."""
    from bibfs_tpu.query import kshortest as ref

    from bibfs_tpu_torch.query import kshortest as port

    n, rp, ci = _csr(name)
    for s, d in _pairs(n, 21, 6) + [(3, 3)]:
        asked = []

        def batch(cands, _d=d):
            asked.append(list(cands))
            return port._spur_batch_host(n, rp, ci, _d, cands)

        for k in (1, 3):
            asked.clear()
            got = port.yen_k_shortest(n, rp, ci, s, d, k, spur_batch=batch)
            want = ref.yen_k_shortest(n, rp, ci, s, d, k)
            assert _fields(got) == _fields(want), (s, d, k)
            assert asked[0] == [(s, set(), set())]
            assert len(asked) >= 1 + (k > 1 and got.found and s != d)


@pytest.mark.parametrize("name", NAMES)
def test_restricted_helpers_equal_reference(name):
    """first_hops, restricted_dists, descend_min_id and bfs_restricted
    under banned nodes (a set and a mask) and banned edges, some leaving
    the source and some not."""
    from bibfs_tpu.query import kshortest as ref

    from bibfs_tpu_torch.query import kshortest as port

    n, rp, ci = _csr(name)
    rng = np.random.default_rng(3)
    for s, d in _pairs(n, 9, 6):
        row = ci[rp[s]:rp[s + 1]]
        banned = {int(x) for x in rng.choice(n, 5, replace=False)} - {s, d}
        edges = {(s, int(v)) for v in row[:2]}
        far = ci[rp[d]:rp[d + 1]]
        edges |= {(int(u), d) for u in far[:1]}
        mask = port._banned_mask(n, banned)
        assert np.array_equal(mask, ref._banned_mask(n, banned))
        for bn, be in ((None, None), (banned, None), (mask, edges),
                       (banned, edges)):
            m = port._banned_mask(n, bn)
            assert np.array_equal(
                port.first_hops(rp, ci, s, banned_mask=m, banned_edges=be),
                ref.first_hops(rp, ci, s, banned_mask=m, banned_edges=be))
            dist = port.restricted_dists(n, rp, ci, s, d, banned_mask=m,
                                         banned_edges=be)
            assert np.array_equal(dist, ref.restricted_dists(
                n, rp, ci, s, d, banned_mask=m, banned_edges=be))
            assert port.descend_min_id(rp, ci, dist, s, d, banned_edges=be) \
                == ref.descend_min_id(rp, ci, dist, s, d, banned_edges=be)
            assert port.bfs_restricted(n, rp, ci, s, d, banned_nodes=bn,
                                       banned_edges=be) == \
                ref.bfs_restricted(n, rp, ci, s, d, banned_nodes=bn,
                                   banned_edges=be)


# ---- multi-source -------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 64, 65])
@pytest.mark.parametrize("name", NAMES)
def test_solve_multi_source_equals_reference(name, k):
    """A shared source tuple (with a duplicate), distinct tuples per query,
    with and without paths; sweeps in 64-source units."""
    from bibfs_tpu.query import MultiSource as RMS
    from bibfs_tpu.query import msbfs as ref

    from bibfs_tpu_torch.query import MultiSource as PMS
    from bibfs_tpu_torch.query import msbfs as port

    n, rp, ci = _csr(name)
    rng = np.random.default_rng(k)
    k = min(k, n)
    shared = tuple(int(x) for x in rng.choice(n, k, replace=False))
    dup = shared + shared[:1]
    dsts = [int(x) for x in rng.integers(0, n, 6)]
    own = [tuple(int(x) for x in rng.choice(n, max(1, k // 2), replace=False))
           for _ in dsts]
    for srcs in ([shared] * len(dsts), [dup] * len(dsts), own):
        for with_paths in (True, False):
            want = ref.solve_multi_source(
                n, rp, ci, [RMS(s, d) for s, d in zip(srcs, dsts)],
                with_paths=with_paths)
            got = port.solve_multi_source(
                n, rp, ci, [PMS(s, d) for s, d in zip(srcs, dsts)],
                with_paths=with_paths)
            assert [_fields(r) for r in got] == [_fields(r) for r in want]


def test_path_from_dist_and_dist_fn():
    from bibfs_tpu.oracle.trees import multi_source_bfs
    from bibfs_tpu.query import msbfs as ref

    from bibfs_tpu_torch.query import MultiSource
    from bibfs_tpu_torch.query import msbfs as port

    n, rp, ci = _csr("grid")
    plane = multi_source_bfs(n, rp, ci, np.array([0, 7]))
    for d in range(n):
        assert port.path_from_dist(rp, ci, plane[:, 0], 0, d) == \
            ref.path_from_dist(rp, ci, plane[:, 0], 0, d)
    asked = []

    def dist_fn(sources):
        asked.append(list(sources))
        return multi_source_bfs(n, rp, ci, sources)

    got = port.solve_multi_source(n, rp, ci, [MultiSource((0, 7), 47)],
                                  dist_fn=dist_fn)
    assert asked == [[0, 7]] and got[0].hops == min(got[0].per_source)


# ---- the one-query dispatch, solve_query, the mix sampler, the CLI ------------

def _kinds(mod, n, seed):
    rng = np.random.default_rng(seed)
    s, d = (int(x) for x in rng.integers(0, n, 2))
    return [
        mod.PointToPoint(s, d),
        mod.MultiSource(tuple(int(x) for x in rng.choice(n, 6, replace=False)),
                        d),
        mod.Weighted(s, d, weight_seed=3),
        mod.KShortest(s, d, k=3),
    ]


@pytest.mark.parametrize("name", NAMES)
def test_solve_query_csr_and_solve_query_equal_reference(name):
    import bibfs_tpu.query as RQ
    from bibfs_tpu.query.host import solve_query_csr as ref_csr
    from bibfs_tpu.solvers.api import solve_query as ref_solve

    import bibfs_tpu_torch.query as PQ
    from bibfs_tpu_torch.query.host import solve_query_csr as port_csr
    from bibfs_tpu_torch.solvers.api import solve_query as port_solve

    n, rp, ci = _csr(name)
    edges = GRAPHS[name][1]
    for seed in range(3):
        for rq, pq in zip(_kinds(RQ, n, seed), _kinds(PQ, n, seed)):
            want = ref_csr(n, rp, ci, rq)
            assert _fields(port_csr(n, rp, ci, pq), want) == _fields(want)
            want = ref_solve(n, edges, rq)
            got = port_solve(n, edges, pq, device="cpu")
            assert _fields(got, want) == _fields(want)
    with pytest.raises(ValueError, match="store"):
        port_solve(n, edges, PQ.AsOf(PQ.PointToPoint(0, 1), 1))
    with pytest.raises(ValueError, match="AsOf"):
        port_csr(n, rp, ci, PQ.AsOf(PQ.PointToPoint(0, 1), 1))


@pytest.mark.parametrize("name", NAMES)
def test_solve_query_device_rungs_equal_reference(name):
    """``solve_query``'s device tier (the kinds' device rungs over tables of
    the one graph; their plain twins on CPU tensors) answers as the
    reference: multi-source and Yen's as its host tier (Yen's paths
    identical), delta-stepping as its device rung (the relaxations and
    buckets are the device program's)."""
    import bibfs_tpu.query as RQ
    from bibfs_tpu.graph.csr import build_ell
    from bibfs_tpu.query.weighted import synthetic_weights
    from bibfs_tpu.solvers import query_device as ref_qd
    from bibfs_tpu.solvers.api import solve_query as ref_solve

    import bibfs_tpu_torch.query as PQ
    from bibfs_tpu_torch.graph.csr import canonical_pairs
    from bibfs_tpu_torch.solvers.query_device import solve_query_device

    n, rp, ci = _csr(name)
    edges = GRAPHS[name][1]
    pairs = canonical_pairs(n, edges)
    for seed in range(3):
        for rq, pq in list(zip(_kinds(RQ, n, seed), _kinds(PQ, n, seed)))[1:]:
            if isinstance(rq, RQ.Weighted):
                want = ref_qd.delta_stepping_device(
                    n, rp, ci, synthetic_weights(rp, ci, rq.weight_seed),
                    ref_qd.delta_tables(build_ell(n, edges), rq.weight_seed),
                    rq.src, rq.dst)
            else:
                want = ref_solve(n, edges, rq)
            got = solve_query_device(n, pairs, rp, ci, pq, device="cpu")
            assert _fields(got, want) == _fields(want)
    with pytest.raises(ValueError, match="device rung"):
        solve_query_device(n, pairs, rp, ci, PQ.PointToPoint(0, 1), "cpu")


@pytest.mark.parametrize("kind", ["pt", "msbfs", "weighted", "kshortest"])
def test_solve_query_runs_on_the_card_unless_asked(kind, monkeypatch):
    """Every kind defaults to ``cuda``: without a card it raises instead of
    answering on the host; ``device="cpu"`` answers."""
    import torch

    import bibfs_tpu_torch.query as PQ
    from bibfs_tpu_torch.solvers.api import solve_query

    n, edges = GRAPHS["gnp"]
    q = dict(zip(["pt", "msbfs", "weighted", "kshortest"], _kinds(PQ, n, 0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_query(n, edges, q[kind])
    assert solve_query(n, edges, q[kind], device="cpu").found
    if kind == "pt":
        with pytest.raises(ValueError, match="host only"):
            solve_query(n, edges, q[kind], backend="serial", device="cuda")


@pytest.mark.parametrize("spec", [
    "pt=0.5,msbfs=0.2,weighted=0.15,kshortest=0.1,asof=0.05",
    "p2p=1,ms=1,w=1,ks=1", "asof=1", "pt=0.7,ms=0.3",
])
@pytest.mark.parametrize("versions", [(), (1, 2)])
def test_query_mix_equals_reference(spec, versions):
    from bibfs_tpu.serve import loadgen as ref

    from bibfs_tpu_torch.serve import loadgen as port

    mix = port.parse_query_mix(spec)
    assert mix == ref.parse_query_mix(spec)
    got = port.sample_query_mix(300, 60, mix, seed=4, ms_sources=7, k=2,
                                weight_seed=5, versions=versions)
    want = ref.sample_query_mix(300, 60, mix, seed=4, ms_sources=7, k=2,
                                weight_seed=5, versions=versions)
    assert [(type(q).__name__, dataclasses.asdict(q)) for q in got] == \
        [(type(q).__name__, dataclasses.asdict(q)) for q in want]


@pytest.mark.parametrize("spec", ["pt=0", "bogus=1", "pt", "pt=-1"])
def test_query_mix_refuses_what_the_reference_refuses(spec):
    from bibfs_tpu.serve import loadgen as ref

    from bibfs_tpu_torch.serve import loadgen as port

    with pytest.raises(ValueError):
        ref.parse_query_mix(spec)
    with pytest.raises(ValueError):
        port.parse_query_mix(spec)


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    from bibfs_tpu.graph.io import write_graph_bin

    n, edges = GRAPHS["gnp"]
    path = tmp_path_factory.mktemp("qcli") / "g.bin"
    write_graph_bin(path, n, edges)
    return str(path), n


def _no_time(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if not ln.startswith("[Time]")]


@pytest.mark.parametrize("args", [
    ["17", "--sources", "0,5,9,200"],
    ["17", "--sources", "0,5,5", "--no-path"],
    ["3", "250", "--weighted"],
    ["3", "250", "--weighted", "--weight-seed", "9"],
    ["3", "250", "--kshortest", "4"],
    ["3", "250", "--kshortest", "2", "--no-path"],
    ["3", "3", "--kshortest", "3"],
])
def test_cli_query_kinds_print_reference_lines(graph_file, args, capsys):
    from bibfs_tpu.cli import solve as jcli

    from bibfs_tpu_torch.cli import solve as tcli

    path, _n = graph_file
    assert jcli.main([path, *args]) == 0
    want = capsys.readouterr().out
    assert tcli.main([path, *args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _no_time(got) == _no_time(want) and _no_time(got)
    time_line = [ln for ln in got.splitlines() if ln.startswith("[Time]")]
    ref_line = [ln for ln in want.splitlines() if ln.startswith("[Time]")]
    assert len(time_line) == 1 and time_line[0].split(" took ")[0] == \
        ref_line[0].split(" took ")[0]
    if "--weighted" in args:  # buckets and relaxations too
        assert time_line[0].split("seconds")[1] == \
            ref_line[0].split("seconds")[1]


@pytest.mark.parametrize("args,msg", [
    (["3", "4", "--weighted", "--kshortest", "2"], "mutually exclusive"),
    (["3", "4", "--weighted", "--repeat", "2"], "single-query"),
    (["3", "4", "--weighted", "--level-stats"], "single-query"),
    (["--kshortest", "2"], "destination"),
    (["5", "--kshortest", "2"], "destination"),
    (["3", "4", "--sources", "1,2"], "replaces"),
    (["3", "--sources", "1,x"], "comma list"),
])
def test_cli_query_kinds_refuse(graph_file, args, msg, capsys):
    from bibfs_tpu_torch.cli import solve as tcli

    path, _n = graph_file
    with pytest.raises(SystemExit):
        tcli.main([path, *args])
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--sources", "0,5"], ["--weighted"],
                                  ["--kshortest", "2"]])
def test_cli_query_kinds_default_to_the_card(graph_file, flag, capsys,
                                             monkeypatch):
    """Without ``--device`` a query kind asks for the card: with none it
    fails (rc 2) and prints no answer; ``--device cpu`` answers."""
    import torch

    from bibfs_tpu_torch.cli import solve as tcli

    path, _n = graph_file
    args = [path, "250", *flag] if flag[0] == "--sources" else \
        [path, "3", "250", *flag]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(args) == 2
    out = capsys.readouterr()
    assert "CUDA is not available" in out.err and not out.out
    assert tcli.main([*args, "--device", "cpu"]) == 0
    assert "[Time]" in capsys.readouterr().out


def test_cli_query_kinds_report_bad_input(graph_file, capsys):
    from bibfs_tpu_torch.cli import solve as tcli

    path, n = graph_file
    assert tcli.main([path, "3", str(n + 5), "--weighted"]) == 2
    assert "out of range" in capsys.readouterr().err
