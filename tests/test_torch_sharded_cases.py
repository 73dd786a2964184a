"""The cases of ``test_torch_sharded.py`` and
``test_torch_sharded_tiered.py`` (no tests here): the graphs and pairs,
the port's jobs, run by one spawn of gloo ranks per world size and file
part (``sharded.sharded_jobs``), and the reference's raw sharded outputs
on its virtual CPU mesh of as many devices, its pallas modes interpreted
as its own tests run them. Raw outputs ``(best, meet, par_s, par_t,
levels, edges)`` are compared exactly (integers: no tolerance).
"""

import jax.numpy as jnp
import numpy as np

from bibfs_tpu_torch.solvers.sharded import SHARDED_MODES
from tests.conftest import random_graph_cases

WORLDS = (1, 2, 4)
MODES = tuple(SHARDED_MODES)
TIERED_MODES = ("sync", "beamer", "beamer_alt")
CASES = random_graph_cases(num=3, seed=99, nmin=60, nmax=300)
_RUNS: dict = {}


def _reach(n, edges, src):
    """Hop distances from ``src`` (-1 unreached), a host BFS."""
    from bibfs_tpu_torch.graph.csr import build_csr

    row_ptr, col = build_csr(n, edges)
    dist = np.full(n, -1)
    dist[src] = 0
    front = [src]
    while front:
        nxt = []
        for u in front:
            for v in col[row_ptr[u]:row_ptr[u + 1]]:
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    nxt.append(int(v))
        front = nxt
    return dist


def _ell_case():
    """A 200-vertex G(n, 3/n) and its pairs: two random, the reverse, a
    self pair, one ending at the highest reachable id (the last shard at 4
    devices) and one to an isolated vertex."""
    from bibfs_tpu_torch.graph.generate import gnp_random_graph

    n = 200
    edges = gnp_random_graph(n, 3.0 / n, seed=21)
    d0 = _reach(n, edges, 0)
    live = np.flatnonzero(d0 >= 0)
    iso = int(np.flatnonzero(d0 < 0)[-1])
    rng = np.random.default_rng(5)
    a, b, c = (int(x) for x in rng.choice(live, 3, replace=False))
    pairs = [(a, b), (b, a), (c, c), (0, int(live[-1])), (a, iso)]
    assert int(live[-1]) >= 168  # rows 168.. are the last of 4 shards
    return n, edges, pairs


def _line(nl=33):
    return nl, np.array([[i, i + 1] for i in range(nl - 1)])


def _rmat():
    from bibfs_tpu_torch.graph.generate import rmat_graph

    n, edges = rmat_graph(9, edge_factor=8, seed=5)
    d0 = _reach(n, edges, 0)
    live = np.flatnonzero(d0 >= 0)
    return n, edges, [(0, int(live[-1])), (int(live[len(live) // 2]), 3)]


def _star(n=600):
    edges = np.array([[0, i] for i in range(1, n)] + [[n - 1, n - 2]])
    return n, edges, [(1, n - 2), (5, 0)]


ELL = _ell_case()
LINE = _line()
RMAT = _rmat()
STAR = _star()
GRAPHS = {"ell": (*ELL[:2], "ell"), "line": (*LINE, "ell"),
          "rmat": (*RMAT[:2], "tiered"), "star": (*STAR[:2], "tiered")}
GRAPHS.update({f"case{i}": (n, e, "ell") for i, (n, e, _s, _d) in
               enumerate(CASES)})
DP_PAIRS = np.random.default_rng(9).integers(0, ELL[0], size=(150, 2))
BATCH_PAIRS = ELL[2]
UNROLLS = (("fused", 2), ("fused", 5), ("sync", 5))


def _solve(key, mode, p, tag=1, **kw):
    return ((key, mode, p, tag),
            dict(kind="solve", raw=True, graph=key, src=p[0], dst=p[1],
                 mode=mode, **kw))


def _jobs(world: int, part: str) -> list:
    """``(key, job)`` of every case of one world size and file part
    (``"ell"`` or ``"tiered"``)."""
    jobs = []
    if part == "ell":
        jobs += [_solve("ell", m, p) for m in MODES for p in ELL[2]]
        jobs += [_solve(f"case{i}", "sync", (s, d))
                 for i, (_n, _e, s, d) in enumerate(CASES)]
        jobs.append((("batch", "ell", "sync"),
                     dict(kind="batch", graph="ell", pairs=BATCH_PAIRS,
                          mode="sync")))
        jobs += [(("dp", dt8), dict(kind="dp", graph="ell", pairs=DP_PAIRS,
                                    dt8=dt8)) for dt8 in (False, True)]
        s, d = ELL[2][0]
        jobs.append((("result", "fused"), dict(kind="solve", graph="ell",
                                               src=s, dst=d, mode="fused")))
        jobs.append((("profile", "fused"),
                     dict(kind="profile", graph="ell", src=s, dst=d,
                          mode="fused", repeats=2)))
        return jobs
    for key, (_n, _e, pairs) in (("rmat", RMAT), ("star", STAR)):
        jobs += [_solve(key, m, p) for m in TIERED_MODES for p in pairs]
    for key, p in (("line", (0, LINE[0] - 1)), ("ell", ELL[2][3])):
        jobs += [_solve(key, m, p, k, unroll=k) for m, k in UNROLLS]
        jobs += [_solve(key, m, p) for m, _k in UNROLLS]
    jobs.append(_solve("ell", "beamer", ELL[2][0], "cap2", push_cap=2))
    jobs.append((("batch", "rmat", "beamer"),
                 dict(kind="batch", graph="rmat", pairs=RMAT[2],
                      mode="beamer")))
    return jobs


def port(world: int, part: str) -> dict:
    """Every case of one world size and part, from one spawn of gloo
    ranks."""
    if (world, part) not in _RUNS:
        from bibfs_tpu_torch.parallel.mesh import launch
        from bibfs_tpu_torch.solvers.sharded import build_host_graph, sharded_jobs

        graphs = {k: build_host_graph(n, e, world, layout=lay)
                  for k, (n, e, lay) in GRAPHS.items()}
        jobs = _jobs(world, part)
        out = launch(sharded_jobs, world, graphs, [j for _k, j in jobs],
                     device="cpu", timeout_s=600)
        assert out["transport"] == "gloo"
        _RUNS[world, part] = dict(zip((k for k, _j in jobs), out["results"]))
    return _RUNS[world, part]


_REF_GRAPHS: dict = {}


def _ref_graph(key: str, world: int):
    from bibfs_tpu.parallel.mesh import make_1d_mesh
    from bibfs_tpu.solvers.sharded import ShardedGraph

    if (key, world) not in _REF_GRAPHS:
        n, e, layout = GRAPHS[key]
        _REF_GRAPHS[key, world] = ShardedGraph.build(
            n, e, make_1d_mesh(world), layout=layout, pad_multiple=8 * world)
    return _REF_GRAPHS[key, world]


def ref_raw(key: str, world: int, mode: str, pair, unroll: int = 1,
            push_cap: int | None = None):
    """The reference's raw sharded outputs for one pair."""
    from bibfs_tpu.parallel.mesh import VERTEX_AXIS
    from bibfs_tpu.solvers import sharded as js
    from bibfs_tpu.solvers.dense import kernel_cap

    g = _ref_graph(key, world)
    cap = kernel_cap(mode, g.n_pad) if push_cap is None else push_cap
    fn = js._compiled_sharded(g.mesh, VERTEX_AXIS, mode, cap, g.tier_meta,
                              js._shard_geom(g), unroll)
    out = fn(g.nbr, g.deg, g.aux, jnp.int32(pair[0]), jnp.int32(pair[1]))
    return (int(out[0]), int(out[1]), np.asarray(out[2]), np.asarray(out[3]),
            int(out[4]), int(out[5]))


def assert_same_raw(got, want, what):
    """``got`` = the port's ``(ran, best, meet, par_s, par_t, levels,
    edges)``."""
    assert got[1:3] == want[:2] and got[5:] == want[4:], (what, got, want)
    assert np.array_equal(got[3], want[2]), what
    assert np.array_equal(got[4], want[3]), what


def check_shared_with_dense(cases, part: str):
    """The reference's sharded search shares all six raw outputs with its
    dense search, mode by mode, at 4 devices (the card's phase holds the
    port to that), and so do the port's sharded and dense searches.
    ``cases`` holds ``(graph key, mode, pairs)``."""
    from bibfs_tpu.solvers import dense as jd

    from bibfs_tpu_torch.solvers import dense as td
    from bibfs_tpu_torch.solvers.sharded import RAW_FIELDS

    for key, mode, pairs in cases:
        n, e, layout = GRAPHS[key]
        gj = jd.DeviceGraph.build(n, e, layout=layout)
        gt = td.DeviceGraph.build(n, e, layout=layout, device="cpu")
        kj = jd._get_kernel(mode, jd.kernel_cap(mode, gj.n_pad), gj.tier_meta,
                            jd._geom_of(gj), 1)
        for p in pairs:
            sh = ref_raw(key, 4, mode, p)
            dn = kj(gj.nbr, gj.deg, gj.aux, jd._device_scalar(p[0]),
                    jd._device_scalar(p[1]))
            port_dn = td._run(gt, p[0], p[1], mode, 1, None)
            port_sh = port(4, part)[key, mode, p, 1][1:]
            for i, name in enumerate(RAW_FIELDS):
                a, b = np.asarray(sh[i]), np.asarray(dn[i])
                c, d = np.asarray(port_sh[i]), np.asarray(port_dn[i])
                if a.ndim:  # parent rows: the first n (the pads differ)
                    a, b, c, d = a[:n], b[:n], c[:n], d[:n]
                assert np.array_equal(a, b), (key, mode, p, name)
                assert np.array_equal(c, d), (key, mode, p, name)
