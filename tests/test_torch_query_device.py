"""The port's device rungs of the query kinds
(``bibfs_tpu_torch.solvers.query_device``) against the JAX package's
programs (``bibfs_tpu.solvers.query_device``) on the CPU: the plain twin
of the delta-stepping kernel equals the reference's jitted program — the
f32 distance vector bit for bit, its bucket and relaxation counts — for
several bucket widths (every edge light, every edge heavy); the plain twin
of the restricted sweep kernel gives the reference's int32 planes entry
for entry under banned nodes, banned spur edges and a candidate with no
allowed first hop, for B = 1, 9 and 33; Yen's iterations through the
batched rung return the host rung's paths. On a card (``cuda`` marker)
both kernels equal their twins."""

import dataclasses

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _graphs():
    # the port's generators (equal to the reference's on these seeds), so
    # the file collects on the card's machine, which has no JAX
    from bibfs_tpu_torch.graph.generate import gnp_random_graph, grid_graph

    return {
        "gnp": (300, gnp_random_graph(300, 8 / 300, seed=2)),
        "grid": (48, grid_graph(6, 8)),
        "subcritical": (200, gnp_random_graph(200, 1.5 / 200, seed=7)),
    }


GRAPHS = _graphs()
NAMES = tuple(GRAPHS)


def _setup(name):
    from bibfs_tpu.graph.csr import build_csr, build_ell

    n, edges = GRAPHS[name]
    rp, ci = build_csr(n, edges)
    return n, rp, ci, build_ell(n, edges)


def _pairs(n, seed, k):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(k)]


# ---- delta-stepping ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", NAMES)
def test_delta_tables_equal_reference(name, seed):
    from bibfs_tpu.solvers import query_device as ref

    from bibfs_tpu_torch.solvers import query_device as port

    _n, _rp, _ci, ell = _setup(name)
    want = ref.delta_tables(ell, seed)
    got = port.delta_tables(ell, seed, device="cpu")
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("delta", ["mean", 0.5, 2.0, 20.0])
@pytest.mark.parametrize("name", NAMES)
def test_delta_twin_equals_reference_program(name, delta):
    """The plain twin against the reference's jitted while_loop on the
    same tables: dist exactly, buckets and relaxations (0.5: every edge
    heavy; 20: every edge light)."""
    import jax.numpy as jnp

    from bibfs_tpu.query.weighted import synthetic_weights
    from bibfs_tpu.solvers import query_device as ref

    from bibfs_tpu_torch.solvers import query_device as port

    n, rp, ci, ell = _setup(name)
    w = synthetic_weights(rp, ci, 2)
    d = float(w.mean()) if delta == "mean" else float(delta)
    rt = ref.delta_tables(ell, 2)
    pt = port.delta_tables(ell, 2, device="cpu")
    kern = ref._get_delta_kernel(*rt[0].shape)
    for s, t in _pairs(n, 11, 6) + [(0, 0)]:
        dist, buckets, relaxed = kern(rt[0], rt[1], jnp.int32(s),
                                      jnp.int32(t), jnp.float32(d))
        got, info = port.delta_stepping_plain(pt[0], pt[1], s, t, d)
        assert np.array_equal(got.numpy(), np.asarray(dist)), (s, t)
        assert info["buckets"] == int(buckets)
        assert info["relaxations"] == int(relaxed)
        # the dispatching wrapper takes the twin for CPU tensors
        again, info2 = port.delta_stepping(pt[0], pt[1], s, t, d)
        assert np.array_equal(again.numpy(), got.numpy()) and info2 == info


@pytest.mark.parametrize("name", NAMES)
def test_delta_stepping_device_equals_reference(name):
    """The whole device rung on the CPU: every WeightedResult field but
    the time, the path of the reference's descent."""
    from bibfs_tpu.query.weighted import path_weight, synthetic_weights
    from bibfs_tpu.solvers import query_device as ref

    from bibfs_tpu_torch.solvers import query_device as port

    n, rp, ci, ell = _setup(name)
    w = synthetic_weights(rp, ci, 5)
    rt = ref.delta_tables(ell, 5)
    pt = port.delta_tables(ell, 5, device="cpu")
    for s, t in _pairs(n, 3, 8):
        want = ref.delta_stepping_device(n, rp, ci, w, rt, s, t)
        stats: dict = {}
        got = port.delta_stepping_device(n, rp, ci, w, pt, s, t, stats=stats)
        a = dataclasses.asdict(want)
        b = dataclasses.asdict(got)
        a.pop("time_s")
        b.pop("time_s")
        assert a == b, (s, t)
        assert stats["launches"] == 0 and stats["passes"] >= 1
        if got.found:
            assert path_weight(rp, ci, w, got.path) == got.dist
    with pytest.raises(ValueError, match="delta"):
        port.delta_stepping_device(n, rp, ci, w, pt, 0, 1, delta=-1.0)


# ---- the restricted batch BFS -------------------------------------------------

def _cands(n, rp, ci, dst, b, seed):
    """``b`` spur candidates: random spurs, banned nodes (never the spur or
    dst), banned spur edges, and one spur whose every neighbour is banned
    (no allowed first hop)."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(b):
        spur = int(rng.integers(n))
        while spur == dst:
            spur = int(rng.integers(n))
        row = [int(v) for v in ci[rp[spur]:rp[spur + 1]]]
        banned = {int(x) for x in rng.choice(n, 4, replace=False)}
        edges = {(spur, v) for v in row[:1]}
        if j == 1:
            banned |= set(row)  # no allowed first hop
        banned -= {spur, dst}
        out.append((spur, banned, edges))
    return out


@pytest.mark.parametrize("b", [1, 9, 33])
@pytest.mark.parametrize("name", NAMES)
def test_restricted_twin_equals_reference_planes(name, b):
    from bibfs_tpu.solvers import query_device as ref
    from bibfs_tpu.solvers.dense import DeviceGraph as RefGraph

    from bibfs_tpu_torch.solvers import query_device as port
    from bibfs_tpu_torch.solvers.dense import DeviceGraph

    n, rp, ci, ell = _setup(name)
    rg = RefGraph.from_ell(ell)
    pg = DeviceGraph.from_ell(ell, device="cpu")
    for dst in (int(x) for x in np.random.default_rng(b).integers(0, n, 3)):
        cands = _cands(n, rp, ci, dst, b, seed=dst)
        want = ref.restricted_batch_dists(rg, rp, ci, dst, cands)
        stats: dict = {}
        got = port.restricted_batch_dists(pg, rp, ci, dst, cands, stats=stats)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), dst
        assert stats["run"] >= 0 and stats["levels"] >= 1


@pytest.mark.parametrize("name", NAMES)
def test_restricted_seeding_and_plain_loop(name):
    """The seeded plane holds 0 at each spur, 1 at its allowed first hops,
    INF32 elsewhere; the twin stops once every column froze."""
    import torch

    from bibfs_tpu.query.kshortest import first_hops

    from bibfs_tpu_torch.ops.msbfs_device import graph_csr
    from bibfs_tpu_torch.solvers import query_device as port
    from bibfs_tpu_torch.solvers.dense import DeviceGraph

    n, rp, ci, ell = _setup(name)
    dst = n - 1
    cands = _cands(n, rp, ci, dst, 5, seed=1)
    dist, blocked = port.seed_candidates(n, rp, ci, cands, 8, "cpu")
    assert dist.shape == (n, 8) and blocked.dtype == torch.int8
    for j, (spur, banned, edges) in enumerate(cands):
        mask = np.zeros(n, dtype=bool)
        mask[list(banned)] = True
        hops = first_hops(rp, ci, spur, banned_mask=mask, banned_edges=edges)
        col = dist[:, j].numpy()
        assert col[spur] == 0 and (col[hops] == 1).all()
        assert (col >= port.INF32).sum() == n - 1 - len(hops)
        assert np.array_equal(np.flatnonzero(blocked[:, j].numpy()),
                              sorted(banned))
    assert (dist[:, 5:] == port.INF32).all()  # padded columns
    pg = DeviceGraph.from_ell(ell, device="cpu")
    rpd, cid = graph_csr(pg)
    assert np.array_equal(rpd.numpy(), rp)
    assert np.array_equal(cid.numpy(), ci)
    assert graph_csr(pg)[0] is rpd  # cached on the table
    st = port.restricted_sweep(rpd, cid, dist, blocked, dst)
    assert st["run"] >= 1
    assert (dist[:, 5:] == port.INF32).all()  # padded columns never stamp


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_batched_yen_identical_to_host(name, k):
    from bibfs_tpu.query.kshortest import yen_k_shortest as ref_yen
    from bibfs_tpu.solvers import query_device as ref
    from bibfs_tpu.solvers.dense import DeviceGraph as RefGraph

    from bibfs_tpu_torch.query.kshortest import yen_k_shortest
    from bibfs_tpu_torch.solvers import query_device as port
    from bibfs_tpu_torch.solvers.dense import DeviceGraph

    n, rp, ci, ell = _setup(name)
    rg = RefGraph.from_ell(ell)
    pg = DeviceGraph.from_ell(ell, device="cpu")
    for s, d in _pairs(n, 13 + k, 5):
        if s == d:
            continue
        host = yen_k_shortest(n, rp, ci, s, d, k)
        dev = yen_k_shortest(
            n, rp, ci, s, d, k,
            spur_batch=lambda c, _d=d: port.restricted_batch_paths(
                pg, n, rp, ci, _d, c))
        want = ref_yen(n, rp, ci, s, d, k,
                       spur_batch=lambda c, _d=d: ref.restricted_batch_paths(
                           rg, n, rp, ci, _d, c))
        assert dev.paths == host.paths == want.paths
        assert dev.hops == host.hops and dev.found == host.found


def test_pad_candidates_and_tiered_refusal():
    from bibfs_tpu.solvers import query_device as ref

    from bibfs_tpu_torch.solvers import query_device as port

    for b in range(0, 300):
        assert port._pad_candidates(b) == ref._pad_candidates(b)

    class _Tiered:
        tier_meta = ((0, 1, 8),)
        n = 4

    with pytest.raises(ValueError, match="plain-ELL"):
        port.restricted_batch_dists(_Tiered(), None, None, 1, [(0, set(),
                                                               set())])
    assert port.restricted_batch_paths(_Tiered(), 4, None, None, 1, []) == []


# ---- on the card ------------------------------------------------------------

def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_delta_kernel_equals_twin(name):
    """One launch a solve; dist, buckets and relaxations of the twin."""
    import torch

    from bibfs_tpu_torch.graph.csr import build_csr, build_ell
    from bibfs_tpu_torch.query.weighted import synthetic_weights
    from bibfs_tpu_torch.solvers import query_device as port

    dev = _card()
    n, edges = GRAPHS[name]
    rp, ci = build_csr(n, edges)
    w = synthetic_weights(rp, ci, 1)
    tgt, wts = port.delta_tables(build_ell(n, edges), 1, device=dev)
    for delta in (float(w.mean()), 0.5, 20.0):
        for s, t in _pairs(n, 7, 6):
            before = port.delta_stepping.launches
            got, info = port.delta_stepping(tgt, wts, s, t, delta)
            assert port.delta_stepping.launches == before + 1
            want, winfo = port.delta_stepping_plain(tgt, wts, s, t, delta)
            assert torch.equal(got, want)
            assert (info["buckets"], info["relaxations"], info["passes"]) == \
                (winfo["buckets"], winfo["relaxations"], winfo["passes"])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 33, 70])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_restricted_kernel_equals_twin(name, b):
    """One launch a Yen iteration; the plane of the twin entry for entry."""
    import torch

    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.solvers import query_device as port

    dev = _card()
    n, edges = GRAPHS[name]
    rp, ci = build_csr(n, edges)
    rpd = torch.from_numpy(rp).to(dev)
    cid = torch.from_numpy(ci.astype(np.int32)).to(dev)
    for dst in (int(x) for x in np.random.default_rng(b).integers(0, n, 3)):
        cands = _cands(n, rp, ci, dst, b, seed=dst)
        dist, blocked = port.seed_candidates(
            n, rp, ci, cands, port._pad_candidates(b), dev)
        twin = dist.clone()
        before = port.restricted_sweep.launches
        st = port.restricted_sweep(rpd, cid, dist, blocked, dst)
        assert port.restricted_sweep.launches == before + 1
        st2 = port.restricted_sweep_plain(rpd, cid, twin, blocked, dst)
        assert torch.equal(dist, twin)
        assert (st["levels"], st["run"]) == (st2["levels"], st2["run"])
