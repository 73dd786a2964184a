"""The port's device rungs of the query kinds
(``bibfs_tpu_torch.solvers.query_device``) against the JAX package's
programs (``bibfs_tpu.solvers.query_device``) on the CPU: the plain twin
of the delta-stepping kernel equals the reference's jitted program — the
f32 distance vector bit for bit, its bucket and relaxation counts — for
several bucket widths (every edge light, every edge heavy); the plain twin
of the restricted sweep kernel gives the reference's int32 planes entry
for entry under banned nodes, banned spur edges and a candidate with no
allowed first hop, for B = 1, 9 and 33; Yen's iterations through the
batched rung return the host rung's paths; CPU models of both kernels'
schedules (``delta_schedule``, ``sweep_schedule``) equal the reference's
programs. On a card (``cuda`` marker) both kernels equal their twins, in
one block, across the grid and handing over between the two."""

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


# ---- CPU models of the kernels' schedules -------------------------------------
# Each follows its kernel (csrc/query_device.cu, design points 1-5) pass by
# pass: the lists it walks, the counts it keeps instead of scanning, and the
# one-block rule (the same capacity test, here with small capacities so
# that both modes and the handoffs run). A race-free order stands in for the
# kernel's atomics: the first to lower a target is the first candidate in
# list order.

_FIRST, _LIGHT, _HEAVY = 0, 1, 2


def delta_schedule(tgt, wts, src, dst, delta, cap):
    """``delta_stepping_kernel``'s schedule: ``(dist, info)`` with the
    reference's ``buckets``, ``relaxations`` and ``passes`` and the split
    ``solo_passes`` / ``grid_passes`` (a pass whose entries number at most
    ``cap`` runs in one block) and ``handoffs`` (one-block stretches that
    gave way to the grid)."""
    f_inf = np.float32(3e38)
    n_pad = tgt.shape[0]
    alive = tgt < n_pad
    d32 = np.float32(delta)
    light = alive & (wts <= d32)
    heavy = alive & ~(wts <= d32)
    read = np.full(n_pad, f_inf, np.float32)  # the buffer a pass reads
    read[src] = 0
    write = read.copy()  # the buffer it pushes into
    changed = np.zeros(0, np.int64)  # lowered by the pass before
    joined = np.zeros(0, bool)  # its tags: beyond the bucket before it
    far_in, far_out = np.array([src], np.int64), []  # reached, not settled
    members = []  # the bucket's
    p = bucket = 0
    kind = _FIRST
    s_light = s_heavy = relax = buckets = settled = 0
    reached = 1
    split = {"solo_passes": 0, "grid_passes": 0, "handoffs": 0}
    solo_before = False
    while True:
        lo = np.float32(bucket) * d32
        hi = np.float32(bucket + 1) * d32
        mem = np.concatenate(members) if members else np.zeros(0, np.int64)
        work = changed.size + (far_in.size if kind == _FIRST
                               else mem.size if kind == _HEAVY else 0)
        solo = work <= cap
        split["solo_passes" if solo else "grid_passes"] += 1
        split["handoffs"] += solo_before and not solo
        solo_before = solo
        # phase A: the other buffer brought up to date at the changed
        # entries; the pass's pushers
        write[changed] = np.minimum(write[changed], read[changed])
        new = np.zeros(0, np.int64)
        if kind == _FIRST:  # the far scan: members push, the rest stay
            du = read[far_in]
            far_out = [far_in[du >= hi]]
            new = pushers = far_in[(du >= lo) & (du < hi)]
        elif kind == _LIGHT:  # the changed members; the tagged are new
            du = read[changed]
            inb = (du >= lo) & (du < hi)
            pushers = changed[inb]
            new = changed[inb & joined]
        else:  # the member list, once
            pushers = mem
        if new.size:
            members.append(new)
        new_light = int(light[new].sum())
        new_heavy = int(heavy[new].sum())
        # phase B: pushes of the class from the pass-start distances
        r, c = np.nonzero((heavy if kind == _HEAVY else light)[pushers])
        u = pushers[r]
        v = tgt[u, c].astype(np.int64)
        cand = (read[u] + wts[u, c]).astype(np.float32)
        lower = cand < read[v]
        v, cand = v[lower], cand[lower]
        lowered, first = np.unique(v, return_index=True)
        tags = read[lowered] >= hi  # beyond the bucket as the pass began
        fresh = read[lowered] == f_inf
        far_out.append(lowered[fresh & (cand[first] >= hi)])
        crossed = 0
        if kind == _HEAVY:
            low = np.full(n_pad, f_inf, np.float32)
            np.minimum.at(low, v, cand)
            crossed = int(((read[lowered] >= hi) & (low[lowered] < hi)).sum())
        np.minimum.at(write, v, cand)
        read, write = write, read
        reached += int(fresh.sum())
        p += 1
        changed, joined = lowered, tags
        if kind != _HEAVY:  # the running degree sums
            relax += s_light + new_light
            s_light += new_light
            s_heavy += new_heavy
            kind = _LIGHT if lowered.size else _HEAVY
            continue
        relax += s_heavy
        buckets += int(mem.size > 0)
        settled += mem.size + crossed
        bucket += 1
        if reached <= settled or not read[dst] >= np.float32(bucket) * d32:
            break
        kind = _FIRST
        s_light = s_heavy = 0
        far_in = np.concatenate(far_out)
        members = []
    return read, {"buckets": buckets, "relaxations": relax, "passes": p,
                  **split}


def sweep_schedule(row_ptr, col_ind, n, b, dst, seeds, dense_edges, cap):
    """``restricted_sweep_kernel``'s schedule from the seeded entries
    (``candidate_seeds``' index lists): ``(plane, info)`` with the
    reference's ``levels`` and ``run`` and the split ``dense_levels`` /
    ``sparse_levels``, ``solo_levels`` / ``grid_levels`` and
    ``compactions`` (a push after a pull lists the frontier first)."""
    rp = np.asarray(row_ptr, np.int64)
    ci = np.asarray(col_ind, np.int64)
    deg = np.diff(rp)
    dist = np.full((n, b), 1 << 30, np.int32)
    reach = np.zeros((n, b), bool)
    cols = np.arange(seeds["spur_r"].size)
    dist[seeds["spur_r"], cols] = 0
    dist[seeds["hop_r"], seeds["hop_c"]] = 1
    for rows, cs in ((seeds["spur_r"], cols), (seeds["hop_r"], seeds["hop_c"]),
                     (seeds["ban_r"], seeds["ban_c"])):
        reach[rows, cs] = True
    front = np.zeros((n, b), bool)
    front[seeds["hop_r"], seeds["hop_c"]] = True
    flist = np.unique(seeds["hop_r"])
    listed = old_listed = True
    size, dsum = flist.size, int(deg[flist].sum())
    level = last = 1
    info = dict.fromkeys(("run", "dense_levels", "sparse_levels",
                          "solo_levels", "grid_levels", "compactions"), 0)
    rows = np.repeat(np.arange(n), deg)
    while size:
        level += 1
        # a column is active while its dst is unstamped
        act = dist[dst] >= level
        dense = dsum >= dense_edges
        if not dense and not listed:
            flist = np.flatnonzero(front.any(1))
            listed = True
            info["compactions"] += 1
        solo = not dense and old_listed and size <= cap
        if dense:  # every vertex pulls its neighbours' frontier bits
            hit = np.zeros((n, b), bool)
            np.logical_or.at(hit, rows, front[ci])
            nxt = hit & ~reach & act[None, :]
        else:  # the listed frontier pushes the bits its neighbours lack
            nxt = np.zeros((n, b), bool)
            if flist.size:
                u = np.repeat(flist, deg[flist])
                v = ci[np.concatenate([np.arange(rp[x], rp[x + 1])
                                       for x in flist])]
                np.logical_or.at(nxt, v, front[u] & act[None, :] & ~reach[v])
        got = nxt.any(1)
        reach |= nxt
        dist[nxt] = level
        front = nxt
        info["run"] += 1
        info["dense_levels" if dense else "sparse_levels"] += 1
        info["solo_levels" if solo else "grid_levels"] += 1
        old_listed, listed = listed, not dense
        size, dsum = int(got.sum()), int(deg[got].sum())
        if not dense:
            flist = np.flatnonzero(got)
        if size:
            last = level
    return dist, {"levels": last, **info}


def _model_pairs(name, n, rp, ci):
    """Seeded pairs, a source that is its own target, and (where the graph
    has one) a pair in two components."""
    from bibfs_tpu_torch.oracle import multi_source_bfs

    pairs = _pairs(n, 19, 3) + [(5, 5)]
    lv = multi_source_bfs(n, rp, ci, np.array([0]))[:, 0]
    cut = np.flatnonzero(lv < 0)
    if cut.size:
        pairs.append((0, int(cut[0])))
    return pairs


@pytest.mark.parametrize("cap", [4, 2048])
@pytest.mark.parametrize("delta", ["tiny", "mean", "one"])
@pytest.mark.parametrize("name", NAMES)
def test_delta_schedule_equals_reference_program(name, delta, cap):
    """The kernel's schedule (changed lists, far scan, member list, degree
    sums, reached minus settled; one-block and grid passes by the capacity
    rule) against the reference's jitted program and the twin: distances
    bit for bit, buckets, relaxations and passes. Deltas: 0.5 (many
    buckets, every edge heavy), the mean weight, 20 (one bucket, every edge
    light)."""
    import jax.numpy as jnp

    from bibfs_tpu.query.weighted import synthetic_weights
    from bibfs_tpu.solvers import query_device as ref

    from bibfs_tpu_torch.solvers import query_device as port

    n, rp, ci, ell = _setup(name)
    w = synthetic_weights(rp, ci, 4)
    d = {"tiny": 0.5, "mean": float(w.mean()), "one": 20.0}[delta]
    rt = ref.delta_tables(ell, 4)
    pt = port.delta_tables(ell, 4, device="cpu")
    kern = ref._get_delta_kernel(*rt[0].shape)
    split = {"solo_passes": 0, "grid_passes": 0, "handoffs": 0}
    for s, t in _model_pairs(name, n, rp, ci):
        got, info = delta_schedule(pt[0].numpy(), pt[1].numpy(), s, t, d, cap)
        dist, buckets, relaxed = kern(rt[0], rt[1], jnp.int32(s),
                                      jnp.int32(t), jnp.float32(d))
        assert np.array_equal(got, np.asarray(dist)), (s, t)
        assert (info["buckets"], info["relaxations"]) == \
            (int(buckets), int(relaxed)), (s, t)
        twin, tinfo = port.delta_stepping_plain(pt[0], pt[1], s, t, d)
        assert np.array_equal(got, twin.numpy())
        assert info["passes"] == tinfo["passes"]
        assert info["solo_passes"] + info["grid_passes"] == info["passes"]
        for k in split:
            split[k] += info[k]
    if cap == 4:  # both modes, and the grid taking over from one block
        assert split["solo_passes"] and split["grid_passes"]
        assert split["handoffs"]
    else:
        assert split["grid_passes"] == 0


def test_delta_schedule_grid_pair_numbers():
    """The schedule on phase 13's grid pair (grid-500x500, 0 -> 249999,
    weight seed 0) reads the reference's numbers, every pass in one block
    at the kernel's capacity."""
    from bibfs_tpu_torch.graph.csr import build_csr, build_ell, canonical_pairs
    from bibfs_tpu_torch.graph.generate import grid_graph
    from bibfs_tpu_torch.query.weighted import synthetic_weights
    from bibfs_tpu_torch.solvers import query_device as port

    n = 500 * 500
    pairs = canonical_pairs(n, grid_graph(500, 500, perforation=0.02, seed=1))
    rp, ci = build_csr(n, pairs=pairs)
    tgt, wts = port.delta_tables(build_ell(n, pairs=pairs), 0, device="cpu")
    got, info = delta_schedule(tgt.numpy(), wts.numpy(), 0, 249999,
                               float(synthetic_weights(rp, ci, 0).mean()),
                               port.DELTA_SOLO_CAP)
    assert float(got[249999]) == 2663.0
    assert (info["buckets"], info["relaxations"], info["passes"]) == \
        (532, 2964583, 3141)
    assert info["solo_passes"] == 3141 and info["grid_passes"] == 0


def _model_cands(n, rp, ci, dst, b, seed):
    """``_cands`` with dst left banned in every third candidate."""
    out = _cands(n, rp, ci, dst, b, seed)
    return [(s, banned | ({dst} if j % 3 == 2 else set()), e)
            for j, (s, banned, e) in enumerate(out)]


@pytest.mark.parametrize("cap", [4, 1024])
@pytest.mark.parametrize("b", [1, 32, 33, 100])
@pytest.mark.parametrize("name", NAMES)
def test_sweep_schedule_equals_reference_planes(name, b, cap):
    """The kernel's schedule (seeding from index lists, pushes from lists,
    stamp-based freezes, dense pulls by the degree-sum rule, one-block
    levels by the capacity rule) against the reference's batched program
    and the twin: planes entry for entry, levels and run; dst banned in
    every third column; the columns freeze at different levels."""
    import math

    from bibfs_tpu.solvers import query_device as ref
    from bibfs_tpu.solvers.dense import DeviceGraph as RefGraph

    from bibfs_tpu_torch.ops.msbfs_device import DENSE_SHARE
    from bibfs_tpu_torch.solvers import query_device as port

    n, rp, ci, ell = _setup(name)
    rg = RefGraph.from_ell(ell)
    b_pad = port._pad_candidates(b)
    frozen = set()
    split = dict.fromkeys(("dense_levels", "sparse_levels", "solo_levels",
                           "grid_levels"), 0)
    for dst in (int(x) for x in np.random.default_rng(b + 1).integers(0, n, 3)):
        cands = _model_cands(n, rp, ci, dst, b, seed=dst + 7)
        seeds = port.candidate_seeds(n, rp, ci, cands)
        got, info = sweep_schedule(rp, ci, n, b_pad, dst, seeds,
                                   math.ceil(len(ci) * DENSE_SHARE), cap)
        want = ref.restricted_batch_dists(rg, rp, ci, dst, cands)
        assert np.array_equal(got[:, :b], want), dst
        twin, blocked = port.seed_planes(seeds, n, b_pad, "cpu")
        st = port.restricted_sweep_plain(
            torch_from(rp), torch_from(ci.astype(np.int32)), twin, blocked, dst)
        assert np.array_equal(got, twin.numpy())
        assert (info["levels"], info["run"]) == (st["levels"], st["run"])
        assert info["dense_levels"] + info["sparse_levels"] == info["run"]
        assert info["solo_levels"] + info["grid_levels"] == info["run"]
        for k in split:
            split[k] += info[k]
        frozen |= {int(x) for x in got[dst, :b] if x < port.INF32}
    if b >= 32:
        assert len(frozen) >= 2  # columns froze at different levels
    if cap == 4 and b >= 32 and name != "gnp":  # gnp's frontiers are wide
        assert split["solo_levels"] and split["grid_levels"]
    if name == "gnp":
        assert split["dense_levels"]


def torch_from(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def test_seed_entries_and_planes_agree():
    """The index lists the kernel reads and the planes the twin reads hold
    the same seeded entries: the first hops first, then spurs and banned
    nodes; listing them back from the planes gives the same set."""
    from bibfs_tpu_torch.solvers import query_device as port

    n, rp, ci, _ell = _setup("gnp")
    cands = _model_cands(n, rp, ci, 17, 40, seed=3)
    seeds = port.candidate_seeds(n, rp, ci, cands)
    entries, n_hops = port.seed_entries(seeds, "cpu")
    dist, blocked = port.seed_planes(seeds, n, 64, "cpu")
    e = entries.numpy()
    assert entries.dtype.is_floating_point is False and e.shape[1] == 2
    assert (dist.numpy()[e[:n_hops, 0], e[:n_hops, 1]] == 1).all()
    rest = {tuple(x) for x in e[n_hops:]}
    again, hops_again = port._plane_entries(dist, blocked)
    assert hops_again == n_hops
    assert {tuple(x) for x in again.numpy()[n_hops:]} == rest
    assert {tuple(x) for x in again.numpy()[:n_hops]} == \
        {tuple(x) for x in e[:n_hops]}


# ---- on the card ------------------------------------------------------------

def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_graphs():
    """The card's extra graphs: a path (every pass and level in one
    block), a gnp graph of 20,000 vertices (wide passes on the grid) and a
    40x40 grid joined to a dense G(3000, 16/3000) (a narrow wavefront that
    widens past the one-block capacities there: both modes, with
    handoffs; ``delta_schedule`` and ``sweep_schedule`` show the split on
    the CPU)."""
    from bibfs_tpu_torch.graph.generate import gnp_random_graph, grid_graph

    path = np.stack([np.arange(999), np.arange(1, 1000)], 1)
    dense = gnp_random_graph(3000, 16 / 3000, seed=5) + 1600
    joined = np.concatenate([grid_graph(40, 40), dense,
                             np.array([[1599, 1600]])])
    return {
        "path": (1000, path),
        "gnp20k": (20000, gnp_random_graph(20000, 8 / 20000, seed=3)),
        "grid+dense": (4600, joined),
    }


CARD_GRAPHS = _card_graphs()
CARD_NAMES = NAMES + tuple(CARD_GRAPHS)


def _card_graph(name):
    return CARD_GRAPHS[name] if name in CARD_GRAPHS else GRAPHS[name]


def _assert_modes(name, solo, grid):
    """The one-block and grid split each card graph is there for."""
    if name == "path":
        assert grid == 0 and solo > 0
    elif name == "gnp20k":
        assert grid > 0
    elif name == "grid+dense":
        assert solo > 0 and grid > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_NAMES)
def test_cuda_delta_kernel_equals_twin(name):
    """One launch a solve; dist, buckets, relaxations and passes of the
    twin; the split of passes between one block and the grid; the working
    block zero after each launch and after a forced depth error."""
    import torch

    from bibfs_tpu_torch.graph.csr import build_csr, build_ell
    from bibfs_tpu_torch.query.weighted import synthetic_weights
    from bibfs_tpu_torch.solvers import query_device as port

    dev = _card()
    n, edges = _card_graph(name)
    rp, ci = build_csr(n, edges)
    w = synthetic_weights(rp, ci, 1)
    tgt, wts = port.delta_tables(build_ell(n, edges), 1, device=dev)
    pairs = [(0, n - 1)] + _pairs(n, 7, 3 if name in CARD_GRAPHS else 6)
    solo = grid = 0
    deepest = (0, None)
    for delta in (float(w.mean()), 0.5, 20.0):
        for s, t in pairs:
            before = port.delta_stepping.launches
            got, info = port.delta_stepping(tgt, wts, s, t, delta)
            assert port.delta_stepping.launches == before + 1
            want, winfo = port.delta_stepping_plain(tgt, wts, s, t, delta)
            assert torch.equal(got, want), (s, t, delta)
            assert (info["buckets"], info["relaxations"], info["passes"]) == \
                (winfo["buckets"], winfo["relaxations"], winfo["passes"])
            assert info["solo_passes"] + info["grid_passes"] == info["passes"]
            solo += info["solo_passes"]
            grid += info["grid_passes"]
            if delta == 0.5:
                deepest = max(deepest, (info["passes"], (s, t)))
            torch.cuda.synchronize()
            assert not bool(port.ctl_block(dev).any())
    _assert_modes(name, solo, grid)
    if deepest[0] > 3:  # a limit of 3 passes stops it
        with pytest.raises(RuntimeError, match="limit"):
            port.delta_stepping(tgt, wts, *deepest[1], 0.5, max_passes=3)
        torch.cuda.synchronize()
        assert not bool(port.ctl_block(dev).any())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 33, 70])
@pytest.mark.parametrize("name", CARD_NAMES)
def test_cuda_restricted_kernel_equals_twin(name, b):
    """One launch a Yen iteration; the plane of the twin entry for entry,
    its levels and run; seeded from index lists or from the planes alike;
    the split of levels (dense and sparse, one block and grid); the working
    block zero after each launch and after a forced depth error."""
    import torch

    from bibfs_tpu_torch.graph.csr import build_csr
    from bibfs_tpu_torch.solvers import query_device as port

    dev = _card()
    n, edges = _card_graph(name)
    rp, ci = build_csr(n, edges)
    rpd = torch.from_numpy(rp).to(dev)
    cid = torch.from_numpy(ci.astype(np.int32)).to(dev)
    solo = grid = deepest = 0
    for dst in (int(x) for x in np.random.default_rng(b).integers(0, n, 3)):
        cands = _cands(n, rp, ci, dst, b, seed=dst)
        seeds = port.candidate_seeds(n, rp, ci, cands)
        dist, blocked = port.seed_planes(seeds, n, port._pad_candidates(b),
                                         dev)
        seeded = dist.clone()
        twin, again = dist.clone(), dist.clone()
        before = port.restricted_sweep.launches
        st = port.restricted_sweep(rpd, cid, dist, blocked, dst,
                                   seeds=port.seed_entries(seeds, dev))
        assert port.restricted_sweep.launches == before + 1
        st2 = port.restricted_sweep_plain(rpd, cid, twin, blocked, dst)
        assert torch.equal(dist, twin)
        assert (st["levels"], st["run"]) == (st2["levels"], st2["run"])
        assert st["dense_levels"] + st["sparse_levels"] == st["run"]
        assert st["solo_levels"] + st["grid_levels"] == st["run"]
        solo += st["solo_levels"]
        grid += st["grid_levels"]
        port.restricted_sweep(rpd, cid, again, blocked, dst)
        assert torch.equal(again, twin)
        torch.cuda.synchronize()
        assert not bool(port.ctl_block(dev).any())
        if st2["run"] > deepest:
            deepest, deep = st2["run"], (seeded, blocked, dst)
    if b >= 9:
        _assert_modes(name, solo, grid)
    if deepest > 2:  # the sweep needs level 3: a limit of 2 stops it
        seeded, blocked, dst = deep
        with pytest.raises(RuntimeError, match="limit"):
            port.restricted_sweep(rpd, cid, seeded, blocked, dst, max_level=2)
        torch.cuda.synchronize()
        assert not bool(port.ctl_block(dev).any())
