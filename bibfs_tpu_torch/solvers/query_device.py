"""Device-tier solvers for the weighted and k-shortest query kinds: the
counterpart of ``bibfs_tpu/solvers/query_device.py``.

Two device programs, each one hand-written CUDA kernel launched once per
solve (``csrc/query_device.cu``), each beside a plain torch twin that
mirrors the reference's XLA ``while_loop`` step by step:

- **delta-stepping** (:func:`delta_stepping_device` over
  :func:`delta_stepping`): the bucket relaxation loop of
  :mod:`bibfs_tpu_torch.query.weighted` over the serving ELL table — light
  edges (weight <= delta) relaxed to a fixpoint per bucket, heavy edges once
  per settled bucket, every pass a pull over the whole table (each row takes
  the min of ``dist[nbr] + w`` over its in-bucket neighbours). On the card
  ``delta_stepping_kernel`` runs every pass in one cooperative launch with
  grid barriers between them; on the CPU :func:`delta_stepping_plain` runs
  the same passes as torch ops. Both return the reference's distance vector
  bit for bit, its bucket count and its relaxation count. The path descends
  on the host over the CSR weights (:func:`_descend_weighted`).
- **restricted batch BFS** (:func:`restricted_batch_dists` /
  :func:`restricted_batch_paths` over :func:`restricted_sweep`): every
  spur candidate of one Yen iteration is a column of one int32 ``[n, B]``
  plane, each column under its own banned-node mask, the banned spur edges
  folded into the level-1 seeding on the host (every banned edge leaves the
  spur vertex), and each column frozen after the level that stamps its
  ``dst``. On the card ``restricted_sweep_kernel`` runs every level in one
  cooperative launch over the CSR (32 candidates a uint32 word); on the
  CPU :func:`restricted_sweep_plain` runs the reference's levels as torch
  ops. The plane equals the reference's entry for entry. Paths descend
  through the same canonical min-id rule as the host rung
  (:func:`bibfs_tpu_torch.query.kshortest.descend_min_id`), so batched Yen's
  returns the host rung's paths.

A CUDA tensor launches the kernel or raises; nothing falls back to a twin.
Launches count in ``delta_stepping.launches`` and
``restricted_sweep.launches``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bibfs_tpu_torch.ops import _cuda

#: "unreachable" on the f32 distance line (far above any real path
#: weight; +w cannot reach another finite value's range)
F_INF = np.float32(3e38)

#: unreachable in the restricted-BFS int32 planes
INF32 = 1 << 30

# the kernels' [6] int64 status words, and the error word of a barrier
# that timed out
_STATUS_LEN = 6
_ERR_BARRIER = 2


def _status(name: str, status: torch.Tensor, ctl: torch.Tensor,
            err_at: int) -> list:
    """Read a launch's status words once; raise on its error word."""
    got = status.tolist()
    err = got[err_at]
    if err == _ERR_BARRIER:
        ctl.zero_()  # blocks that gave up left it mid-count
        raise RuntimeError(f"{name}: a grid barrier timed out")
    if err:
        raise RuntimeError(f"{name}: error word {err}")
    return got


# ---- device delta-stepping ---------------------------------------------------

def delta_tables(ell, seed: int, device=None):
    """The relaxation tables for one (ELL, seed) on ``device`` (default
    ``cuda``): masked targets ``int32 [n_pad, width]`` (dead slots -> the
    dump row ``n_pad``) and the ELL-aligned derived weights ``float32``
    (:func:`bibfs_tpu_torch.query.weighted.ell_weights`, the same hash as
    the CSR derivation). Uploaded once and memoized per runtime by the
    serving layer."""
    from bibfs_tpu_torch.query.weighted import ell_weights
    from bibfs_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    alive = (
        np.arange(ell.width, dtype=np.int64)[None, :] < ell.deg[:, None]
    )
    tgt = np.where(alive, ell.nbr.astype(np.int32), np.int32(ell.n_pad))
    wts = ell_weights(ell.nbr, ell.deg, seed)
    return (torch.from_numpy(np.ascontiguousarray(tgt)).to(dev),
            torch.from_numpy(np.ascontiguousarray(wts)).to(dev))


def delta_stepping_plain(tgt, wts, src: int, dst: int, delta: float, *,
                         on_pass=None):
    """Plain torch twin of :func:`delta_stepping`, on any device: the
    reference program's loops one for one (f32 bounds ``f32(bi) * delta``,
    f32 sums, Jacobi passes). Returns ``(dist, info)``: ``float32
    [n_pad]`` and ``buckets``, ``relaxations``, ``passes``. ``on_pass``
    (optional) sees every relaxation pass as ``on_pass(frontier, old,
    new, relaxed)``: the in-bucket mask ``bool [n_pad]``, the distances
    before and after the pass, and its relaxations."""
    dev = tgt.device
    n_pad = tgt.shape[0]
    d32 = torch.tensor(float(np.float32(delta)), dtype=torch.float32,
                       device=dev)
    inf = torch.tensor(float(F_INF), dtype=torch.float32, device=dev)
    light = wts <= d32
    dist = torch.full((n_pad,), float(F_INF), dtype=torch.float32,
                      device=dev)
    dist[int(src)] = 0.0

    def bound(bi: int):
        return torch.tensor(float(bi), dtype=torch.float32, device=dev) * d32

    def relax(d, frontier, sel):
        if tgt.shape[1] == 0:
            return d, 0
        fr_p = torch.cat([frontier, frontier.new_zeros(1)])
        d_p = torch.cat([d, inf.view(1)])
        cand = torch.where(fr_p[tgt] & sel, d_p[tgt] + wts, inf)
        nd = torch.minimum(d, cand.min(dim=1).values)
        cnt = int((cand < inf).sum())
        if on_pass is not None:
            on_pass(frontier, d, nd, cnt)
        return nd, cnt

    bi = buckets = relaxed = passes = 0
    while True:
        lo = bound(bi)
        pending = ((dist < inf) & (dist >= lo)).any() & (dist[int(dst)] >= lo)
        if not bool(pending):
            break
        hi = bound(bi + 1)
        changed = True
        while changed:  # light fixpoint: reinsertions re-relax
            nd, cnt = relax(dist, (dist >= lo) & (dist < hi), light)
            changed = bool((nd < dist).any())
            dist = nd
            relaxed += cnt
            passes += 1
        settled = (dist >= lo) & (dist < hi)
        had = bool(settled.any())
        dist, cnt = relax(dist, settled, ~light)  # heavy: once
        buckets += int(had)
        relaxed += cnt
        passes += 1
        bi += 1
    return dist, {"buckets": buckets, "relaxations": relaxed,
                  "passes": passes}


def check_delta(tgt, wts, src: int, dst: int) -> None:
    """Validate a launch's inputs on the card."""
    if tgt.dim() != 2 or wts.shape != tgt.shape:
        raise ValueError("tgt and wts must be [n_pad, width] alike")
    if not (0 <= int(src) < tgt.shape[0] and 0 <= int(dst) < tgt.shape[0]):
        raise ValueError("src/dst out of range")
    _cuda.check_dtype(torch.int32, tgt=tgt)
    _cuda.check_dtype(torch.float32, wts=wts)
    _cuda.check_cuda(tgt.device, tgt=tgt, wts=wts)


def delta_stepping(tgt, wts, src: int, dst: int, delta: float):
    """Single-source delta-stepping to ``dst`` over the tables of
    :func:`delta_tables` with the f32 bucket width ``delta``. On the card
    one launch of ``delta_stepping_kernel`` and one host read; on the CPU
    :func:`delta_stepping_plain`. Returns ``(dist, info)`` (``float32
    [n_pad]`` on the tables' device; ``buckets``, ``relaxations``,
    ``passes``, and on the card ``grid``)."""
    if not tgt.is_cuda:
        return delta_stepping_plain(tgt, wts, src, dst, delta)
    from bibfs_tpu_torch.ops.msbfs_device import _ctl_block

    check_delta(tgt, wts, src, dst)
    n_pad, width = tgt.shape
    dev = tgt.device
    dist = torch.empty((2, n_pad), dtype=torch.float32, device=dev)
    status = torch.empty(_STATUS_LEN, dtype=torch.int64, device=dev)
    ctl = _ctl_block(dev)
    _cuda.launch(
        "query_device", "bibfs_delta_stepping", tgt.data_ptr(),
        wts.data_ptr(), n_pad, width, int(src), int(dst),
        float(np.float32(delta)), dist[0].data_ptr(), dist[1].data_ptr(),
        ctl.data_ptr(), status.data_ptr(),
    )
    _cuda.count_launch(delta_stepping)
    cur, buckets, relaxed, passes, _err, grid = _status(
        "delta_stepping_kernel", status, ctl, 4)
    return dist[cur], {"buckets": buckets, "relaxations": relaxed,
                       "passes": passes, "grid": grid}


delta_stepping.launches = 0


def delta_stepping_device(n: int, row_ptr, col_ind, weights, tables,
                          src: int, dst: int, *,
                          delta: float | None = None,
                          stats: dict | None = None):
    """Exact single-source shortest path to ``dst`` on the device tier
    (module docstring). ``weights`` is the CSR-aligned float64 derivation
    (the path-descent truth and the delta default); ``tables`` the
    uploaded ``(tgt, wts)`` pair from :func:`delta_tables`. Returns a
    :class:`~bibfs_tpu_torch.query.types.WeightedResult` with the
    reference's ``dist``, ``buckets`` and ``relaxations``; ``stats``
    (optional) receives the passes and launches."""
    from bibfs_tpu_torch.query.types import WeightedResult

    t0 = time.perf_counter()
    src, dst = int(src), int(dst)
    if delta is None:
        delta = float(weights.mean()) if weights.size else 1.0
    delta = float(delta)
    if delta <= 0:
        raise ValueError(f"delta must be > 0, got {delta}")
    tgt, wts = tables
    dist, info = delta_stepping(tgt, wts, src, dst, delta)
    dist = dist[:n].cpu().numpy()
    dval = float(dist[dst])
    found = dval < float(F_INF) / 2
    path = None
    if found:
        path = _descend_weighted(dist, row_ptr, col_ind, weights, src, dst)
    if stats is not None:
        stats.update(info, launches=1 if tgt.is_cuda else 0)
    return WeightedResult(
        found=found,
        dist=dval if found else None,
        hops=len(path) - 1 if found else None,
        path=path,
        time_s=time.perf_counter() - t0,
        relaxations=int(info["relaxations"]),
        buckets=int(info["buckets"]),
    )


def _descend_weighted(dist, row_ptr, col_ind, weights, src, dst):
    """A shortest weighted path off the distance vector: from ``dst``, step
    to the lowest-CSR-position neighbor whose distance plus the edge weight
    lands exactly on ours (integer weights: the f32 sums are exact, the
    float64 CSR weights agree bit for bit)."""
    path = [dst]
    cur = dst
    while cur != src:
        lo, hi = int(row_ptr[cur]), int(row_ptr[cur + 1])
        row = col_ind[lo:hi]
        cand = dist[row] + weights[lo:hi].astype(np.float32)
        step = np.flatnonzero(
            np.isclose(cand, dist[cur], rtol=0.0, atol=1e-3)
        )
        if step.size == 0:  # cannot happen on a consistent vector
            return None
        cur = int(row[step[0]])
        path.append(cur)
    path.reverse()
    return path


# ---- batched restricted BFS (Yen spur candidates) ----------------------------

def _pad_candidates(b: int) -> int:
    """Candidate columns padded to a power of two >= 8 (the reference's
    program ladder; padded columns never stamp)."""
    b = max(8, int(b))
    return 1 << (b - 1).bit_length()


def restricted_sweep_plain(row_ptr, col_ind, dist, blocked, dst: int) -> dict:
    """Plain torch twin of :func:`restricted_sweep`, on any device: the
    reference program's levels one for one over the CSR. Updates ``dist``
    in place; returns ``levels`` (the last level that stamped) and
    ``run`` (levels run)."""
    n = dist.shape[0]
    dev = dist.device
    deg = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    src = col_ind.to(torch.int64)
    open_ = blocked == 0
    frontier = dist == 1
    go = bool(frontier.any())
    level = last = 1
    run = 0
    while go:
        level += 1
        # per-column freeze: once dst is stamped the column stops
        act = dist[int(dst)] >= INF32
        hits = torch.zeros(dist.shape, dtype=torch.int32, device=dev)
        hits.index_add_(0, rows, frontier[src].to(torch.int32))
        nf = (dist >= INF32) & open_ & (hits > 0) & act[None, :]
        dist[nf] = level
        frontier = nf
        run += 1
        go = bool(nf.any())
        if go:
            last = level
    return {"levels": last, "run": run}


def check_sweep(row_ptr, col_ind, dist, blocked, dst: int) -> None:
    """Validate a launch's inputs on the card."""
    n = dist.shape[0]
    if row_ptr.shape != (n + 1,) or col_ind.dim() != 1:
        raise ValueError("row_ptr must be [n + 1] and col_ind 1-D")
    if blocked.shape != dist.shape or dist.dim() != 2:
        raise ValueError("dist and blocked must be [n, B] alike")
    if not 0 <= int(dst) < n:
        raise ValueError("dst out of range")
    _cuda.check_dtype(torch.int64, row_ptr=row_ptr)
    _cuda.check_dtype(torch.int32, col_ind=col_ind, dist=dist)
    _cuda.check_dtype(torch.int8, blocked=blocked)
    _cuda.check_cuda(dist.device, row_ptr=row_ptr, col_ind=col_ind,
                     blocked=blocked)


def restricted_sweep(row_ptr, col_ind, dist, blocked, dst: int) -> dict:
    """The restricted batch BFS over the CSR ``row_ptr int64 [n + 1]`` /
    ``col_ind int32`` from the seeded plane ``dist`` (``int32 [n, B]``: 0 at
    each column's spur, 1 at its allowed first hops, :data:`INF32`
    elsewhere), ``blocked`` (``int8 [n, B]``, nonzero = banned for that
    column) and the shared target ``dst``. Stamps ``dist`` in place. On the
    card one launch of ``restricted_sweep_kernel`` and one host read; on the
    CPU :func:`restricted_sweep_plain`. Returns ``levels`` (the last level
    that stamped), ``run`` (levels run) and, on the card, ``grid``."""
    if not dist.is_cuda:
        return restricted_sweep_plain(row_ptr, col_ind, dist, blocked, dst)
    from bibfs_tpu_torch.ops.msbfs_device import _ctl_block

    check_sweep(row_ptr, col_ind, dist, blocked, dst)
    n, b = dist.shape
    dev = dist.device
    wp = -(-b // 32)
    words = torch.empty((4, n, wp), dtype=torch.int32, device=dev)
    status = torch.empty(_STATUS_LEN, dtype=torch.int64, device=dev)
    ctl = _ctl_block(dev)
    _cuda.launch(
        "query_device", "bibfs_restricted_sweep", row_ptr.data_ptr(),
        col_ind.data_ptr(), n, b, int(dst), dist.data_ptr(),
        blocked.data_ptr(), *(w.data_ptr() for w in words), ctl.data_ptr(),
        status.data_ptr(),
    )
    _cuda.count_launch(restricted_sweep)
    last, run, _err, grid = _status("restricted_sweep_kernel", status, ctl,
                                    2)[:4]
    return {"levels": last, "run": run, "grid": grid}


restricted_sweep.launches = 0


def seed_candidates(n: int, row_ptr, col_ind, cands, b: int, device):
    """The seeded plane and the banned-node plane of one Yen iteration's
    candidates (``(spur, banned_nodes, banned_edges)`` triples), both
    ``[n, b]`` on ``device``: ``dist`` int32 with 0 at each spur and 1 at
    its allowed first hops (:func:`~bibfs_tpu_torch.query.kshortest.
    first_hops`: banned targets and banned spur edges folded out), and
    ``blocked`` int8."""
    from bibfs_tpu_torch.query.kshortest import first_hops

    mask = np.zeros(n, dtype=bool)
    spur_r, hop_r, hop_c, ban_r, ban_c = [], [], [], [], []
    for j, (spur, banned_nodes, banned_edges) in enumerate(cands):
        rows = np.fromiter((int(v) for v in banned_nodes), dtype=np.int64,
                           count=len(banned_nodes))
        mask[rows] = True
        hops = first_hops(row_ptr, col_ind, int(spur), banned_mask=mask,
                          banned_edges=banned_edges)
        mask[rows] = False
        spur_r.append(int(spur))
        hop_r.append(np.asarray(hops, dtype=np.int64))
        hop_c.append(np.full(len(hops), j, dtype=np.int64))
        ban_r.append(rows)
        ban_c.append(np.full(rows.size, j, dtype=np.int64))

    def idx(parts):
        return torch.from_numpy(np.concatenate(parts)).to(device)

    dist = torch.full((n, b), INF32, dtype=torch.int32, device=device)
    dist[idx(hop_r), idx(hop_c)] = 1
    dist[torch.tensor(spur_r, dtype=torch.int64, device=device),
         torch.arange(len(cands), device=device)] = 0
    blocked = torch.zeros((n, b), dtype=torch.int8, device=device)
    blocked[idx(ban_r), idx(ban_c)] = 1
    return dist, blocked


def restricted_batch_dists(g, row_ptr, col_ind, dst: int, cands, *,
                           stats: dict | None = None):
    """Solve one Yen iteration's spur candidates as ONE batched device
    sweep over the uploaded serving table ``g``
    (:class:`~bibfs_tpu_torch.solvers.dense.DeviceGraph`, plain ELL) on its
    device. ``cands`` is the ``(spur, banned_nodes set, banned_edges set)``
    list the host solver takes; ``row_ptr``/``col_ind`` the host CSR (the
    first hops). Returns the int32 ``[n, len(cands)]`` restricted distance
    planes (:data:`INF32` = unreached); ``stats`` (optional) receives the
    sweep's status."""
    from bibfs_tpu_torch.ops.msbfs_device import graph_csr

    if getattr(g, "tier_meta", ()):
        raise ValueError("batched restricted BFS is plain-ELL only")
    b_pad = _pad_candidates(len(cands))
    rp, ci = graph_csr(g)
    dist, blocked = seed_candidates(g.n, row_ptr, col_ind, cands, b_pad,
                                    g.device)
    st = restricted_sweep(rp, ci, dist, blocked, int(dst))
    if stats is not None:
        stats.update(st)
    return dist[:, : len(cands)].cpu().numpy()


def restricted_batch_paths(g, n, row_ptr, col_ind, dst: int, cands):
    """The device ``spur_batch`` for
    :func:`bibfs_tpu_torch.query.kshortest.yen_k_shortest`: the batched
    restricted distance planes and the canonical min-id descent — one
    tail-path-or-None per candidate, the host solver's answers."""
    from bibfs_tpu_torch.query.kshortest import descend_min_id

    if not cands:
        return []
    planes = restricted_batch_dists(g, row_ptr, col_ind, dst, cands)
    out = []
    for j, (spur, _bn, banned_edges) in enumerate(cands):
        col = planes[:, j]
        dist = np.where(col >= INF32, np.int32(-1), col)
        out.append(descend_min_id(
            row_ptr, col_ind, dist, spur, dst,
            banned_edges=banned_edges,
        ))
    return out


def solve_query_device(n: int, pairs, row_ptr, col_ind, q, device=None):
    """One ``MultiSource``, ``Weighted`` or ``KShortest`` query on the
    device tier over tables built for this graph alone (``pairs`` its
    canonical pairs, ``row_ptr``/``col_ind`` its CSR), on ``device``
    (default ``cuda``; ``"cpu"`` runs the plain twins): the rungs the
    serving engine's device kind routes run — the multi-source sweep
    (:func:`bibfs_tpu_torch.ops.msbfs_device.msbfs_plane_graph`),
    :func:`delta_stepping_device`, and Yen's with
    :func:`restricted_batch_paths` as its ``spur_batch``. The answers are
    the host rung's."""
    from bibfs_tpu_torch.graph.csr import build_ell
    from bibfs_tpu_torch.query.types import KShortest, MultiSource, Weighted
    from bibfs_tpu_torch.utils.platform import resolve_device

    if not isinstance(q, (MultiSource, Weighted, KShortest)):
        raise ValueError(f"no device rung for {type(q).__name__}")
    dev = resolve_device(device)
    ell = build_ell(n, pairs=pairs)
    if isinstance(q, Weighted):
        from bibfs_tpu_torch.query.weighted import synthetic_weights

        seed = int(q.weight_seed)
        w = synthetic_weights(row_ptr, col_ind, seed)
        return delta_stepping_device(
            n, row_ptr, col_ind, w, delta_tables(ell, seed, device=dev),
            int(q.src), int(q.dst))
    from bibfs_tpu_torch.solvers.dense import DeviceGraph

    g = DeviceGraph.from_ell(ell, dev)
    if isinstance(q, MultiSource):
        from bibfs_tpu_torch.ops.msbfs_device import msbfs_plane_graph
        from bibfs_tpu_torch.query.msbfs import solve_multi_source

        return solve_multi_source(
            n, row_ptr, col_ind, [q],
            dist_fn=lambda sources: msbfs_plane_graph(g, sources))[0]
    from bibfs_tpu_torch.query.kshortest import yen_k_shortest

    dst = int(q.dst)
    return yen_k_shortest(
        n, row_ptr, col_ind, int(q.src), dst, int(q.k),
        spur_batch=lambda cands: restricted_batch_paths(
            g, n, row_ptr, col_ind, dst, cands))
