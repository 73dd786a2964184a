"""Device-tier solvers for the weighted and k-shortest query kinds: the
counterpart of ``bibfs_tpu/solvers/query_device.py``.

Two device programs, each one hand-written CUDA kernel launched once per
solve (``csrc/query_device.cu``), each beside a plain torch twin that
mirrors the reference's XLA ``while_loop`` step by step:

- **delta-stepping** (:func:`delta_stepping_device` over
  :func:`delta_stepping`): the bucket relaxation loop of
  :mod:`bibfs_tpu_torch.query.weighted` over the serving ELL table — light
  edges (weight <= delta) relaxed to a fixpoint per bucket, heavy edges once
  per settled bucket, each pass the reference's pull over the whole table
  (each row takes the min of ``dist[nbr] + w`` over its in-bucket
  neighbours). On the card ``delta_stepping_kernel`` runs every pass in one
  cooperative launch, each pass pushing only from the in-bucket vertices
  the pass before changed (a bucket's first pass from all its members, the
  heavy pass from the member list), narrow passes in one block alone and
  wide ones across the grid; on the CPU :func:`delta_stepping_plain` runs
  the reference's passes as torch ops. Both return the reference's
  distance vector bit for bit, its bucket, relaxation and pass counts. The
  path descends on the host over the CSR weights
  (:func:`_descend_weighted`).
- **restricted batch BFS** (:func:`restricted_batch_dists` /
  :func:`restricted_batch_paths` over :func:`restricted_sweep`): every
  spur candidate of one Yen iteration is a column of one int32 ``[n, B]``
  plane, each column under its own banned-node mask, the banned spur edges
  folded into the level-1 seeding on the host (every banned edge leaves the
  spur vertex), and each column frozen after the level that stamps its
  ``dst``. On the card ``restricted_sweep_kernel`` runs every level in one
  cooperative launch over the CSR (32 candidates a uint32 word), seeded
  from index lists of the seeded entries (:func:`seed_entries`), sparse
  levels pushed from the frontier's list and dense ones pulled; on the
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

import math
import time

import numpy as np
import torch

from bibfs_tpu_torch.ops import _cuda

#: "unreachable" on the f32 distance line (far above any real path
#: weight; +w cannot reach another finite value's range)
F_INF = np.float32(3e38)

#: unreachable in the restricted-BFS int32 planes
INF32 = 1 << 30

# the kernels' [8] int64 status words, their [64] int64 working block, and
# the error words of a barrier that timed out and of a pass or level past
# the caller's limit
_STATUS_LEN = 8
_CTL_LEN = 64
_ERR_BARRIER, _ERR_DEPTH = 2, 3

#: threads of a block of either kernel
KERNEL_THREADS = 512

#: a delta-stepping pass whose entries (the changed list, plus the far list
#: on a bucket's first pass or the member list on its heavy pass) number at
#: most this many runs in one block alone: four chunks of a block's threads
DELTA_SOLO_CAP = 4 * KERNEL_THREADS

#: the most passes a delta-stepping solve may run (a guard: the kernel sets
#: its depth error past it)
MAX_PASSES = 1 << 62


def _status(name: str, status: torch.Tensor, ctl: torch.Tensor,
            err_at: int) -> list:
    """Read a launch's status words once; raise on its error word."""
    got = status.tolist()
    err = got[err_at]
    if err == _ERR_BARRIER:
        ctl.zero_()  # blocks that gave up left it mid-count
        raise RuntimeError(f"{name}: a grid barrier timed out")
    if err == _ERR_DEPTH:
        raise RuntimeError(f"{name}: past its pass or level limit")
    if err:
        raise RuntimeError(f"{name}: error word {err}")
    return got


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def ring_len(n: int) -> int:
    """Entries of one of the kernels' list rings: a power of two >= n."""
    return _pow2(max(1, n))


def ctl_block(dev: torch.device) -> torch.Tensor:
    """The kernels' working block for ``dev`` and its current stream (zero
    between launches: every launch that ends leaves it so)."""
    from bibfs_tpu_torch.ops.msbfs_device import _ctl_block

    return _ctl_block(dev, _CTL_LEN)


def delta_lanes(width: int) -> int:
    """Threads that share a row of a ``width``-slot table in
    ``delta_stepping_kernel``: a power of two, each lane loading up to two
    chunks of four slots (1 on a grid, 4 on gnp-deg8-s20's 27 slots)."""
    return min(32, _pow2(-(-int(width) // 8)))


def sweep_solo_cap(lanes: int) -> int:
    """A restricted level whose frontier has at most this many vertices
    runs in one block alone: one row for each lane group of the block."""
    return KERNEL_THREADS // int(lanes)


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


def delta_stepping(tgt, wts, src: int, dst: int, delta: float, *,
                   max_passes: int | None = None):
    """Single-source delta-stepping to ``dst`` over the tables of
    :func:`delta_tables` (a symmetric table: every edge in both rows under
    one weight) with the f32 bucket width ``delta``. On the card one launch
    of ``delta_stepping_kernel`` and one host read; on the CPU
    :func:`delta_stepping_plain`. Returns ``(dist, info)`` (``float32
    [n_pad]`` on the tables' device; ``buckets``, ``relaxations``,
    ``passes``, and on the card ``grid`` (blocks), ``solo_passes`` (run by
    one block alone, :data:`DELTA_SOLO_CAP`) and ``grid_passes``). A solve
    past ``max_passes`` (default :data:`MAX_PASSES`) raises."""
    if not tgt.is_cuda:
        return delta_stepping_plain(tgt, wts, src, dst, delta)
    check_delta(tgt, wts, src, dst)
    n_pad, width = tgt.shape
    dev = tgt.device
    dist = torch.empty((2, n_pad), dtype=torch.float32, device=dev)
    rl = ring_len(n_pad)
    rings = torch.empty((6, rl), dtype=torch.int32, device=dev)
    status = torch.empty(_STATUS_LEN, dtype=torch.int64, device=dev)
    ctl = ctl_block(dev)
    _cuda.launch(
        "query_device", "bibfs_delta_stepping", tgt.data_ptr(),
        wts.data_ptr(), n_pad, width, delta_lanes(width), int(src), int(dst),
        float(np.float32(delta)), DELTA_SOLO_CAP,
        MAX_PASSES if max_passes is None else int(max_passes),
        dist[0].data_ptr(), dist[1].data_ptr(), rings.data_ptr(), rl,
        ctl.data_ptr(), status.data_ptr(),
    )
    _cuda.count_launch(delta_stepping)
    cur, buckets, relaxed, passes, _err, grid, solo, gridp = _status(
        "delta_stepping_kernel", status, ctl, 4)
    return dist[cur], {"buckets": buckets, "relaxations": relaxed,
                       "passes": passes, "grid": grid, "solo_passes": solo,
                       "grid_passes": gridp}


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


def restricted_sweep(row_ptr, col_ind, dist, blocked, dst: int, *,
                     seeds=None, max_level: int | None = None) -> dict:
    """The restricted batch BFS over the CSR ``row_ptr int64 [n + 1]`` /
    ``col_ind int32`` from the seeded plane ``dist`` (``int32 [n, B]``: 0 at
    each column's spur, 1 at its allowed first hops, :data:`INF32`
    elsewhere), ``blocked`` (``int8 [n, B]``, nonzero = banned for that
    column) and the shared target ``dst``. Stamps ``dist`` in place. On the
    card one launch of ``restricted_sweep_kernel`` and one host read; on the
    CPU :func:`restricted_sweep_plain`. Returns ``levels`` (the last level
    that stamped), ``run`` (levels run) and, on the card, ``grid`` (blocks),
    ``dense_levels`` (pulled), ``sparse_levels`` (pushed), ``solo_levels``
    (run by one block alone, :func:`sweep_solo_cap`) and ``grid_levels``.

    The kernel reads the seeded entries, not the planes: ``seeds`` is
    :func:`seed_entries`'s pair for this plane (without it the wrapper
    lists them from the planes, one more host read). A level above
    ``max_level`` (default ``n + 1``, which no sweep reaches) raises."""
    if not dist.is_cuda:
        return restricted_sweep_plain(row_ptr, col_ind, dist, blocked, dst)
    from bibfs_tpu_torch.ops.msbfs_device import DENSE_SHARE, lanes_per_vertex

    check_sweep(row_ptr, col_ind, dist, blocked, dst)
    n, b = dist.shape
    dev = dist.device
    if seeds is None:
        seeds = _plane_entries(dist, blocked)
    entries, n_hops = seeds
    _cuda.check_dtype(torch.int32, seeds=entries)
    _cuda.check_cuda(dev, seeds=entries)
    wp = -(-b // 32)
    nnz = col_ind.numel()
    lanes = lanes_per_vertex(n, nnz)
    words = torch.empty((4, n, wp), dtype=torch.int32, device=dev)
    mark = torch.empty(n, dtype=torch.int32, device=dev)
    rl = ring_len(n)
    rings = torch.empty((3, rl), dtype=torch.int32, device=dev)
    status = torch.empty(_STATUS_LEN, dtype=torch.int64, device=dev)
    ctl = ctl_block(dev)
    _cuda.launch(
        "query_device", "bibfs_restricted_sweep", row_ptr.data_ptr(),
        col_ind.data_ptr(), n, b, lanes, int(dst),
        math.ceil(nnz * DENSE_SHARE), sweep_solo_cap(lanes),
        n + 1 if max_level is None else int(max_level), dist.data_ptr(),
        entries.data_ptr(), entries.shape[0], int(n_hops),
        *(w.data_ptr() for w in words), mark.data_ptr(), rings.data_ptr(), rl,
        ctl.data_ptr(), status.data_ptr(),
    )
    _cuda.count_launch(restricted_sweep)
    last, run, _err, grid, dense, sparse, solo, gridl = _status(
        "restricted_sweep_kernel", status, ctl, 2)
    return {"levels": last, "run": run, "grid": grid, "dense_levels": dense,
            "sparse_levels": sparse, "solo_levels": solo,
            "grid_levels": gridl}


restricted_sweep.launches = 0


def candidate_seeds(n: int, row_ptr, col_ind, cands) -> dict:
    """The seeded entries of one Yen iteration's candidates (``(spur,
    banned_nodes, banned_edges)`` triples) as int64 index arrays: the first
    hops ``hop_r``/``hop_c`` (:func:`~bibfs_tpu_torch.query.kshortest.
    first_hops`: banned targets and banned spur edges folded out), the
    spurs ``spur_r`` (candidate ``j``'s in column ``j``) and the banned
    nodes ``ban_r``/``ban_c``."""
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
    cat = lambda parts: np.concatenate(parts) if parts else np.zeros(  # noqa: E731
        0, np.int64)
    return {"hop_r": cat(hop_r), "hop_c": cat(hop_c),
            "spur_r": np.asarray(spur_r, dtype=np.int64),
            "ban_r": cat(ban_r), "ban_c": cat(ban_c)}


def seed_planes(seeds: dict, n: int, b: int, device):
    """The seeded plane and the banned-node plane of :func:`candidate_seeds`'
    entries, both ``[n, b]`` on ``device``: ``dist`` int32 with 0 at each
    spur and 1 at its allowed first hops, :data:`INF32` elsewhere, and
    ``blocked`` int8."""
    def idx(key):
        return torch.from_numpy(seeds[key]).to(device)

    dist = torch.full((n, b), INF32, dtype=torch.int32, device=device)
    dist[idx("hop_r"), idx("hop_c")] = 1
    dist[idx("spur_r"),
         torch.arange(seeds["spur_r"].size, device=device)] = 0
    blocked = torch.zeros((n, b), dtype=torch.int8, device=device)
    blocked[idx("ban_r"), idx("ban_c")] = 1
    return dist, blocked


def seed_entries(seeds: dict, device) -> tuple:
    """:func:`candidate_seeds`' entries as ``restricted_sweep_kernel``
    reads them: ``(entries, n_hops)``, ``entries`` int32 ``[m, 2]`` rows of
    ``(vertex, column)`` on ``device``, the ``n_hops`` first hops first,
    then the spurs and the banned nodes."""
    rows = np.concatenate([seeds["hop_r"], seeds["spur_r"], seeds["ban_r"]])
    cols = np.concatenate([seeds["hop_c"],
                           np.arange(seeds["spur_r"].size, dtype=np.int64),
                           seeds["ban_c"]])
    entries = np.stack([rows, cols], axis=1).astype(np.int32)
    return (torch.from_numpy(entries).to(device), int(seeds["hop_r"].size))


def _plane_entries(dist, blocked) -> tuple:
    """:func:`seed_entries` listed from the seeded planes (a host read)."""
    hops = torch.nonzero(dist == 1)
    rest = torch.cat([torch.nonzero(dist == 0), torch.nonzero(blocked != 0)])
    return (torch.cat([hops, rest]).to(torch.int32).contiguous(),
            hops.shape[0])


def seed_candidates(n: int, row_ptr, col_ind, cands, b: int, device):
    """The seeded plane and the banned-node plane of one Yen iteration's
    candidates, both ``[n, b]`` on ``device`` (:func:`seed_planes` of
    :func:`candidate_seeds`)."""
    return seed_planes(candidate_seeds(n, row_ptr, col_ind, cands), n, b,
                       device)


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
    seeds = candidate_seeds(g.n, row_ptr, col_ind, cands)
    dist, blocked = seed_planes(seeds, g.n, b_pad, g.device)
    st = restricted_sweep(rp, ci, dist, blocked, int(dst),
                          seeds=seed_entries(seeds, g.device))
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
