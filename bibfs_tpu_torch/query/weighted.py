"""Weighted shortest paths: delta-stepping over bucketed frontiers: the
counterpart of ``bibfs_tpu/query/weighted.py`` (a copy: NumPy only).

The unweighted engines advance ONE frontier per level; delta-stepping
(Meyer & Sanders) is the same frontier machinery with the frontier
split into distance buckets of width ``delta``: bucket ``i`` holds
vertices with tentative distance in ``[i*delta, (i+1)*delta)``, light
edges (weight <= delta) are relaxed iteratively until the bucket
settles, heavy edges once per settled bucket. With unit weights and
``delta=1`` this degenerates to exactly the level-synchronous BFS the
rest of the repo runs — which is why it is the right weighted
generalization of this codebase rather than a bolted-on Dijkstra.

Weights are not stored in the graph (snapshots are edge-set content —
their digest must not depend on a query-time concern): they are
DERIVED per query from a seeded symmetric hash of the edge endpoints
(:func:`synthetic_weights`), so the same ``weight_seed`` always
reproduces the same weights from the same snapshot on every replica,
and a weighted result caches per ``(snapshot, seed, s, t)``.

:func:`dijkstra_numpy` is the validation oracle — a plain binary-heap
Dijkstra with none of the bucket machinery, the independent
implementation the tests pin delta-stepping against, query by query
(and the ``weighted`` rung's fallback).
"""

from __future__ import annotations

import heapq
import time

import numpy as np

_INF = np.float64(np.inf)


def edge_weight_hash(src: np.ndarray, dst: np.ndarray, seed: int = 0,
                     *, max_w: int = 9) -> np.ndarray:
    """The ONE weight derivation: positive integer weights in
    ``[1, max_w]`` for arbitrary (src, dst) endpoint arrays, SYMMETRIC
    (hashing the canonical (min, max) pair) and deterministic in
    ``seed``. Shared by the CSR derivation below and the device rung's
    ELL-aligned table (:func:`ell_weights`) — the two layouts MUST
    weigh every edge identically or the device answers drift."""
    a = np.minimum(src, dst).astype(np.uint64)
    b = np.maximum(src, dst).astype(np.uint64)
    # splitmix-style avalanche over the canonical (min, max, seed)
    # triple — uint64 wraparound is the point, silence the warnings
    with np.errstate(over="ignore"):
        seed_mix = np.uint64(
            ((int(seed) & 0xFFFFFFFF) * 0x94D049BB133111EB)
            & 0xFFFFFFFFFFFFFFFF
        )
        h = (a * np.uint64(0x9E3779B97F4A7C15)
             ^ b * np.uint64(0xBF58476D1CE4E5B9)
             ^ seed_mix)
        h ^= h >> np.uint64(31)
        h *= np.uint64(0xD6E8FEB86659FD93)
        h ^= h >> np.uint64(27)
    return (1 + (h % np.uint64(int(max_w)))).astype(np.float64)


def synthetic_weights(row_ptr: np.ndarray, col_ind: np.ndarray,
                      seed: int = 0, *, max_w: int = 9) -> np.ndarray:
    """Per-CSR-entry weights via :func:`edge_weight_hash` — one
    vectorized mixing pass over the CSR, no Python per-edge loop."""
    n = row_ptr.shape[0] - 1
    src = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(row_ptr).astype(np.int64)
    )
    return edge_weight_hash(src, col_ind.astype(np.int64), seed,
                            max_w=max_w)


def ell_weights(nbr: np.ndarray, deg: np.ndarray, seed: int = 0, *,
                max_w: int = 9) -> np.ndarray:
    """The same derived weights aligned with an ELL table: ``float32
    [n_pad, width]``, ``+inf`` at dead/pad slots (a dead slot's
    relaxation candidate must never win a scatter-min). The live
    entries hash identically to :func:`synthetic_weights` over the
    same graph — the device delta-stepping rung's exactness leans on
    it."""
    n_pad, width = nbr.shape
    rows = np.repeat(np.arange(n_pad, dtype=np.int64), width)
    w = edge_weight_hash(
        rows, nbr.astype(np.int64).ravel(), seed, max_w=max_w
    ).reshape(n_pad, width).astype(np.float32)
    alive = np.arange(width, dtype=np.int64)[None, :] < deg[:, None]
    return np.where(alive, w, np.float32(np.inf))


def delta_stepping(n: int, row_ptr: np.ndarray, col_ind: np.ndarray,
                   weights: np.ndarray, src: int, dst: int, *,
                   delta: float | None = None):
    """Exact single-source shortest path to ``dst`` by delta-stepping.

    Returns a :class:`~bibfs_tpu_torch.query.types.WeightedResult`. ``delta``
    defaults to the mean edge weight (the standard heuristic; any
    positive value is exact, only the bucket count changes). Stops
    early once every remaining bucket's lower bound exceeds the best
    distance to ``dst`` — the s-t pruning the serving path wants."""
    from bibfs_tpu_torch.query.types import WeightedResult

    t0 = time.perf_counter()
    src, dst = int(src), int(dst)
    if weights.shape[0] != col_ind.shape[0]:
        raise ValueError(
            f"weights misaligned: {weights.shape[0]} entries for "
            f"{col_ind.shape[0]} CSR slots"
        )
    if delta is None:
        delta = float(weights.mean()) if weights.size else 1.0
    delta = float(delta)
    if delta <= 0:
        raise ValueError(f"delta must be > 0, got {delta}")
    dist = np.full(n, _INF, dtype=np.float64)
    parent = np.full(n, -1, dtype=np.int64)
    dist[src] = 0.0
    light = weights <= delta
    buckets: dict[int, set] = {0: {src}}
    relaxations = 0
    processed = 0
    bi = 0
    while buckets:
        while bi not in buckets:
            bi += 1
            if bi > max(buckets):
                break
        if bi not in buckets:
            break
        if dist[dst] < bi * delta:
            break  # every remaining vertex is provably farther than dst
        settled: set = set()
        # light-edge phase: reinsertions within the bucket re-relax
        while buckets.get(bi):
            frontier = np.array(sorted(buckets.pop(bi)), dtype=np.int64)
            settled.update(int(v) for v in frontier)
            relaxations += _relax(
                frontier, row_ptr, col_ind, weights, light, dist,
                parent, buckets, delta, heavy=False,
            )
        # heavy-edge phase: once, from everything the bucket settled
        if settled:
            frontier = np.array(sorted(settled), dtype=np.int64)
            relaxations += _relax(
                frontier, row_ptr, col_ind, weights, light, dist,
                parent, buckets, delta, heavy=True,
            )
        processed += 1
        bi += 1
    found = bool(np.isfinite(dist[dst]))
    path = None
    if found:
        path = [dst]
        while path[-1] != src:
            path.append(int(parent[path[-1]]))
        path.reverse()
    return WeightedResult(
        found=found,
        dist=float(dist[dst]) if found else None,
        hops=len(path) - 1 if found else None,
        path=path,
        time_s=time.perf_counter() - t0,
        relaxations=relaxations,
        buckets=processed,
    )


def _relax(frontier, row_ptr, col_ind, weights, light, dist, parent,
           buckets, delta, *, heavy: bool) -> int:
    """Relax the light (or heavy) edges out of ``frontier``, moving
    improved vertices into their new buckets. Returns edges relaxed."""
    starts = row_ptr[frontier]
    counts = row_ptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return 0
    offs = np.cumsum(counts) - counts
    src_pos = np.repeat(np.arange(frontier.size), counts)
    gather = (np.arange(total, dtype=np.int64) - offs[src_pos]
              + starts[src_pos])
    sel = ~light[gather] if heavy else light[gather]
    gather = gather[sel]
    if gather.size == 0:
        return 0
    src_pos = src_pos[sel]
    neigh = col_ind[gather]
    cand = dist[frontier[src_pos]] + weights[gather]
    better = cand < dist[neigh]
    neigh, cand = neigh[better], cand[better]
    par = frontier[src_pos[better]]
    # duplicate targets in one relax round: keep the minimum candidate
    # (np.minimum.at scatters all, then one pass recovers the winners)
    order = np.argsort(cand, kind="stable")
    neigh, cand, par = neigh[order], cand[order], par[order]
    uniq, first = np.unique(neigh, return_index=True)
    cand_u, par_u = cand[first], par[first]
    improve = cand_u < dist[uniq]
    uniq, cand_u, par_u = uniq[improve], cand_u[improve], par_u[improve]
    dist[uniq] = cand_u
    parent[uniq] = par_u
    for v, d in zip(uniq, cand_u):
        buckets.setdefault(int(d / delta), set()).add(int(v))
    return int(gather.size)


def dijkstra_numpy(n: int, row_ptr: np.ndarray, col_ind: np.ndarray,
                   weights: np.ndarray, src: int,
                   dst: int | None = None):
    """The validation oracle: binary-heap Dijkstra, independent of the
    bucket machinery. Returns ``(dist, parent)`` float64/int64 arrays;
    with ``dst`` it stops once ``dst`` settles (exact — Dijkstra
    settles in distance order)."""
    dist = np.full(n, _INF, dtype=np.float64)
    parent = np.full(n, -1, dtype=np.int64)
    dist[int(src)] = 0.0
    heap = [(0.0, int(src))]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue  # stale heap entry
        if dst is not None and u == int(dst):
            break
        lo, hi = int(row_ptr[u]), int(row_ptr[u + 1])
        for i in range(lo, hi):
            v = int(col_ind[i])
            nd = d + float(weights[i])
            if nd < dist[v]:
                dist[v] = nd
                parent[v] = u
                heapq.heappush(heap, (nd, v))
    return dist, parent


def path_weight(row_ptr, col_ind, weights, path) -> float:
    """Sum of the path's edge weights (validation aid): each edge is
    located by binary search in its source's ascending CSR row."""
    total = 0.0
    for a, b in zip(path[:-1], path[1:]):
        lo, hi = int(row_ptr[a]), int(row_ptr[a + 1])
        row = col_ind[lo:hi]
        i = int(np.searchsorted(row, b))
        if i >= row.size or row[i] != b:
            raise ValueError(f"path edge ({a}, {b}) not in graph")
        total += float(weights[lo + i])
    return total
