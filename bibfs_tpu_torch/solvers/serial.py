"""Serial host bidirectional BFS: the port's own correctness oracle.

Level-synchronous, smaller-frontier-first, numpy-vectorized over the
whole frontier, with the provably-correct stop: keep the best meet
candidate and stop once ``level_s + level_t >= best``.
"""

from __future__ import annotations

import time

import numpy as np

from bibfs_tpu_torch.graph.csr import build_csr
from bibfs_tpu_torch.solvers.api import BFSResult, register

_INF = np.iinfo(np.int64).max // 4


def _expand(
    frontier: np.ndarray,
    row_ptr: np.ndarray,
    col_ind: np.ndarray,
    dist_self: np.ndarray,
    parent_self: np.ndarray,
    level_next: int,
) -> tuple[np.ndarray, int]:
    """One BFS level: visit all unvisited neighbours of ``frontier``.
    Returns (new frontier, directed edges scanned); the first (lowest CSR
    position) discovering edge claims the parent."""
    starts = row_ptr[frontier]
    counts = row_ptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64), 0
    offs = np.cumsum(counts) - counts
    flat = np.arange(total, dtype=np.int64)
    src_pos = np.repeat(np.arange(frontier.size), counts)
    gather_idx = flat - offs[src_pos] + starts[src_pos]
    neigh = col_ind[gather_idx]
    par = frontier[src_pos]
    new_mask = dist_self[neigh] == _INF
    neigh, par = neigh[new_mask], par[new_mask]
    uniq, first = np.unique(neigh, return_index=True)
    dist_self[uniq] = level_next
    parent_self[uniq] = par[first]
    return uniq, total


def solve_serial(n: int, edges: np.ndarray, src: int, dst: int) -> BFSResult:
    row_ptr, col_ind = build_csr(n, edges)
    return solve_serial_csr(n, row_ptr, col_ind, src, dst)


def solve_serial_csr(
    n: int, row_ptr: np.ndarray, col_ind: np.ndarray, src: int, dst: int,
    *, cutoff: int | None = None,
) -> BFSResult:
    """``cutoff`` is a proven upper bound on the true distance: it seeds
    the meet bound at ``cutoff + 1``, so the stop rule ``level_s +
    level_t >= best`` ends the search past it. Any path of length ``d <=
    cutoff`` is recorded as a meet candidate before the seeded bound can
    trigger, so found answers stay exact; a bound that is too small can
    only turn a reachable pair into "not found" (callers re-solve such a
    pair without the seed)."""
    if not (0 <= src < n and 0 <= dst < n):
        raise ValueError(f"src/dst out of range for n={n}")
    t0 = time.perf_counter()
    if src == dst:
        return BFSResult(True, 0, [src], src, time.perf_counter() - t0, 0, 0)

    dist_s = np.full(n, _INF, dtype=np.int64)
    dist_t = np.full(n, _INF, dtype=np.int64)
    parent_s = np.full(n, -1, dtype=np.int64)
    parent_t = np.full(n, -1, dtype=np.int64)
    dist_s[src] = 0
    dist_t[dst] = 0
    frontier_s = np.array([src], dtype=np.int64)
    frontier_t = np.array([dst], dtype=np.int64)
    level_s = level_t = 0
    best = _INF if cutoff is None else min(_INF, int(cutoff) + 1)
    meet = -1
    levels = 0
    edges_scanned = 0

    while frontier_s.size and frontier_t.size and level_s + level_t < best:
        if frontier_s.size <= frontier_t.size:  # smaller-frontier-first
            level_s += 1
            frontier_s, scanned = _expand(
                frontier_s, row_ptr, col_ind, dist_s, parent_s, level_s
            )
            newly, mine, other = frontier_s, dist_s, dist_t
        else:
            level_t += 1
            frontier_t, scanned = _expand(
                frontier_t, row_ptr, col_ind, dist_t, parent_t, level_t
            )
            newly, mine, other = frontier_t, dist_t, dist_s
        levels += 1
        edges_scanned += scanned
        hit = newly[other[newly] != _INF]
        if hit.size:
            sums = mine[hit] + other[hit]
            k = int(np.argmin(sums))
            if int(sums[k]) < best:
                best = int(sums[k])
                meet = int(hit[k])
    elapsed = time.perf_counter() - t0

    if meet < 0:  # no meet recorded (best may hold the cutoff seed)
        return BFSResult(False, None, None, None, elapsed, levels, edges_scanned)
    path = _reconstruct(parent_s, parent_t, meet)
    return BFSResult(True, best, path, meet, elapsed, levels, edges_scanned)


def _reconstruct(
    parent_s: np.ndarray, parent_t: np.ndarray, meet: int
) -> list[int]:
    """Walk parents from the meet vertex to both endpoints."""
    left = [meet]
    while parent_s[left[-1]] != -1:
        left.append(int(parent_s[left[-1]]))
    right = []
    v = meet
    while parent_t[v] != -1:
        v = int(parent_t[v])
        right.append(v)
    return list(reversed(left)) + right


@register("serial")
def _serial_backend(n, edges, src, dst, **_):
    return solve_serial(n, edges, src, dst)
