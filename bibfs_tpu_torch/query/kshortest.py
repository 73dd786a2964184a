"""K shortest loopless paths — Yen's algorithm over restricted BFS
solves: the counterpart of ``bibfs_tpu/query/kshortest.py`` (a copy:
NumPy only).

Yen's spur step is a RESTRICTED shortest-path solve: the base BFS with
banned nodes (the root prefix, so candidates stay loopless) and banned
spur edges (the spur edges of every accepted path sharing the root, so
candidates are new). The solve is split into two halves precisely so
the device tier can carry the expensive one:

- :func:`restricted_dists` — the restricted BFS *distance vector*
  (level-synchronous, completes the level that reaches ``dst`` and
  stops). This is the half the batched device kernel
  (:func:`bibfs_tpu_torch.solvers.query_device.restricted_batch_dists`)
  replaces: one ``[n_pad, B]`` plane solves every spur candidate of a
  Yen iteration at once, each column under its own node mask.
- :func:`descend_min_id` — the CANONICAL path off a distance vector:
  from ``dst``, step to the lowest-id neighbor one level closer. Both
  tiers descend with this one rule on host, so the host rung and the
  batched device rung produce IDENTICAL paths — the identity the
  serve-layer parity gate pins, not just equal lengths.

``yen_k_shortest(..., spur_batch=)`` is the batching seam: the default
solves each candidate serially through :func:`bfs_restricted`; the
device rung passes a batch solver and every candidate of one iteration
rides one dispatch. Results are loopless, distinct, and non-decreasing
in hop count — the properties the taxonomy tests pin edge-by-edge.
"""

from __future__ import annotations

import heapq
import time

import numpy as np


def _banned_mask(n: int, banned_nodes) -> np.ndarray | None:
    if banned_nodes is None:
        return None
    if isinstance(banned_nodes, np.ndarray):
        return banned_nodes
    mask = np.zeros(n, dtype=bool)
    for v in banned_nodes:
        mask[int(v)] = True
    return mask


def first_hops(row_ptr: np.ndarray, col_ind: np.ndarray, src: int, *,
               banned_mask=None, banned_edges=None) -> np.ndarray:
    """The allowed level-1 frontier out of ``src``: its CSR row minus
    banned targets and banned ``(src, v)`` edges. Shared with the
    device kernel's host-side seeding — banned spur edges all leave
    the spur vertex, so filtering the first hop IS the whole edge
    restriction once the node mask holds elsewhere."""
    row = col_ind[row_ptr[src]: row_ptr[src + 1]]
    if banned_edges:
        row = np.asarray(
            [v for v in row if (src, int(v)) not in banned_edges],
            dtype=col_ind.dtype,
        )
    if banned_mask is not None and row.size:
        row = row[~banned_mask[row]]
    return row


def restricted_dists(n: int, row_ptr: np.ndarray, col_ind: np.ndarray,
                     src: int, dst: int, *, banned_mask=None,
                     banned_edges=None) -> np.ndarray:
    """The restricted BFS distance vector (``int32 [n]``, -1 =
    unreached): level-synchronous sweep that COMPLETES the level which
    reaches ``dst`` and stops — every distance ``<= dist[dst]`` is
    final, which is all :func:`descend_min_id` reads. Banned edges not
    leaving ``src`` are honored too (general contract; Yen only bans
    spur-outgoing ones)."""
    src, dst = int(src), int(dst)
    dist = np.full(n, -1, dtype=np.int32)
    dist[src] = 0
    if src == dst:
        return dist
    general_bans = None
    if banned_edges:
        general_bans = {e for e in banned_edges if int(e[0]) != src}
    frontier = first_hops(
        row_ptr, col_ind, src,
        banned_mask=banned_mask, banned_edges=banned_edges,
    )
    frontier = frontier[dist[frontier] < 0]
    dist[frontier] = 1
    level = 1
    while frontier.size and dist[dst] < 0:
        level += 1
        starts = row_ptr[frontier]
        counts = row_ptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        offs = np.cumsum(counts) - counts
        src_pos = np.repeat(np.arange(frontier.size), counts)
        gather = (np.arange(total, dtype=np.int64) - offs[src_pos]
                  + starts[src_pos])
        neigh = col_ind[gather]
        if general_bans:
            u_of = frontier[src_pos]
            keep = np.asarray([
                (int(u), int(v)) not in general_bans
                for u, v in zip(u_of, neigh)
            ])
            neigh = neigh[keep]
        cand = np.unique(neigh)
        cand = cand[dist[cand] < 0]
        if banned_mask is not None and cand.size:
            cand = cand[~banned_mask[cand]]
        dist[cand] = level
        frontier = cand
    return dist


def descend_min_id(row_ptr: np.ndarray, col_ind: np.ndarray,
                   dist: np.ndarray, src: int, dst: int, *,
                   banned_edges=None):
    """THE canonical path off a restricted distance vector: walk from
    ``dst`` down the gradient, picking the LOWEST-ID neighbor one
    level closer at every step (CSR rows are id-ascending, so the
    first hit wins). Deterministic and tier-independent — the host
    rung and the device rung descend identically, so equal distance
    vectors mean equal paths. ``banned_edges`` must be the restriction
    the vector was computed under: a banned ``(u, cur)`` step is
    skipped (the vector guarantees an allowed alternative exists —
    ``cur`` was only ever relaxed through allowed edges). Returns
    ``[src..dst]`` or None."""
    src, dst = int(src), int(dst)
    d = int(dist[dst])
    if d < 0:
        return None
    path = [dst]
    cur = dst
    for step in range(d, 0, -1):
        row = col_ind[row_ptr[cur]: row_ptr[cur + 1]]
        down = row[dist[row] == step - 1]
        if banned_edges:
            down = [
                u for u in down if (int(u), cur) not in banned_edges
            ]
        if len(down) == 0:  # cannot happen on a consistent vector
            return None
        cur = int(down[0])
        path.append(cur)
    path.reverse()
    return path


def bfs_restricted(n: int, row_ptr: np.ndarray, col_ind: np.ndarray,
                   src: int, dst: int, *,
                   banned_nodes=None, banned_edges=None):
    """Shortest path avoiding ``banned_nodes`` (bool[n] or set) and
    directed ``banned_edges`` (set of (u, v)); None = unrestricted.
    Returns the path ``[src..dst]`` or None — the CANONICAL one
    (:func:`descend_min_id` over :func:`restricted_dists`), so every
    tier solving the same restriction reports the same path."""
    src, dst = int(src), int(dst)
    mask = _banned_mask(n, banned_nodes)
    if mask is not None and (mask[src] or mask[dst]):
        return None
    if src == dst:
        return [src]
    dist = restricted_dists(
        n, row_ptr, col_ind, src, dst,
        banned_mask=mask, banned_edges=banned_edges,
    )
    return descend_min_id(row_ptr, col_ind, dist, src, dst,
                          banned_edges=banned_edges)


def _spur_batch_host(n, row_ptr, col_ind, dst, cands):
    """The default (host) spur-candidate solver: one restricted BFS
    per candidate. ``cands`` is a list of ``(spur, banned_nodes set,
    banned_edges set)``; returns one tail-path-or-None per candidate."""
    return [
        bfs_restricted(
            n, row_ptr, col_ind, spur, dst,
            banned_nodes=banned_nodes, banned_edges=banned_edges,
        )
        for spur, banned_nodes, banned_edges in cands
    ]


def yen_k_shortest(n: int, row_ptr: np.ndarray, col_ind: np.ndarray,
                   src: int, dst: int, k: int, *, spur_batch=None):
    """Up to ``k`` shortest loopless ``src``->``dst`` paths, hop counts
    non-decreasing. Returns a
    :class:`~bibfs_tpu_torch.query.types.KShortestResult`.

    ``spur_batch(cands) -> [tail|None, ...]`` overrides how one Yen
    iteration's spur candidates solve (the device rung batches them
    through one restricted-BFS launch); answers must match the host
    solver's canonical paths, which the shared descent rule
    guarantees — so the ladder's rungs return IDENTICAL results. A given
    ``spur_batch`` also finds the first path, as one candidate with
    nothing banned: the same canonical path as :func:`bfs_restricted`,
    without a host BFS of the whole graph (the reference's device rung
    runs that BFS on the host)."""
    from bibfs_tpu_torch.query.types import KShortestResult

    t0 = time.perf_counter()
    src, dst, k = int(src), int(dst), int(k)
    if spur_batch is None:
        def spur_batch(cands):
            return _spur_batch_host(n, row_ptr, col_ind, dst, cands)

        first = bfs_restricted(n, row_ptr, col_ind, src, dst)
    else:
        first = spur_batch([(src, set(), set())])[0]
    if first is None:
        return KShortestResult(
            found=False, paths=[], hops=[],
            time_s=time.perf_counter() - t0,
        )
    accepted = [first]
    seen_paths = {tuple(first)}
    candidates: list = []  # heap of (hops, path)
    while len(accepted) < k:
        prev = accepted[-1]
        # collect the iteration's spur restrictions, then solve them
        # as ONE batch — the seam the device rung rides
        cands = []
        roots = []
        for i in range(len(prev) - 1):
            spur = prev[i]
            root = prev[: i + 1]
            banned_edges = set()
            for p in accepted:
                if len(p) > i and p[: i + 1] == root:
                    banned_edges.add((p[i], p[i + 1]))
            banned_nodes = set(root[:-1])  # root prefix minus the spur
            cands.append((spur, banned_nodes, banned_edges))
            roots.append(root)
        tails = spur_batch(cands)
        for root, tail in zip(roots, tails):
            if tail is None:
                continue
            cand = root[:-1] + tail
            key = tuple(cand)
            if key not in seen_paths:
                seen_paths.add(key)
                heapq.heappush(candidates, (len(cand) - 1, cand))
        if not candidates:
            break
        _hops, best = heapq.heappop(candidates)
        accepted.append(best)
    return KShortestResult(
        found=True,
        paths=accepted,
        hops=[len(p) - 1 for p in accepted],
        time_s=time.perf_counter() - t0,
    )
