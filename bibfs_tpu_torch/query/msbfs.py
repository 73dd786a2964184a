"""Multi-source query answering over the bitmask-packed msBFS sweep: the
counterpart of ``bibfs_tpu/query/msbfs.py`` (a copy: NumPy only).

:func:`bibfs_tpu_torch.oracle.trees.multi_source_bfs` has carried the
oracle tier as an INDEX BUILDER — K landmark BFS trees in one
level-synchronous pass, one ``uint64`` reachability word per vertex. This module promotes
it to a first-class ANSWERING primitive for the ``msbfs`` query kind:
one packed sweep computes all 64 sources' full distance vectors, so a
flush holding any number of :class:`~bibfs_tpu_torch.query.types.MultiSource`
queries costs ``ceil(distinct_sources / 64)`` sweeps total — against
one full bidirectional solve per (source, dst) pair on the
point-to-point route. The per-query read afterwards is two array
lookups per source, and a shortest PATH for the best source falls out
of its distance vector by greedy descent (every vertex at distance d
has a neighbor at d-1, by BFS construction).
"""

from __future__ import annotations

import time

import numpy as np

from bibfs_tpu_torch.query.types import MSBFS_WORD, MultiSourceResult


def path_from_dist(row_ptr: np.ndarray, col_ind: np.ndarray,
                   dist_col: np.ndarray, src: int, dst: int):
    """A shortest ``src``->``dst`` path recovered from the full
    distance vector ``dist_col`` (distances FROM ``src``; -1 =
    unreachable): walk from ``dst`` down the distance gradient. Cost
    O(hops * deg) — no parent array needed, which is exactly why the
    packed sweep (which stores none) can still answer with paths."""
    d = int(dist_col[dst])
    if d < 0:
        return None
    path = [int(dst)]
    cur = int(dst)
    for step in range(d, 0, -1):
        row = col_ind[row_ptr[cur]: row_ptr[cur + 1]]
        down = row[dist_col[row] == step - 1]
        if down.size == 0:  # cannot happen on a consistent vector
            return None
        cur = int(down[0])
        path.append(cur)
    path.reverse()
    return path


def solve_multi_source(n: int, row_ptr: np.ndarray, col_ind: np.ndarray,
                       queries, *, with_paths: bool = True,
                       dist_fn=None):
    """Answer a batch of :class:`MultiSource` queries with ONE packed
    sweep: the DISTINCT sources across the whole batch ride a single
    multi-word sweep (``ceil(distinct / 64)`` mask words per vertex —
    the K > 64 case is one wider pass, not a loop of 64-wide ones),
    then every query reads its ``(source, dst)`` cells from the shared
    distance plane — one contiguous ``plane[dst]`` row read per query,
    not a strided column per source. Returns one
    :class:`~bibfs_tpu_torch.query.types.MultiSourceResult` per query.

    ``dist_fn(sources) -> int16 [n, K]`` overrides the sweep
    implementation — the device rung
    (:class:`~bibfs_tpu_torch.serve.routes.taxonomy_device.MsbfsDeviceRoute`)
    passes the jitted kernel over its uploaded table; the default is
    the host NumPy sweep. ``sweeps`` in the results stays in 64-source
    sweep units (the amortization figure the metrics report)."""
    from bibfs_tpu_torch.oracle.trees import multi_source_bfs

    t0 = time.perf_counter()
    col_of: dict[int, int] = {}
    first = queries[0].sources if queries else ()
    shared = all(
        q.sources is first or q.sources == first for q in queries
    )
    if shared:
        # the serving shape: one shared source set across the flush
        # (64-source traffic) — index it once, not per (query, source)
        col_of = {int(s): i for i, s in enumerate(first)}
    if not shared or len(col_of) != len(first):
        # distinct sources per query, or a DUPLICATE inside the shared
        # tuple (validate() allows it): positional indexing would read
        # past the deduped plane — take the deduping walk instead
        col_of = {}
        distinct = []
        for q in queries:
            for s in q.sources:
                s = int(s)
                if s not in col_of:
                    col_of[s] = len(distinct)
                    distinct.append(s)
    else:
        distinct = list(col_of)
    src_arr = np.asarray(distinct, dtype=np.int64)
    if dist_fn is None:
        plane = multi_source_bfs(n, row_ptr, col_ind, src_arr)
    else:
        plane = dist_fn(src_arr)
    sweeps = -(-len(distinct) // MSBFS_WORD)
    elapsed = time.perf_counter() - t0

    def col(s: int) -> np.ndarray:
        return plane[:, col_of[int(s)]]

    out = []
    for q in queries:
        dst = int(q.dst)
        row = plane[dst]
        per = tuple(
            (lambda d: None if d < 0 else int(d))(int(row[col_of[int(s)]]))
            for s in q.sources
        )
        best = None
        for i, h in enumerate(per):
            if h is not None and (best is None or h < per[best]):
                best = i
        path = None
        if best is not None and with_paths:
            path = path_from_dist(
                row_ptr, col_ind, col(q.sources[best]),
                int(q.sources[best]), dst,
            )
        out.append(MultiSourceResult(
            found=best is not None,
            per_source=per,
            best=best,
            hops=per[best] if best is not None else None,
            path=path,
            time_s=elapsed,
            sweeps=sweeps,
        ))
    return out
