"""The semiring seam: one CSR product, four whole-graph analytics (a
copy of ``bibfs_tpu/analytics/semiring.py``, which is NumPy only).

A BFS level is ``next = A (x) frontier`` over the boolean (OR, AND)
semiring. Generalize the (add, mul) pair and the SAME sparse product
computes the classical whole-graph kinds:

============  ==================  =========================  =========
semiring      (add, mul, zero)    fixpoint / iteration       kind
============  ==================  =========================  =========
``min_plus``  (min, +, +inf)      Bellman relaxation sweeps  sssp
``plus_times``(+, x, 0)           damped power iteration     pagerank
``min_label`` (min, select, inf)  label propagation          components
``bool_count``(+, x, 0)           masked popcount matmul     triangles
============  ==================  =========================  =========

:func:`csr_semiring_matvec` is the host-tier product every host rung
iterates; the blocked device rungs run the identical recurrences over
the tiled tables (:mod:`bibfs_tpu_torch.ops.semiring_plane`) so host and
blocked answers agree element-for-element (integer-valued data stays
exact in f32 below 2^24 — the device gates enforce that bound).

The ``ref_*`` functions are the INDEPENDENT implementations the tests
pin each kind against: binary-heap Dijkstra
(:func:`bibfs_tpu_torch.query.weighted.dijkstra_numpy`), dense-matrix
power iteration, union-find, and adjacency-intersection triangle counting —
none of them share the semiring product above.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: label value for "no label yet" in the min-label semiring (any real
#: vertex id wins the min against it)
_LABEL_INF = np.iinfo(np.int64).max


@dataclasses.dataclass(frozen=True)
class Semiring:
    """One (add, mul, zero, dtype) algebra over the CSR product.

    ``add`` is a NumPy ufunc (its unbuffered ``.at`` is the scatter-
    reduce); ``mul`` combines the gathered plane rows ``[E, C]`` with
    the per-edge values ``[E]`` (or None for unweighted semirings);
    ``zero`` is ``add``'s identity, the empty-neighborhood answer.
    """

    name: str
    add: np.ufunc
    mul: object  # callable(gathered [E, C], edge_vals [E] | None) -> [E, C]
    zero: float
    dtype: np.dtype


def _mul_plus(gathered, edge_vals):
    if edge_vals is None:
        return gathered
    return gathered + edge_vals[:, None]


def _mul_times(gathered, edge_vals):
    if edge_vals is None:
        return gathered
    return gathered * edge_vals[:, None]


def _mul_select(gathered, edge_vals):
    return gathered


SEMIRINGS = {
    "min_plus": Semiring(
        "min_plus", np.minimum, _mul_plus, np.inf, np.dtype(np.float64)
    ),
    "plus_times": Semiring(
        "plus_times", np.add, _mul_times, 0.0, np.dtype(np.float64)
    ),
    "min_label": Semiring(
        "min_label", np.minimum, _mul_select, _LABEL_INF,
        np.dtype(np.int64),
    ),
    "bool_count": Semiring(
        "bool_count", np.add, _mul_times, 0, np.dtype(np.int64)
    ),
}


def csr_semiring_matvec(n, row_ptr, col_ind, plane, sr: Semiring,
                        edge_vals=None):
    """``out[u] = add-reduce over edges (u, v) of mul(plane[v], w_uv)``
    — ONE vectorized gather + unbuffered scatter-reduce, no Python
    per-edge loop. ``plane`` is ``[n, C]`` (or ``[n]``, returned in
    kind); empty neighborhoods answer ``sr.zero``."""
    plane = np.asarray(plane)
    squeeze = plane.ndim == 1
    if squeeze:
        plane = plane[:, None]
    out = np.full((n, plane.shape[1]), sr.zero, dtype=plane.dtype)
    if n and col_ind.size:
        src = np.repeat(
            np.arange(n, dtype=np.int64), np.diff(row_ptr).astype(np.int64)
        )
        contrib = sr.mul(plane[col_ind], edge_vals)
        sr.add.at(out, src, contrib)
    return out[:, 0] if squeeze else out


# ---- host rungs: semiring iteration to fixpoint/tolerance ------------
def host_sssp(n, row_ptr, col_ind, weights, sources):
    """Multi-source (min, +) Bellman sweeps to fixpoint: one distance
    column per source (the all-pairs-to-landmarks shape). Returns
    ``(dist [n, C] float64, rounds)`` — exact for any non-negative
    weights (each sweep settles at least one more hop tier)."""
    sources = [int(s) for s in sources]
    sr = SEMIRINGS["min_plus"]
    dist = np.full((n, len(sources)), np.inf, dtype=np.float64)
    for i, s in enumerate(sources):
        dist[s, i] = 0.0
    rounds = 0
    while rounds < max(1, n):
        cand = csr_semiring_matvec(
            n, row_ptr, col_ind, dist, sr, edge_vals=weights
        )
        new = np.minimum(dist, cand)
        rounds += 1
        if np.array_equal(new, dist):
            break
        dist = new
    return dist, rounds


def host_pagerank(n, row_ptr, col_ind, *, damping=0.85, tol=1e-8,
                  max_iters=100):
    """Damped PageRank by (+, x) power iteration over the CSR, dangling
    mass redistributed uniformly, L1-delta tolerance termination.
    Returns ``(ranks [n] float64, iters, delta)``; ranks sum to 1."""
    if n == 0:
        return np.zeros(0, dtype=np.float64), 0, 0.0
    sr = SEMIRINGS["plus_times"]
    deg = np.diff(row_ptr).astype(np.float64)
    dangling = deg == 0
    r = np.full(n, 1.0 / n, dtype=np.float64)
    it, delta = 0, np.inf
    while it < max(1, int(max_iters)):
        contrib = np.where(dangling, 0.0, r / np.maximum(deg, 1.0))
        y = csr_semiring_matvec(n, row_ptr, col_ind, contrib, sr)
        mass = float(r[dangling].sum())
        rn = (1.0 - damping) / n + damping * (y + mass / n)
        delta = float(np.abs(rn - r).sum())
        r = rn
        it += 1
        if delta <= tol:
            break
    return r, it, delta


def host_components(n, row_ptr, col_ind):
    """Connected components by min-label propagation to fixpoint:
    every vertex converges to the smallest vertex id in its component.
    Returns ``(labels [n] int64, count, rounds)``."""
    sr = SEMIRINGS["min_label"]
    labels = np.arange(n, dtype=np.int64)
    rounds = 0
    while rounds < max(1, n):
        cand = csr_semiring_matvec(n, row_ptr, col_ind, labels, sr)
        new = np.minimum(labels, cand)
        rounds += 1
        if np.array_equal(new, labels):
            break
        labels = new
    count = int(np.unique(labels).size) if n else 0
    return labels, count, rounds


def host_triangles(n, row_ptr, col_ind, *, chunk=None):
    """Triangle count by the masked popcount matmul: per column chunk
    ``P`` of the adjacency, ``sum((A @ P) * P)`` counts each triangle
    once per ordered adjacent (u, j) pair — six times total. Returns
    ``(count, chunks)``."""
    sr = SEMIRINGS["bool_count"]
    e = int(col_ind.size)
    if chunk is None:
        # bound the gathered [E, C] scatter temp to ~2^24 elements
        chunk = max(16, min(1024, (1 << 24) // max(1, e)))
    src = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(row_ptr).astype(np.int64)
    ) if n else np.zeros(0, dtype=np.int64)
    total = 0
    chunks = 0
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        plane = np.zeros((n, c1 - c0), dtype=np.int64)
        in_cols = (col_ind >= c0) & (col_ind < c1)
        plane[src[in_cols], col_ind[in_cols] - c0] = 1
        y = csr_semiring_matvec(n, row_ptr, col_ind, plane, sr)
        total += int((y * plane).sum())
        chunks += 1
    return total // 6, chunks


# ---- independent references (NOT the semiring product above) ---------
def ref_pagerank_dense(n, row_ptr, col_ind, *, damping=0.85, tol=1e-8,
                       max_iters=100):
    """Dense-matrix power iteration — the NumPy reference the semiring
    rungs are verified against (same math, disjoint machinery: an
    explicit ``[n, n]`` column-stochastic matmul per step)."""
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    a = np.zeros((n, n), dtype=np.float64)
    src = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(row_ptr).astype(np.int64)
    )
    a[src, col_ind] = 1.0
    deg = a.sum(axis=0)
    m = np.divide(a, deg, out=np.zeros_like(a), where=deg > 0)
    dangling = deg == 0
    r = np.full(n, 1.0 / n)
    for _ in range(max(1, int(max_iters))):
        rn = (1.0 - damping) / n + damping * (
            m @ r + float(r[dangling].sum()) / n
        )
        if float(np.abs(rn - r).sum()) <= tol:
            return rn
        r = rn
    return r


def ref_components_unionfind(n, pairs):
    """Union-find over the edge list — the components reference.
    Returns ``(labels [n] int64, count)`` with each class labeled by
    its smallest member (the min-label convention)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    if pairs is not None:
        for u, v in np.asarray(pairs, dtype=np.int64).reshape(-1, 2):
            ru, rv = find(int(u)), find(int(v))
            if ru != rv:
                # union by min id keeps the canonical label the root
                if ru < rv:
                    parent[rv] = ru
                else:
                    parent[ru] = rv
    labels = np.fromiter(
        (find(i) for i in range(n)), dtype=np.int64, count=n
    )
    return labels, (int(np.unique(labels).size) if n else 0)


def ref_triangles_intersect(n, row_ptr, col_ind):
    """Exact triangle count by per-edge sorted-adjacency intersection:
    ``sum over undirected edges (u, v) of |N(u) & N(v)|`` counts each
    triangle three times. No matmul anywhere — the independent pin."""
    total = 0
    for u in range(n):
        nu = col_ind[row_ptr[u]: row_ptr[u + 1]]
        for v in nu[nu > u]:
            nv = col_ind[row_ptr[v]: row_ptr[v + 1]]
            total += int(np.intersect1d(nu, nv, assume_unique=True).size)
    return total // 3
