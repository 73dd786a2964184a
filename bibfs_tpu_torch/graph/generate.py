"""Graph generators: G(n, p), grids and RMAT, numpy-vectorized.

Identical seeds give identical edges to ``bibfs_tpu.graph.generate``.
"""

from __future__ import annotations

import numpy as np

# the reference suite's average degree, epsilon included
DEFAULT_AVG_DEG = 2.2000000001


def _linear_to_upper_pair(k: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Map linear indices over the upper triangle {(i, j): i < j}, ordered
    by row then column, back to (i, j). Float solve + integer correction."""
    k = k.astype(np.int64)
    twon1 = 2 * n - 1
    i = np.floor((twon1 - np.sqrt(np.maximum(twon1 * twon1 - 8.0 * k, 0.0))) / 2.0)
    i = i.astype(np.int64)
    i = np.clip(i, 0, n - 2)

    def start(i):
        return i * n - (i * (i + 1)) // 2

    for _ in range(4):  # fix float rounding, ±2 at most
        i = np.where(start(i + 1) <= k, i + 1, i)
        i = np.where(start(i) > k, i - 1, i)
        i = np.clip(i, 0, n - 2)
    j = i + 1 + (k - start(i))
    return i, j


def gnp_random_graph(n: int, p: float, *, seed: int | None = None) -> np.ndarray:
    """Sample G(n, p) as an ``(M, 2)`` unique undirected edge array:
    M ~ Binomial(C(n,2), p), then M distinct pairs uniformly without
    replacement. O(M) memory and time."""
    rng = np.random.default_rng(seed)
    total = n * (n - 1) // 2
    if total == 0 or p <= 0:
        return np.zeros((0, 2), dtype=np.int64)
    m = int(rng.binomial(total, min(p, 1.0))) if p < 1.0 else total
    picks = np.zeros(0, dtype=np.int64)
    while picks.size < m:
        need = m - picks.size
        remaining_frac = max(1.0 - picks.size / total, 1e-9)
        batch = int(need / remaining_frac * 1.1) + 16
        cand = rng.integers(0, total, size=batch, dtype=np.int64)
        picks = np.unique(np.concatenate([picks, cand]))
    if picks.size > m:
        picks = rng.permutation(picks)[:m]
    i, j = _linear_to_upper_pair(picks, n)
    return np.stack([i, j], axis=1)


def grid_graph(
    width: int, height: int, *, perforation: float = 0.0,
    seed: int | None = None,
) -> np.ndarray:
    """``width x height`` 4-neighbour lattice as an ``(M, 2)`` edge array
    (row-major ids, ``n = width * height``); ``perforation`` removes that
    fraction of edges uniformly at random (seeded)."""
    if width < 1 or height < 1:
        raise ValueError(f"grid needs positive dims, got {width}x{height}")
    vid = np.arange(width * height, dtype=np.int64).reshape(height, width)
    e_right = np.stack([vid[:, :-1].ravel(), vid[:, 1:].ravel()], axis=1)
    e_down = np.stack([vid[:-1, :].ravel(), vid[1:, :].ravel()], axis=1)
    edges = np.concatenate([e_right, e_down])
    if perforation > 0:
        rng = np.random.default_rng(seed)
        edges = edges[rng.random(len(edges)) >= float(perforation)]
    return edges


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int | None = None,
    dedup: bool = True,
) -> tuple[int, np.ndarray]:
    """Graph500-style RMAT generator. Returns ``(n, edges)`` with
    ``n = 2**scale``: Kronecker recursive quadrant sampling, vectorized
    over all edges per bit level."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    row = np.zeros(m, dtype=np.int64)
    col = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        u = rng.random(m)
        row_bit = u >= ab
        col_bit = ((u >= a) & (u < ab)) | (u >= abc)
        row = (row << 1) | row_bit
        col = (col << 1) | col_bit
    edges = np.stack([row, col], axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    if dedup:
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        keys = np.unique(lo * n + hi)
        edges = np.stack([keys // n, keys % n], axis=1)
    return n, edges
