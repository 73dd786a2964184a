"""Host-side graph builders: CSR, ELL and tiered ELL adjacency (numpy).

The same arrays as ``bibfs_tpu.graph.csr``: canonical directed pairs,
then a degree-count + prefix-sum CSR, then the regularized ELL table
``[n_pad, width]`` that the device search gathers over. Power-law graphs
use the tiered layout: a narrow base table plus geometric hub tiers.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def canonical_pairs(n: int, edges: np.ndarray) -> np.ndarray:
    """Mirror undirected edges into a directed pair list, drop self-loops
    and duplicates. Returns an ``(E, 2)`` int64 array sorted by source.
    Every builder takes the result through ``pairs=`` so a caller
    building several layouts of one graph pays for it once."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size and (int(edges.min()) < 0 or int(edges.max()) >= n):
        raise ValueError(
            f"edge endpoints must be in [0, {n}); got "
            f"[{int(edges.min())}, {int(edges.max())}]"
        )
    both = np.concatenate([edges, edges[:, ::-1]], axis=0)
    both = both[both[:, 0] != both[:, 1]]
    keys = np.unique(both[:, 0] * n + both[:, 1])
    out = np.empty((keys.size, 2), dtype=np.int64)
    out[:, 0] = keys // n
    out[:, 1] = keys % n
    return out


def _rank_within_row(pairs: np.ndarray, deg: np.ndarray, n: int) -> np.ndarray:
    """Per-directed-edge rank within its source row (pairs sorted by
    source, which :func:`canonical_pairs` guarantees)."""
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    return np.arange(pairs.shape[0]) - row_ptr[pairs[:, 0]]


def build_csr(
    n: int, edges: np.ndarray | None = None, *, pairs: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric CSR adjacency ``(row_ptr[n+1], col_ind[2E])`` with
    ascending rows (path validation binary-searches them)."""
    if pairs is None:
        pairs = canonical_pairs(n, edges)
    deg = np.bincount(pairs[:, 0], minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    col_ind = pairs[:, 1].copy()
    return row_ptr, col_ind


@dataclasses.dataclass
class EllGraph:
    """Regularized adjacency: ``nbr`` int32 ``[n_pad, width]`` (slots past
    ``deg[v]`` hold 0 and are masked by ``deg``), ``deg`` int32
    ``[n_pad]`` (0 for pad vertices), ``overflow`` int32 ``[n_over, 2]``
    COO pairs that did not fit under a ``width_cap``."""

    n: int
    n_pad: int
    width: int
    num_edges: int  # undirected unique edge count
    nbr: np.ndarray
    deg: np.ndarray
    overflow: np.ndarray

    @property
    def num_directed_edges(self) -> int:
        return int(self.deg.sum()) + self.overflow.shape[0]


def build_ell(
    n: int,
    edges: np.ndarray | None = None,
    *,
    width_cap: int | None = None,
    pad_multiple: int = 8,
    pairs: np.ndarray | None = None,
) -> EllGraph:
    """Regularize an undirected edge list into ELL form; ``n_pad`` rounds
    ``n`` up to ``pad_multiple``."""
    if pairs is None:
        pairs = canonical_pairs(n, edges)
    num_edges = pairs.shape[0] // 2
    deg = np.bincount(pairs[:, 0], minlength=n).astype(np.int64)
    max_deg = int(deg.max()) if deg.size and pairs.size else 0
    width = max(1, max_deg)
    overflow = np.zeros((0, 2), dtype=np.int32)
    if width_cap is not None and width > width_cap:
        width = max(1, width_cap)
        spill = _rank_within_row(pairs, deg, n) >= width
        overflow = pairs[spill].astype(np.int32)
        pairs = pairs[~spill]
        deg = np.minimum(deg, width)

    n_pad = -(-n // pad_multiple) * pad_multiple
    nbr = np.zeros((n_pad, width), dtype=np.int32)
    if pairs.size:
        rank = _rank_within_row(pairs, deg, n)
        nbr[pairs[:, 0], rank] = pairs[:, 1]
    deg_pad = np.zeros(n_pad, dtype=np.int32)
    deg_pad[:n] = deg
    return EllGraph(
        n=n,
        n_pad=n_pad,
        width=width,
        num_edges=num_edges,
        nbr=nbr,
        deg=deg_pad,
        overflow=overflow,
    )


@dataclasses.dataclass
class HubTier:
    """One geometric slice of the high-degree tail: neighbour slots
    ``[start, start + nbr.shape[1])`` of every vertex whose degree exceeds
    ``start``, rows indexed by the shared degree-descending hub rank."""

    start: int
    count: int  # true member count (rows beyond it are padding)
    nbr: np.ndarray  # int32 [count_pad, width]


@dataclasses.dataclass
class TieredEllGraph:
    """ELL adjacency with geometric hub tiers for skewed degree
    distributions. ``deg`` holds TRUE degrees; ``hub_rank[v]`` is v's
    position in the degree-descending hub ordering (-1 for non-hubs)."""

    n: int
    n_pad: int
    width: int  # base-tier width
    num_edges: int
    max_deg: int
    nbr: np.ndarray  # int32 [n_pad, width] first `width` neighbours
    deg: np.ndarray  # int32 [n_pad]
    hub_rank: np.ndarray  # int32 [n_pad]
    hub_ids: np.ndarray  # int32 [num_hubs_pad] rank -> vertex id (-1 pad)
    tiers: tuple  # tuple[HubTier, ...]

    @property
    def num_directed_edges(self) -> int:
        return int(self.deg.sum())

    @property
    def padded_slots(self) -> int:
        return int(self.nbr.size + sum(t.nbr.size for t in self.tiers))


# candidate base widths; the builder picks the one minimizing total padded
# slots (base table + hub tiers), which is also what each pull level reads
_BASE_WIDTHS = (4, 8, 16, 32, 64, 128)
_TIER_GROWTH = 8
_HUB_PAD = 8


def _pad_hub_count(count: int) -> int:
    return -(-count // _HUB_PAD) * _HUB_PAD


def _tier_plan(w0: int, max_deg: int):
    """Geometric tier boundaries for a given base width: [(start, width)]."""
    plan = []
    start = w0
    while start < max_deg:
        width = min(start * (_TIER_GROWTH - 1), max_deg - start)
        plan.append((start, width))
        start += width
    return plan


def _padded_slots(w0: int, n_pad: int, deg: np.ndarray, max_deg: int) -> int:
    total = n_pad * w0
    for start, width in _tier_plan(w0, max_deg):
        total += _pad_hub_count(int((deg > start).sum())) * width
    return total


def build_tiered(
    n: int,
    edges: np.ndarray | None = None,
    *,
    base_width: int | None = None,
    pad_multiple: int = 8,
    pairs: np.ndarray | None = None,
) -> TieredEllGraph:
    """Regularize an undirected edge list into tiered ELL form. Low-skew
    graphs degenerate to a plain single-table ELL with no tiers."""
    if pairs is None:
        pairs = canonical_pairs(n, edges)
    num_edges = pairs.shape[0] // 2
    deg = np.bincount(pairs[:, 0], minlength=n).astype(np.int64)
    max_deg = int(deg.max()) if deg.size and pairs.size else 0

    n_pad = -(-n // pad_multiple) * pad_multiple
    if base_width is None:
        cands = [w for w in _BASE_WIDTHS if w < max_deg] + [max_deg]
        base_width = min(
            cands, key=lambda w: _padded_slots(w, n_pad, deg, max_deg)
        )
    w0 = max(1, min(base_width, max_deg) if max_deg else base_width)
    rank = _rank_within_row(pairs, deg, n)

    nbr = np.zeros((n_pad, w0), dtype=np.int32)
    base_sel = rank < w0
    nbr[pairs[base_sel, 0], rank[base_sel]] = pairs[base_sel, 1]

    hub_rank = np.full(n_pad, -1, dtype=np.int32)
    hub_ids = np.zeros(0, dtype=np.int32)
    tiers = []
    if max_deg > w0:
        hub_order = np.argsort(-deg, kind="stable")
        num_hubs = int((deg > w0).sum())
        hub_order = hub_order[:num_hubs]
        hub_rank[hub_order] = np.arange(num_hubs, dtype=np.int32)
        hub_ids = np.full(_pad_hub_count(num_hubs), -1, dtype=np.int32)
        hub_ids[:num_hubs] = hub_order
        for start, width in _tier_plan(w0, max_deg):
            count = int((deg > start).sum())
            arr = np.zeros((_pad_hub_count(count), width), dtype=np.int32)
            sel = (rank >= start) & (rank < start + width)
            arr[hub_rank[pairs[sel, 0]], rank[sel] - start] = pairs[sel, 1]
            tiers.append(HubTier(start=start, count=count, nbr=arr))

    deg_pad = np.zeros(n_pad, dtype=np.int32)
    deg_pad[:n] = deg
    return TieredEllGraph(
        n=n,
        n_pad=n_pad,
        width=w0,
        num_edges=num_edges,
        max_deg=max_deg,
        nbr=nbr,
        deg=deg_pad,
        hub_rank=hub_rank,
        hub_ids=hub_ids,
        tiers=tuple(tiers),
    )
