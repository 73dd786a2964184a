"""The typed whole-graph analytics kinds — ``sssp`` / ``pagerank`` /
``components`` / ``triangles`` as peer members of the query taxonomy: the
counterpart of ``bibfs_tpu/analytics/queries.py``.

Each kind is a frozen :class:`~bibfs_tpu_torch.query.types.Query` subclass
(same ``validate``/``cache_key`` contract, same engine dispatch) whose
answer is a WHOLE-GRAPH vector or scalar instead of one path:

- :class:`Sssp` — (min, +) single-source distances under the seeded
  symmetric edge-weight hash (``weight_seed``, the delta-stepping
  convention); a flush's same-seed sources batch into ONE multi-column
  plane (the all-pairs-to-landmarks shape).
- :class:`PageRank` — (+, x) damped power iteration with L1-tolerance
  termination.
- :class:`Components` — min-label propagation; every vertex converges
  to the smallest id in its component.
- :class:`Triangles` — the masked popcount matmul count.

``rep_pair()`` is the representative (src, dst) the engines use for
fault targeting and error reporting — whole-graph kinds have no (s, t)
of their own, so the source (or vertex 0) stands in.

Results carry their full vectors (read-only arrays — cached and
store-served objects are shared between tickets);
:func:`analytics_summary` is the one-line JSON shape the REPL / net
``analytics`` control op replies with.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from bibfs_tpu_torch.query.types import Query, _check_node

#: the whole-graph kind taxonomy (``bibfs_query_total{kind=}`` values,
#: ladder names ``<kind>_blocked`` / ``<kind>`` / ``host``)
ANALYTICS_KINDS = ("sssp", "pagerank", "components", "triangles")


@dataclasses.dataclass(frozen=True)
class Sssp(Query):
    """Single-source shortest-path distances to EVERY vertex under the
    seeded symmetric weight hash (exact vs the Dijkstra oracle)."""

    source: int
    weight_seed: int = 0
    kind = "sssp"

    def validate(self, n: int) -> None:
        _check_node(self.source, n, "source")

    def cache_key(self) -> tuple:
        return ("sssp", int(self.source), int(self.weight_seed))

    def rep_pair(self) -> tuple:
        return (int(self.source), int(self.source))


@dataclasses.dataclass(frozen=True)
class PageRank(Query):
    """Damped PageRank with convergence-tolerance termination (verified
    vs dense NumPy power iteration)."""

    damping: float = 0.85
    tol: float = 1e-8
    max_iters: int = 100
    kind = "pagerank"

    def validate(self, n: int) -> None:
        if not 0.0 < float(self.damping) < 1.0:
            raise ValueError(
                f"damping must be in (0, 1), got {self.damping}"
            )
        if float(self.tol) <= 0.0:
            raise ValueError(f"tol must be > 0, got {self.tol}")
        if int(self.max_iters) < 1:
            raise ValueError(
                f"max_iters must be >= 1, got {self.max_iters}"
            )

    def cache_key(self) -> tuple:
        return ("pagerank", float(self.damping), float(self.tol),
                int(self.max_iters))

    def rep_pair(self) -> tuple:
        return (0, 0)


@dataclasses.dataclass(frozen=True)
class Components(Query):
    """Connected-component labels by min-label propagation (verified
    vs union-find)."""

    kind = "components"

    def validate(self, n: int) -> None:
        pass  # the whole graph, any n

    def cache_key(self) -> tuple:
        return ("components",)

    def rep_pair(self) -> tuple:
        return (0, 0)


@dataclasses.dataclass(frozen=True)
class Triangles(Query):
    """Whole-graph triangle count by the masked popcount matmul
    (verified vs the adjacency-intersection exact count)."""

    kind = "triangles"

    def validate(self, n: int) -> None:
        pass  # the whole graph, any n

    def cache_key(self) -> tuple:
        return ("triangles",)

    def rep_pair(self) -> tuple:
        return (0, 0)


# ---- results ---------------------------------------------------------
def _freeze(arr):
    arr = np.ascontiguousarray(arr)
    arr.flags.writeable = False
    return arr


@dataclasses.dataclass
class SsspResult:
    """One :class:`Sssp` answer: ``dist[v]`` is the exact weighted
    distance from ``source`` (+inf = unreachable)."""

    found: bool                      # source in range and n > 0
    dist: np.ndarray                 # float64 [n], read-only
    reached: int                     # finite entries
    rounds: int                      # relaxation sweeps to fixpoint
    time_s: float

    def __post_init__(self):
        self.dist = _freeze(self.dist)


@dataclasses.dataclass
class PageRankResult:
    """One :class:`PageRank` answer; ``ranks`` sums to 1."""

    found: bool
    ranks: np.ndarray                # float64 [n], read-only
    iters: int
    delta: float                     # final L1 step delta
    time_s: float

    def __post_init__(self):
        self.ranks = _freeze(self.ranks)


@dataclasses.dataclass
class ComponentsResult:
    """One :class:`Components` answer: ``labels[v]`` is the smallest
    vertex id in v's component."""

    found: bool
    labels: np.ndarray               # int64 [n], read-only
    count: int                       # distinct components
    rounds: int
    time_s: float

    def __post_init__(self):
        self.labels = _freeze(self.labels)


@dataclasses.dataclass
class TrianglesResult:
    """One :class:`Triangles` answer."""

    found: bool
    count: int
    time_s: float


def analytics_summary(res) -> dict:
    """The one-line JSON-safe summary the ``analytics`` control op
    replies with — scalars only, never the whole vector."""
    if isinstance(res, SsspResult):
        finite = res.dist[np.isfinite(res.dist)]
        return {
            "kind": "sssp", "found": bool(res.found),
            "n": int(res.dist.size), "reached": int(res.reached),
            "max_dist": float(finite.max()) if finite.size else None,
            "rounds": int(res.rounds), "time_s": float(res.time_s),
        }
    if isinstance(res, PageRankResult):
        return {
            "kind": "pagerank", "found": bool(res.found),
            "n": int(res.ranks.size), "iters": int(res.iters),
            "delta": float(res.delta),
            "top": int(res.ranks.argmax()) if res.ranks.size else None,
            "time_s": float(res.time_s),
        }
    if isinstance(res, ComponentsResult):
        return {
            "kind": "components", "found": bool(res.found),
            "n": int(res.labels.size), "count": int(res.count),
            "rounds": int(res.rounds), "time_s": float(res.time_s),
        }
    if isinstance(res, TrianglesResult):
        return {
            "kind": "triangles", "found": bool(res.found),
            "count": int(res.count), "time_s": float(res.time_s),
        }
    raise ValueError(f"not an analytics result: {type(res).__name__}")


def analytics_query_from_spec(kind: str, params: dict) -> Query:
    """Build one analytics query from the REPL / net control-op shape
    (string kind + loose params) — unknown kinds and bad fields raise
    ``ValueError``, the ``error invalid:`` seam."""
    params = dict(params or {})
    if kind == "sssp":
        if "source" not in params:
            raise ValueError("sssp needs source=<vertex>")
        q = Sssp(int(params.pop("source")),
                 weight_seed=int(params.pop("weight_seed", 0)))
    elif kind == "pagerank":
        q = PageRank(
            damping=float(params.pop("damping", 0.85)),
            tol=float(params.pop("tol", 1e-8)),
            max_iters=int(params.pop("max_iters", 100)),
        )
    elif kind == "components":
        q = Components()
    elif kind == "triangles":
        q = Triangles()
    else:
        raise ValueError(
            f"unknown analytics kind {kind!r} (one of {ANALYTICS_KINDS})"
        )
    if params:
        raise ValueError(
            f"unknown {kind} params: {', '.join(sorted(params))}"
        )
    return q
