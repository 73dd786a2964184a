"""The typed query/result taxonomy — what replaced the raw ``(s, t)``.

A copy of ``bibfs_tpu/query/types.py`` (backend-free). Both serving
engines answer every kind here; the whole-graph analytics kinds of
``QUERY_KINDS`` (``sssp``, ``pagerank``, ``components``, ``triangles``)
come with a later slice of the port (ROADMAP Queue 1, item 9).

Every layer of the serving stack used to thread one query shape — an
unweighted point-to-point ``(src, dst)`` hop count plus path — through
``solvers/api.py``, both engines, and the route ladder, while the
plumbing around it (batching, routes, resilience, oracle, WAL) was
already general. This module is the forcing-function refactor ROADMAP
item 3 asked for: queries are TYPED values, each kind carrying exactly
the fields its solvers need, and the engines dispatch on ``kind``
instead of assuming the tuple:

- :class:`PointToPoint` — the original shape; resolves to a
  :class:`~bibfs_tpu_torch.solvers.api.BFSResult` through the unchanged
  ladder (oracle/cache/mesh/blocked/device/host).
- :class:`MultiSource` — K sources against one destination, answered
  by ONE bitmask-packed msBFS sweep per 64 sources
  (:mod:`bibfs_tpu_torch.query.msbfs` — the ``oracle/trees.py`` build
  primitive promoted to a first-class serving route; seed idea from
  the reference MPI version's bitset frontiers, v2/second_try.cpp).
- :class:`Weighted` — weighted shortest path via delta-stepping over
  bucketed frontiers (:mod:`bibfs_tpu_torch.query.weighted`), validated
  against a NumPy Dijkstra oracle. Weights are derived per edge from
  a seeded symmetric hash (``weight_seed``) so a weighted query is
  self-describing against any snapshot — no per-query weight arrays
  on the wire.
- :class:`KShortest` — Yen's algorithm over the repaired-path
  machinery (:mod:`bibfs_tpu_torch.query.kshortest`), a host-tier kind.
- :class:`AsOf` — the time-travel wrapper: any non-AsOf query answered
  against the graph AS OF a historical store version, reconstructed
  from the WAL + versioned manifests (:mod:`bibfs_tpu_torch.store.history`).

``coerce_query`` keeps the old call sites working: a bare ``(s, d)``
pair IS a :class:`PointToPoint`. ``QUERY_KINDS`` is the taxonomy the
``bibfs_query_total{kind,route}`` metric family and the loadgen mix
spec share.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: the query-kind taxonomy (``bibfs_query_total{kind=}`` label values);
#: ``asof`` wraps one of the others but is counted as its own kind —
#: the operational question "how much time-travel traffic" is about
#: the replay machinery, not the inner shape
QUERY_KINDS = ("pt", "msbfs", "weighted", "kshortest", "asof",
               # whole-graph analytics kinds (bibfs_tpu/analytics):
               # vectors/scalars over the full graph, same dispatch
               "sssp", "pagerank", "components", "triangles")

#: sources one bitmask-packed msBFS sweep answers (one uint64 word of
#: reachability bits per vertex per sweep — oracle/trees.py)
MSBFS_WORD = 64


class Query:
    """Base of the taxonomy: ``kind`` is the metric/dispatch label,
    ``validate(n)`` raises ``ValueError`` on malformed client input
    (the submit-time seam that may tag ``kind='invalid'``), and
    ``cache_key()`` is the per-snapshot result-cache identity."""

    kind: str = "pt"

    def validate(self, n: int) -> None:
        raise NotImplementedError

    def cache_key(self) -> tuple:
        raise NotImplementedError


def _check_node(v, n: int, what: str) -> int:
    v = int(v)
    if not 0 <= v < n:
        raise ValueError(f"{what}={v} out of range for n={n}")
    return v


@dataclasses.dataclass(frozen=True)
class PointToPoint(Query):
    """The original query shape: unweighted s-t hops + path."""

    src: int
    dst: int
    kind = "pt"

    def validate(self, n: int) -> None:
        _check_node(self.src, n, "src")
        _check_node(self.dst, n, "dst")

    def cache_key(self) -> tuple:
        return ("pt", int(self.src), int(self.dst))


@dataclasses.dataclass(frozen=True)
class MultiSource(Query):
    """K sources against one destination: ``dist(s_i, dst)`` for every
    source, one packed sweep per 64 distinct sources. ``sources`` is a
    tuple (hashable — the cache key needs it); order is preserved in
    the result's ``per_source``."""

    sources: tuple
    dst: int
    kind = "msbfs"

    def __post_init__(self):
        object.__setattr__(
            self, "sources", tuple(int(s) for s in self.sources)
        )

    def validate(self, n: int) -> None:
        if not self.sources:
            raise ValueError("MultiSource needs at least one source")
        for s in self.sources:
            _check_node(s, n, "source")
        _check_node(self.dst, n, "dst")

    def cache_key(self) -> tuple:
        return ("msbfs", self.sources, int(self.dst))


@dataclasses.dataclass(frozen=True)
class Weighted(Query):
    """Weighted shortest path under the seeded symmetric edge-weight
    hash (:func:`bibfs_tpu_torch.query.weighted.synthetic_weights` — the
    same ``weight_seed`` always derives the same weights from the same
    snapshot, so results cache per (snapshot, seed, s, t))."""

    src: int
    dst: int
    weight_seed: int = 0
    kind = "weighted"

    def validate(self, n: int) -> None:
        _check_node(self.src, n, "src")
        _check_node(self.dst, n, "dst")

    def cache_key(self) -> tuple:
        return ("weighted", int(self.src), int(self.dst),
                int(self.weight_seed))


@dataclasses.dataclass(frozen=True)
class KShortest(Query):
    """The K shortest loopless s-t paths (Yen's), non-decreasing in
    length; ``k`` is a request cap, the result may hold fewer."""

    src: int
    dst: int
    k: int = 3
    kind = "kshortest"

    def validate(self, n: int) -> None:
        _check_node(self.src, n, "src")
        _check_node(self.dst, n, "dst")
        if int(self.k) < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")

    def cache_key(self) -> tuple:
        return ("kshortest", int(self.src), int(self.dst), int(self.k))


@dataclasses.dataclass(frozen=True)
class AsOf(Query):
    """Time-travel wrapper: answer ``inner`` against the graph as of
    store ``version`` (reconstructed from the WAL + versioned
    manifests — :mod:`bibfs_tpu_torch.store.history`). ``inner`` may be any
    non-AsOf query; nesting wrappers would mean nothing."""

    inner: Query
    version: int
    kind = "asof"

    def __post_init__(self):
        if isinstance(self.inner, AsOf):
            raise ValueError("AsOf cannot wrap another AsOf query")
        if not isinstance(self.inner, Query):
            object.__setattr__(self, "inner", coerce_query(self.inner))
            if isinstance(self.inner, AsOf):
                raise ValueError("AsOf cannot wrap another AsOf query")

    def validate(self, n: int) -> None:
        if int(self.version) < 1:
            raise ValueError(
                f"as_of version must be >= 1, got {self.version}"
            )
        self.inner.validate(n)

    def cache_key(self) -> tuple:
        return ("asof", int(self.version)) + self.inner.cache_key()


def coerce_query(q) -> Query:
    """A :class:`Query` from whatever a call site passed: a Query
    passes through, a 2-sequence is a :class:`PointToPoint` (the old
    ``(s, d)`` contract). Anything else is a ``ValueError`` — the
    submit-time seam tags it ``kind='invalid'``."""
    if isinstance(q, Query):
        return q
    try:
        s, d = q
        return PointToPoint(int(s), int(d))
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"not a query: {q!r} (expected a Query or an (src, dst) pair)"
        ) from e


# ---- results ---------------------------------------------------------
@dataclasses.dataclass
class MultiSourceResult:
    """One :class:`MultiSource` answer. ``per_source[i]`` is the hop
    count from ``sources[i]`` to ``dst`` (None = unreachable);
    ``best`` indexes the nearest reachable source; ``path`` is a real
    shortest path from that source (validated edge-by-edge in tests)."""

    found: bool                      # any source reaches dst
    per_source: tuple                # hops per source, None = unreachable
    best: Optional[int]              # index of the nearest source
    hops: Optional[int]              # per_source[best]
    path: Optional[list]             # [sources[best], ..., dst]
    time_s: float
    sweeps: int = 1                  # packed sweeps this answer rode


@dataclasses.dataclass
class WeightedResult:
    """One :class:`Weighted` answer: exact weighted distance + path
    (``hops`` is the path's edge count — distinct from ``dist``, the
    weight sum the Dijkstra oracle pins)."""

    found: bool
    dist: Optional[float]
    hops: Optional[int]
    path: Optional[list]
    time_s: float
    relaxations: int = 0
    buckets: int = 0                 # delta-stepping buckets processed


@dataclasses.dataclass
class KShortestResult:
    """One :class:`KShortest` answer: up to k loopless paths, hops
    strictly non-decreasing; ``found`` iff at least one path exists."""

    found: bool
    paths: list                      # list[list[int]], each [src..dst]
    hops: list                       # len(paths), edge counts
    time_s: float


def result_found(res) -> bool:
    """Uniform "did the query connect" read across the result
    taxonomy (every result type carries ``found``)."""
    return bool(getattr(res, "found", False))
