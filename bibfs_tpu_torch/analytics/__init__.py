"""Whole-graph semiring analytics over the blocked tile substrate: the
counterpart of ``bibfs_tpu/analytics``.

A BFS level is one instance of a family: swap the (OR, AND) semiring
under the same tiled adjacency product and the machinery computes
whole-graph analytics. This package is that seam made explicit:

- :mod:`bibfs_tpu_torch.analytics.semiring` — the
  :class:`~bibfs_tpu_torch.analytics.semiring.Semiring` abstraction, the CSR
  host kernels, and the INDEPENDENT references every kind is pinned to
  (Dijkstra / dense power iteration / union-find / adjacency-
  intersection triangle count);
- :mod:`bibfs_tpu_torch.analytics.queries` — the typed whole-graph query
  kinds (``sssp`` / ``pagerank`` / ``components`` / ``triangles``)
  riding the query kinds' ladder;
- :mod:`bibfs_tpu_torch.analytics.results` — the per-digest whole-graph
  result store (sidecar arrays next to durable checkpoints, served on
  repeat queries, incrementally maintained across adds-only deltas,
  mmap-recovered after respawn).

The blocked rungs live in :mod:`bibfs_tpu_torch.ops.semiring_plane` (the
hand-written CUDA fixpoints of ``csrc/semiring.cu`` and their plain torch
twins) and :mod:`bibfs_tpu_torch.serve.routes.analytics` (the ladder
rungs).
"""

from __future__ import annotations

from bibfs_tpu_torch.analytics.queries import (
    ANALYTICS_KINDS,
    Components,
    ComponentsResult,
    PageRank,
    PageRankResult,
    Sssp,
    SsspResult,
    Triangles,
    TrianglesResult,
    analytics_query_from_spec,
    analytics_summary,
)
from bibfs_tpu_torch.analytics.semiring import SEMIRINGS, Semiring

__all__ = [
    "ANALYTICS_KINDS",
    "SEMIRINGS",
    "Semiring",
    "Sssp",
    "SsspResult",
    "PageRank",
    "PageRankResult",
    "Components",
    "ComponentsResult",
    "Triangles",
    "TrianglesResult",
    "analytics_query_from_spec",
    "analytics_summary",
]
