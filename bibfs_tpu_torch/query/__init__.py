"""The query taxonomy: the counterpart of ``bibfs_tpu/query``.

Typed queries (:mod:`bibfs_tpu_torch.query.types`) and the host-tier
solvers behind the kinds other than point-to-point: bitmask-packed
multi-source answering (:mod:`bibfs_tpu_torch.query.msbfs`),
delta-stepping weighted shortest paths with a Dijkstra validation oracle
(:mod:`bibfs_tpu_torch.query.weighted`) and Yen's k-shortest
(:mod:`bibfs_tpu_torch.query.kshortest`), all NumPy. Their device rungs
live in :mod:`bibfs_tpu_torch.solvers.query_device` (hand-written CUDA
kernels) and :mod:`bibfs_tpu_torch.ops.msbfs_device`; the serving routes
in :mod:`bibfs_tpu_torch.serve.routes.taxonomy` and
:mod:`bibfs_tpu_torch.serve.routes.taxonomy_device`; the time-travel
reconstruction behind :class:`AsOf` in :mod:`bibfs_tpu_torch.store.history`.

Importing the taxonomy pulls neither torch nor the serving stack.
"""

from bibfs_tpu_torch.query.types import (
    MSBFS_WORD,
    QUERY_KINDS,
    AsOf,
    KShortest,
    KShortestResult,
    MultiSource,
    MultiSourceResult,
    PointToPoint,
    Query,
    Weighted,
    WeightedResult,
    coerce_query,
    result_found,
)

__all__ = [
    "MSBFS_WORD",
    "QUERY_KINDS",
    "AsOf",
    "KShortest",
    "KShortestResult",
    "MultiSource",
    "MultiSourceResult",
    "PointToPoint",
    "Query",
    "Weighted",
    "WeightedResult",
    "coerce_query",
    "result_found",
]
