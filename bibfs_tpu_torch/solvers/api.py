"""The single solver API every backend implements: a function returning a
:class:`BFSResult`, registered by name and reached through :func:`solve`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class BFSResult:
    found: bool
    hops: Optional[int]  # true shortest-path edge count (None if no path)
    path: Optional[list[int]]  # [src, ..., dst] (None if no path)
    meet: Optional[int]  # meeting vertex of the two searches
    time_s: float  # search loop only
    levels: int  # number of frontier expansions performed
    edges_scanned: int  # directed edges examined (for TEPS)
    # the dense mode that actually ran (a tiered graph routes "fused" to
    # "pallas"); None for host backends
    mode: Optional[str] = None
    # device->host reads the search loop made (its termination checks)
    host_syncs: Optional[int] = None

    @property
    def teps(self) -> float:
        return self.edges_scanned / self.time_s if self.time_s > 0 else float("inf")

    def validate_path(self, n: int, edges: np.ndarray, src: int, dst: int) -> None:
        """Raise ``AssertionError`` unless the reported path is a real path
        of the reported length (CSR binary search per path edge)."""
        if not self.found:
            return
        from bibfs_tpu_torch.graph.csr import build_csr

        if not validate_path(build_csr(n, edges), self.path, src, dst,
                             hops=self.hops):
            raise AssertionError(
                f"invalid path {self.path} for src={src} dst={dst}"
            )


def validate_path(csr, path, src, dst, hops=None) -> bool:
    """True iff ``path`` is a real src->dst walk in the CSR adjacency
    ``(row_ptr, col_ind)`` with ascending rows; ``hops`` additionally pins
    the claimed length. Costs O(len(path) * log max_deg)."""
    if path is None or len(path) == 0:
        return False
    if path[0] != src or path[-1] != dst:
        return False
    if hops is not None and hops != len(path) - 1:
        return False
    row_ptr, col_ind = csr
    n = row_ptr.shape[0] - 1
    p = np.asarray(path, dtype=np.int64)
    if p.min() < 0 or p.max() >= n:
        return False
    for a, b in zip(p[:-1], p[1:]):
        row = col_ind[row_ptr[a] : row_ptr[a + 1]]
        i = np.searchsorted(row, b)
        if i >= row.size or row[i] != b:
            return False
    return True


SOLVERS: dict[str, Callable] = {}

# backend name -> implementing module, imported lazily
BACKEND_MODULES = {
    "serial": "bibfs_tpu_torch.solvers.serial",
    "dense": "bibfs_tpu_torch.solvers.dense",
    "native": "bibfs_tpu_torch.solvers.native",
}


def register(name: str):
    def deco(fn):
        SOLVERS[name] = fn
        return fn

    return deco


def solve(
    backend: str, n: int, edges: np.ndarray, src: int, dst: int, **kwargs
) -> BFSResult:
    """Uniform entry: build whatever representation the backend needs and
    run. Use the backend modules directly to time graph build and search
    separately."""
    if backend not in SOLVERS:
        if backend not in BACKEND_MODULES:
            raise KeyError(
                f"unknown backend {backend!r}; have {sorted(BACKEND_MODULES)}"
            )
        import importlib

        importlib.import_module(BACKEND_MODULES[backend])
    return SOLVERS[backend](n, edges, src, dst, **kwargs)


def solve_many(
    n: int, edges: np.ndarray, pairs, *, pipelined: bool = False,
    return_errors: bool = False, **engine_kwargs,
) -> list:
    """Serve a query list through the micro-batching engine
    (:class:`bibfs_tpu_torch.serve.QueryEngine`): one call builds the
    engine (shape-bucketed device graph, distance/result cache), routes
    the queries through its batch crossover (the batched device search at
    or above it, the host runtime below) and returns one
    :class:`BFSResult` per pair. The engine runs on ``cuda`` unless
    ``device="cpu"`` is passed; ``engine_kwargs`` go to its constructor.

    A query that is invalid on its own (an out-of-range id, a bad arity)
    never fails its batch-mates: its slot holds a ``kind='invalid'``
    :class:`bibfs_tpu_torch.serve.resilience.QueryError`.
    ``return_errors=True`` extends that to every failure kind; the
    default re-raises the first failure that is not ``invalid``.
    ``pipelined=True`` (the pipelined engine) is not ported yet."""
    if pipelined:
        raise NotImplementedError(
            "pipelined=True needs the pipelined engine, which is not "
            "ported yet (ROADMAP Queue 1, item 1)"
        )
    from bibfs_tpu_torch.serve import QueryEngine
    from bibfs_tpu_torch.serve.resilience import QueryError

    with QueryEngine(n, edges, **engine_kwargs) as eng:
        results = eng.query_many(pairs, return_errors=True)
    if not return_errors:
        for r in results:
            if isinstance(r, QueryError) and r.kind != "invalid":
                raise r
    return results
