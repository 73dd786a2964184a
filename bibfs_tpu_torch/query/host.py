"""One host-tier solve for any (non-AsOf) taxonomy query over a CSR: the
counterpart of ``bibfs_tpu/query/host.py``.

The shared dispatch the serving AsOf route (historical snapshots have
no serving tier — time-travel is a read path) and the
``solvers/api.py`` convenience entry both use: given the
``(row_ptr, col_ind)`` truth, route the query to its kind's host
implementation and return its typed result.
"""

from __future__ import annotations

from bibfs_tpu_torch.query.types import (
    AsOf,
    KShortest,
    MultiSource,
    PointToPoint,
    Weighted,
)


def solve_query_csr(n: int, row_ptr, col_ind, q):
    """Solve one typed query on the host tier. ``AsOf`` is rejected —
    resolving a version needs a store (the serving route / the api
    entry unwrap it first)."""
    if isinstance(q, PointToPoint):
        from bibfs_tpu_torch.solvers.serial import solve_serial_csr

        return solve_serial_csr(n, row_ptr, col_ind, q.src, q.dst)
    if isinstance(q, MultiSource):
        from bibfs_tpu_torch.query.msbfs import solve_multi_source

        return solve_multi_source(n, row_ptr, col_ind, [q])[0]
    if isinstance(q, Weighted):
        from bibfs_tpu_torch.query.weighted import delta_stepping, synthetic_weights

        w = synthetic_weights(row_ptr, col_ind, int(q.weight_seed))
        return delta_stepping(n, row_ptr, col_ind, w, q.src, q.dst)
    if isinstance(q, KShortest):
        from bibfs_tpu_torch.query.kshortest import yen_k_shortest

        return yen_k_shortest(n, row_ptr, col_ind, q.src, q.dst, q.k)
    if isinstance(q, AsOf):
        raise ValueError(
            "AsOf resolves through a store (serve.routes.taxonomy / "
            "api.solve_query with store=); solve_query_csr takes the "
            "inner query against the reconstructed CSR"
        )
    raise ValueError(f"unknown query type {type(q).__name__}")
