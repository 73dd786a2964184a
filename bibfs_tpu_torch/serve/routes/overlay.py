"""``route="overlay"`` — exact answering while live edge updates are
pending, as a Route: the counterpart of
``bibfs_tpu/serve/routes/overlay.py``.

While a graph has a pending delta overlay, its queries solve exactly
against base + delta on the host (:meth:`~bibfs_tpu_torch.store.delta.
DeltaOverlay.solve`), one by one, and the distance cache stands aside
(its entries describe the base snapshot). Both engines resolve their
tickets from :meth:`OverlayRoute.solve_iter`.
"""

from __future__ import annotations

from bibfs_tpu_torch.serve.resilience import to_query_error
from bibfs_tpu_torch.serve.routes.base import Route


class OverlayRoute(Route):
    """Exact base + delta answering for graphs with pending updates."""

    name = "overlay"

    def eligible(self, rt, pairs) -> bool:
        # the engines route here from the overlay read (its order against
        # the snapshot pin matters; QueryEngine._flush_graph), never from
        # the ladder
        return False

    def solve_iter(self, overlay, keys):
        """Solve each ``(src, dst)`` key against base + delta, yielding
        ``(key, BFSResult | QueryError)``: a failure stays with its query.
        One correction capture serves the whole batch."""
        corr = overlay.correction()
        for key in keys:
            try:
                res = overlay.solve(*key, correction=corr)
            except Exception as exc:
                yield key, to_query_error(exc, key)
                continue
            yield key, res
