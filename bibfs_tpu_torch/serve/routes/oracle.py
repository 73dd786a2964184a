"""``route="oracle"`` — the landmark distance oracle as a Route: the
counterpart of ``bibfs_tpu/serve/routes/oracle.py``.

The consult (two row reads of an immutable index,
:mod:`bibfs_tpu_torch.oracle`) answers at submit time, with no queueing
and no solver, so the route sits outside the flush ladder: both engines
consult it before the distance cache and before the overlay route (a
store's oracle is returned only while its index describes the current
live graph, pending overlay included). A consult that yields bounds arms
the ticket's ``cutoff`` with the proven upper bound for the host rungs.
"""

from __future__ import annotations

from bibfs_tpu_torch.serve.routes.base import Route


class OracleRoute(Route):
    """Submit-time exact answering from the landmark index."""

    name = "oracle"

    def eligible(self, rt, pairs) -> bool:
        # consulted per ticket at submit time, never from the ladder
        return False

    def consult(self, ticket, graph_name) -> bool:
        """Consult the oracle for one submitted query. True: served exactly
        (``ticket.result`` set); False: fall through, with
        ``ticket.cutoff`` armed when the consult gave an upper bound."""
        orc = self.engine._oracle_for(graph_name)
        if orc is None:
            return False
        ans = orc.consult(ticket.src, ticket.dst)
        if ans is None:
            return False
        if ans.result is not None:
            ticket.result = ans.result
            return True
        ticket.cutoff = ans.ub
        return False
