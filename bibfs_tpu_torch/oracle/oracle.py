"""Per-query answering over one landmark index: the counterpart of
``bibfs_tpu/oracle/oracle.py``.

For a query ``(s, t)`` and landmark distances ``d(L, .)`` the triangle
inequality gives, over every landmark L reaching both endpoints::

    LB = max_L |d(s, L) - d(L, t)|  <=  d(s, t)  <=  UB = min_L d(s, L) + d(L, t)

The oracle answers exactly in three cases and never guesses:

- **landmark** — an endpoint is a landmark L: ``d(s, t) = d(L, other)``;
- **tight** — ``LB == UB``;
- **disconnected** — the landmark reach sets of s and t are disjoint and
  one is non-empty: the pair lies in different components.

Otherwise it returns **bounds** (``LB < UB``: the engine hands UB to the
host search as a cutoff) or a **miss** (no landmark reaches either
endpoint). Outcomes count in ``bibfs_oracle_hits_total{oracle,kind}``.
Oracle results carry ``path=None``: ``found``/``hops`` are exact, and a
caller needing the vertex list goes to a solver.
"""

from __future__ import annotations

import numpy as np

from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.oracle.trees import LandmarkIndex
from bibfs_tpu_torch.solvers.api import BFSResult

# consult outcomes that serve the query (route="oracle"); "bounds" only
# arms a cutoff and "miss" falls through
ORACLE_SERVED_KINDS = ("landmark", "tight", "disconnected")
ORACLE_KINDS = ORACLE_SERVED_KINDS + ("bounds", "miss")


def oracle_cells(label: str) -> dict:
    """Mint (or re-fetch) the ``bibfs_oracle_hits_total`` cells of one
    oracle label: the store mints them at registration, so a scrape shows
    the family at zero, and carries them across index rebuilds."""
    hits = REGISTRY.counter(
        "bibfs_oracle_hits_total",
        "Distance-oracle consults by outcome kind (landmark/tight/"
        "disconnected serve exactly; bounds arms a search cutoff; "
        "miss falls through)",
        ("oracle", "kind"),
    )
    return {k: hits.labels(oracle=label, kind=k) for k in ORACLE_KINDS}


class OracleAnswer:
    """One consult's outcome: an exact :class:`BFSResult` for the served
    kinds, None for ``bounds`` (``lb``/``ub`` carry the information)."""

    __slots__ = ("kind", "result", "lb", "ub")

    def __init__(self, kind: str, result: BFSResult | None = None,
                 lb: int | None = None, ub: int | None = None):
        self.kind = kind
        self.result = result
        self.lb = lb
        self.ub = ub

    def __repr__(self) -> str:
        return f"OracleAnswer({self.kind}, lb={self.lb}, ub={self.ub})"


class DistanceOracle:
    """Query answering over one immutable :class:`LandmarkIndex`: the store
    swaps oracles by pointer assignment while in-flight consults finish on
    the index they hold. ``metrics_label`` is the ``oracle=`` label of its
    cells; ``cells`` carries counters across index swaps of one graph."""

    def __init__(self, index: LandmarkIndex, *,
                 metrics_label: str = "oracle", cells: dict | None = None):
        self.index = index
        self.metrics_label = metrics_label
        self._m = oracle_cells(metrics_label) if cells is None else cells

    @property
    def cells(self) -> dict:
        return self._m

    def consult(self, src: int, dst: int) -> OracleAnswer | None:
        """One consult: an endpoint that is a landmark reads one cell;
        otherwise two ``dist32`` rows and a few reductions over K values.
        Returns None on a miss (and counts it)."""
        idx = self.index
        inf = idx.CONSULT_INF
        col = idx.lm_col.get(src)
        other = dst
        if col is None:
            col = idx.lm_col.get(dst)
            other = src
        if col is not None:
            d = int(idx.dist32[other, col])
            if d < inf:
                self._m["landmark"].inc()
                return OracleAnswer(
                    "landmark",
                    BFSResult(True, d, None, None, 0.0, 0, 0),
                    lb=d, ub=d,
                )
            self._m["disconnected"].inc()
            return OracleAnswer(
                "disconnected",
                BFSResult(False, None, None, None, 0.0, 0, 0),
            )
        ds = idx.dist32[src]
        dt = idx.dist32[dst]
        su = ds + dt
        ub = int(su.min())
        if ub < inf:  # some landmark reaches both endpoints
            # |ds - dt| bounds only over both-reachable landmarks: su < INF
            lb = int(np.abs(ds - dt)[su < inf].max())
            if lb == ub:
                self._m["tight"].inc()
                return OracleAnswer(
                    "tight",
                    BFSResult(True, ub, None, None, 0.0, 0, 0),
                    lb=lb, ub=ub,
                )
            self._m["bounds"].inc()
            return OracleAnswer("bounds", None, lb=lb, ub=ub)
        if (ds < inf).any() or (dt < inf).any():
            # disjoint reach sets, one non-empty: different components
            self._m["disconnected"].inc()
            return OracleAnswer(
                "disconnected",
                BFSResult(False, None, None, None, 0.0, 0, 0),
            )
        self._m["miss"].inc()
        return None

    def stats(self) -> dict:
        return {
            "index": self.index.stats(),
            "hits": {k: c.value for k, c in self._m.items()},
        }
