"""Per-level solver telemetry — the BFS-phase diagnostic record: the
counterpart of ``bibfs_tpu/obs/telemetry.py``, on the port's registry.

BFS work is famously phase-structured: per-level frontier sizes and
edge scans are the signal every scalable-BFS analysis leans on
(ScalaBFS's per-level pipeline utilization, "Compression and Sieve"'s
per-level communication accounting), yet :class:`BFSResult` only
carried aggregate ``levels``/``edges_scanned``. This module is the
opt-in ``telemetry=`` hook the dense/serial/native solvers accept: when
passed, each expansion round records its side, direction (push/pull),
post-expansion frontier size and edges scanned, plus the round at which
the best meet candidate was found, onto
``BFSResult.level_stats`` — and when NOT passed (the default), the hot
paths run the exact pre-telemetry code (results bit-identical, no
allocation per query).

``level_stats`` shape::

    {"levels": [{"level": 1, "side": "s", "dir": "pull",
                 "frontier": 412, "edges": 3310}, ...],
     "meet_level": 5, "meet": 1234}

``level`` is the solver's global round index (1-based); ``side`` is
"s"/"t"; ``dir`` is "push" or "pull" (serial/native frontier-driven
expansion is push-shaped by construction; the dense solver reports its
Beamer gate's actual choice).
"""

from __future__ import annotations

_FRACTION_HIST = None


def frontier_fraction_hist():
    """The process-wide ``bibfs_level_frontier_fraction`` histogram:
    per-level frontier size as a fraction of ``n``, fed by every
    telemetry-enabled solve that knows its graph size (``n`` set on the
    collector). The adaptive routing layer (``serve/policy.py``) mints
    it at construction so it renders at zero; solves that record into it
    share the same cell."""
    global _FRACTION_HIST
    if _FRACTION_HIST is None:
        from bibfs_tpu_torch.obs.metrics import REGISTRY

        _FRACTION_HIST = REGISTRY.histogram(
            "bibfs_level_frontier_fraction",
            "Per-level frontier size / n of telemetry-enabled solves "
            "(the push/pull and route-shape signal the adaptive "
            "routing policy learns from)",
        )
    return _FRACTION_HIST


class LevelTelemetry:
    """Collector one solve fills. Pass an instance (or ``telemetry=True``,
    which the solvers turn into one) to ``solve_serial_csr`` /
    ``solve_native_graph`` / ``solve_dense_graph`` / ``api.solve``.

    ``n`` (the solved graph's vertex count; the solvers re-stamp it at
    every solve, so a collector reused across graphs records each
    solve against the RIGHT n) additionally lands each level's
    frontier/n in the process ``bibfs_level_frontier_fraction``
    histogram — the observable shape signal
    an adaptive routing policy learns push/pull behavior from.
    Pass ``n=0`` to opt out of the registry traffic entirely (the
    solvers never overwrite 0): levels then record exactly as before
    this histogram existed."""

    __slots__ = ("levels", "meet_level", "meet", "n")

    def __init__(self, n: int | None = None):
        self.levels: list[dict] = []
        self.meet_level: int | None = None
        self.meet: int | None = None
        self.n = n

    def record_level(
        self, level: int, side: str, direction: str,
        frontier: int, edges: int,
    ) -> None:
        self.levels.append({
            "level": int(level),
            "side": side,
            "dir": direction,
            "frontier": int(frontier),
            "edges": int(edges),
        })
        if self.n:
            frontier_fraction_hist().observe(frontier / self.n)

    def note_meet(self, level: int, meet: int | None = None) -> None:
        """Record the round where the best meet candidate (so far) was
        found; later improvements overwrite — the final value is the
        round that produced the answer's meet vertex."""
        self.meet_level = int(level)
        if meet is not None:
            self.meet = int(meet)

    def as_dict(self) -> dict:
        return {
            "levels": self.levels,
            "meet_level": self.meet_level,
            "meet": self.meet,
        }


def coerce(telemetry) -> "LevelTelemetry | None":
    """The solvers' shared argument handling: ``None``/falsy -> None
    (telemetry fully off), ``True`` -> a fresh collector, an existing
    collector passes through."""
    if not telemetry:
        return None
    if telemetry is True:
        return LevelTelemetry()
    return telemetry
