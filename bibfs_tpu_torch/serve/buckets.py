"""Shape buckets and executable-reuse accounting for the serving engine:
the counterpart of ``bibfs_tpu/serve/buckets.py``.

Every incoming graph is padded UP to a small geometric ladder of shapes
(rows x2 from 128, ELL width x2 from 8, batch x2 from 128 lanes), so
any mix of graph sizes and queue depths funnels into a handful of
padded geometries. In this package the batch-minor search caches one
built search per padded geometry
(``batch_minor._build_minor_kernel``), so a bucket hit reuses it, and
the CUDA kernels themselves are compiled once per process whatever the
shape. The bucket ladders are the JAX package's unchanged, so both
packages pad one graph to the same table.

Padding is semantically free: bucket rows are isolated degree-0 vertices
and bucket width columns sit beyond every true degree, and all use sites
mask by ``deg``.

:class:`ExecutableCache` is the accounting side: the engine notes the
(bucket shape, resolved mode, batch bucket) of every device dispatch.
:func:`dp_aligned_ell` is the data-parallel batch's table (rows on a fine
ladder, width on the geometric rung) and :func:`repad_rows` the mesh
route's shard-divisibility pad.
"""

from __future__ import annotations

import threading

import numpy as np

from bibfs_tpu_torch.graph.csr import EllGraph, build_ell
from bibfs_tpu_torch.obs.metrics import REGISTRY, next_instance_label

# Geometric ladders. Rows start at 128 (one lane group) and double;
# widths start at the int32 sublane quantum 8 and double; batch buckets
# start at one 128-lane group and double (bucket_batch). Ratio 2 bounds
# pad waste at <2x while keeping the ladder ~17 rungs deep to 10M nodes.
ROW_BUCKET_BASE = 128
WIDTH_BUCKET_BASE = 8
BATCH_BUCKET_BASE = 128


def _next_rung(base: int, value: int) -> int:
    rung = base
    while rung < value:
        rung *= 2
    return rung


def bucket_rows(n_pad: int) -> int:
    """Smallest row rung (128 * 2^k) holding ``n_pad`` vertex rows."""
    return _next_rung(ROW_BUCKET_BASE, max(1, n_pad))


def bucket_width(width: int) -> int:
    """Smallest ELL-width rung (8 * 2^k) holding ``width`` slots."""
    return _next_rung(WIDTH_BUCKET_BASE, max(1, width))


def bucket_batch(num_queries: int) -> int:
    """Smallest batch rung (128 * 2^k) holding ``num_queries`` — the
    engine pads every flush to a rung so repeat traffic at any queue
    depth reuses a handful of compiled batch programs."""
    return _next_rung(BATCH_BUCKET_BASE, max(1, num_queries))


def bucket_shape(n_pad: int, width: int) -> tuple[int, int]:
    return bucket_rows(n_pad), bucket_width(width)


def ell_bucket_key(g) -> tuple:
    """The program shape identity of an (already bucketed) ELL device
    table: everything the batch search caches on besides batch mode and
    rung. Two graphs — or two versions of one graph — with the same key
    reuse one built batch search. This is the single-device identity;
    multi-device keys come with the multi-GPU slice."""
    return ("ell", g.n_pad, g.width)


def placement_bucket_key(base_key: tuple, *, kind: str, shards: int,
                         extra: tuple = ()) -> tuple:
    """Extend a shape bucket key with its placement: ``kind`` names the
    placement family (``"blocked"`` the tile route; the mesh families come
    with the multi-GPU slice), ``shards`` the device count, ``extra`` any
    further program discriminators (plane type, batch rung). A blocked
    program thus never counts as a hit on a device executable of the same
    padded vertex shape."""
    return base_key + ((kind, int(shards)) + tuple(extra),)


#: row alignment of the data-parallel batch's replicated table
#: (:func:`dp_aligned_ell`), the reference's
DP_ROW_ALIGN = 1024


def dp_aligned_ell(n: int, edges: np.ndarray | None = None, *,
                   pairs: np.ndarray | None = None,
                   row_align: int = DP_ROW_ALIGN) -> EllGraph:
    """The data-parallel batch's (queries sharded, graph replicated)
    table: rows aligned to the fine ``row_align`` ladder, not the
    geometric row rung (a rank's batch planes scale with the rows), and
    the width bucketed to its geometric rung; the reference's table."""
    g = build_ell(n, edges, pairs=pairs, pad_multiple=max(int(row_align), 8))
    w = bucket_width(g.width)
    if w == g.width:
        return g
    nbr = np.zeros((g.n_pad, w), dtype=np.int32)
    nbr[:, : g.width] = g.nbr
    return EllGraph(n=g.n, n_pad=g.n_pad, width=w, num_edges=g.num_edges,
                    nbr=nbr, deg=g.deg, overflow=g.overflow)


def repad_rows(g: EllGraph, multiple: int) -> EllGraph:
    """Re-pad an ELL table's rows up to a multiple (isolated degree-0
    rows): the shard-divisibility fix for a mesh whose size does not
    divide the table's rows."""
    mult = max(int(multiple), 1)
    if g.n_pad % mult == 0:
        return g
    rows = -(-g.n_pad // mult) * mult
    nbr = np.zeros((rows, g.width), dtype=np.int32)
    nbr[: g.n_pad] = g.nbr
    deg = np.zeros(rows, dtype=np.int32)
    deg[: g.n_pad] = g.deg
    return EllGraph(n=g.n, n_pad=rows, width=g.width, num_edges=g.num_edges,
                    nbr=nbr, deg=deg, overflow=g.overflow)


def bucketed_ell(
    n: int,
    edges: np.ndarray | None = None,
    *,
    pairs: np.ndarray | None = None,
) -> EllGraph:
    """`build_ell` padded up to its shape bucket.

    The returned graph reports the bucket as its ``n_pad``/``width``, so
    everything downstream (device upload, kernel geometry, chunk math)
    sees only the bucketed shape; ``n`` stays the true vertex count for
    range checks and result slicing."""
    g = build_ell(n, edges, pairs=pairs)
    rows, width = bucket_shape(g.n_pad, g.width)
    if (rows, width) == (g.n_pad, g.width):
        return g
    nbr = np.zeros((rows, width), dtype=np.int32)
    nbr[: g.n_pad, : g.width] = g.nbr
    deg = np.zeros(rows, dtype=np.int32)
    deg[: g.n_pad] = g.deg
    return EllGraph(
        n=g.n,
        n_pad=rows,
        width=width,
        num_edges=g.num_edges,
        nbr=nbr,
        deg=deg,
        overflow=g.overflow,
    )


class ExecutableCache:
    """Hit/miss accounting over compiled-program identities.

    A *program key* is everything the batch search caches on for a
    dispatch: the bucketed table shape, the resolved batch mode, and the
    batch rung. ``note()`` returns whether that program was already
    seen. One process-wide instance
    (:data:`DEFAULT_EXEC_CACHE`) is shared by default so engines over
    different graphs in one bucket see each other's compiles — exactly
    the reuse the buckets exist to create. Thread-safe throughout.

    All accounting lives in the process metrics registry under the
    stable documented names ``bibfs_exec_cache_events_total{cache,
    event="hit"|"miss"}``, ``bibfs_exec_programs{cache}`` and
    ``bibfs_exec_program_dispatches_total{cache,program}``;
    ``stats()``/``program_counts()`` are snapshot views over them."""

    def __init__(self, metrics_label: str | None = None):
        self._seen: dict = {}  # program key -> dispatch count
        self._lock = threading.Lock()
        self.metrics_label = (
            next_instance_label("exec") if metrics_label is None
            else metrics_label
        )
        events = REGISTRY.counter(
            "bibfs_exec_cache_events_total",
            "Compiled-program reuse accounting (hit = reused executable)",
            ("cache", "event"),
        )
        self._m_hit = events.labels(cache=self.metrics_label, event="hit")
        self._m_miss = events.labels(cache=self.metrics_label, event="miss")
        self._g_programs = REGISTRY.gauge(
            "bibfs_exec_programs",
            "Distinct compiled programs dispatched through this cache",
            ("cache",),
        ).labels(cache=self.metrics_label)
        self._m_dispatch = REGISTRY.counter(
            "bibfs_exec_program_dispatches_total",
            "Dispatches per compiled-program identity",
            ("cache", "program"),
        )
        # minted at construction so the family renders at zero: compiles
        # are a first-class scrape-time signal — in steady state
        # rate(bibfs_exec_compiles_total) must be 0, and an alert on it
        # catches a retrace leak without waiting for a bench-time
        # program_counts() diff
        self._m_compile = REGISTRY.counter(
            "bibfs_exec_compiles_total",
            "First-seen compiled programs (a steady-state serving "
            "process must not pay new compiles)",
            ("cache", "program"),
        )

    @property
    def hits(self) -> int:
        return self._m_hit.value

    @property
    def misses(self) -> int:
        return self._m_miss.value

    def note(self, key) -> bool:
        """Record a dispatch under ``key``; True iff already seen.

        The registry cells are lock-free (obs/metrics.py's contract:
        mutators of one cell serialize externally), so every increment
        happens under THIS cache's lock — it is the shared
        DEFAULT_EXEC_CACHE that concurrent engines note into.

        The JAX package also publishes a missed key to its retrace
        sentinel (``analysis/compilegraph``); this package has no
        sentinel yet — the torch recompile check is ROADMAP Queue 1,
        item 11 — so the seam is a no-op here."""
        with self._lock:
            if key in self._seen:
                self._seen[key] += 1
                hit = True
                self._m_hit.inc()
            else:
                self._seen[key] = 1
                hit = False
                self._m_miss.inc()
                self._g_programs.inc()
                self._m_compile.labels(
                    cache=self.metrics_label, program=str(key)
                ).inc()
            self._m_dispatch.labels(
                cache=self.metrics_label, program=str(key)
            ).inc()
        return hit

    def stats(self) -> dict:
        with self._lock:  # one atomic snapshot: a miss always inserts
            return {
                "hits": self._m_hit.value,
                "misses": self._m_miss.value,
                "programs": len(self._seen),
            }

    def program_counts(self, top: int | None = None) -> dict:
        """Per-program dispatch counts, hottest first — the load
        harness's view of which compiled executables actually carry
        traffic (keys stringified for JSON artifacts)."""
        with self._lock:
            ranked = sorted(
                self._seen.items(), key=lambda kv: kv[1], reverse=True
            )
        if top is not None:
            ranked = ranked[:top]
        return {str(k): v for k, v in ranked}


DEFAULT_EXEC_CACHE = ExecutableCache(metrics_label="default")
