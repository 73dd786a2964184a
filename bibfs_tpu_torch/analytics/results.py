"""The per-digest whole-graph result store — analytics answers that
outlive their flush: the counterpart of ``bibfs_tpu/analytics/results.py``,
whose directory format it shares (either package adopts the other's
``<wal_dir>/analytics/`` entries).

Point queries are cheap to recompute; whole-graph vectors (ranks,
component labels, distance columns) are not. This store keeps them:

- **keyed by snapshot digest**: an entry is the answer for one
  ``(graph, query.cache_key())`` against ONE settled snapshot — the
  same no-aliasing argument as the distance cache and kind cache;
- **persisted as sidecar arrays** next to the durable checkpoints
  (``<wal_dir>/analytics/``): each entry commits as a fresh directory
  (``.npy`` per vector + ``meta.json``) renamed into place — the
  rename-last discipline of ``store/sidecar.py`` — and recovers after
  respawn by ``np.load(mmap_mode='r')``, as the memory tiers map;
- **delta-aware**: the graph store feeds it the digest lineage —
  ``note_update`` (pending overlay deltas), ``note_fold`` (overlay
  compacted into a new digest), ``note_swap`` (wholesale replacement).
  A stored entry whose digest is an ADDS-ONLY ancestor of the current
  digest is **incrementally maintained** instead of recomputed
  (:func:`maintain_sssp` decrease-only relaxation,
  :func:`maintain_components` label re-merge); deletes, swaps, or
  value-global kinds (pagerank, triangles: one new edge moves every
  entry) invalidate.

Locking: one leaf lock over the in-memory index. Every file
open/rename/remove happens OUTSIDE ``self._lock`` (the ``lock-io``
rule) — persists build a complete tmp directory first and publish it
with one ``os.rename``; deletions are deferred to a sweep at the next
store call. The graph store calls the ``note_*`` hooks from its own
locked commits, which is safe because this lock is a leaf: nothing
here calls back into the graph store.

Metrics (the reference's names, kinds and labels):
``bibfs_analytics_store_events_total{store,event}`` (``hit`` /
``miss`` / ``put`` / ``incremental`` / ``invalidated`` / ``load`` /
``evict`` — all cells minted at construction) and
``bibfs_analytics_store_entries{store}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from collections import OrderedDict

import numpy as np

from bibfs_tpu_torch.utils.annotations import guarded_by
from bibfs_tpu_torch.obs.metrics import REGISTRY

#: kinds whose stored vectors are maintainable across adds-only deltas
MAINTAINABLE_KINDS = frozenset({"sssp", "components"})

#: the store event vocabulary, minted at construction so the whole
#: family renders at zero before the first analytics query
STORE_EVENTS = (
    "hit", "miss", "put", "incremental", "invalidated", "load", "evict",
)


def _hash_token(value) -> str:
    return hashlib.sha1(repr(value).encode("utf-8")).hexdigest()[:16]


class _Entry:
    """One stored whole-graph answer (arrays mmap-lazy when the entry
    was recovered from disk)."""

    __slots__ = ("digest", "kind", "key", "arrays", "scalars", "path")

    def __init__(self, *, digest, kind, key, arrays, scalars, path):
        self.digest = digest
        self.kind = kind
        self.key = key
        self.arrays = arrays  # dict name -> ndarray, or None until load
        self.scalars = scalars
        self.path = path


class _GraphLog:
    """One graph's digest lineage + entries. ``head`` is the last
    settled digest the graph store told us about; ``segments`` are the
    recorded ``from -> to`` transitions (``adds`` is the int64 [k, 2]
    edge batch, or None for a non-adds-only barrier)."""

    __slots__ = (
        "head", "segments", "entries",
        "pending_adds", "pending_dels", "pending_count",
    )

    def __init__(self):
        self.head = None
        self.segments: list = []
        self.entries: OrderedDict = OrderedDict()
        self.pending_adds: list = []
        self.pending_dels = False
        self.pending_count = 0


@guarded_by("_lock", "_graphs", "_scanned", "_dead")
class AnalyticsResultStore:
    """Module docstring. ``root=None`` is the memory-only store (a
    non-durable graph store): same serving/maintenance semantics,
    nothing survives the process."""

    MAX_SEGMENTS = 8
    MAX_PENDING_EDGES = 4096
    MAX_ENTRIES_PER_GRAPH = 32

    def __init__(self, root=None, *, store_label: str = "store"):
        self._root = None if root is None else os.fspath(root)
        self._lock = threading.Lock()
        self._graphs: dict[str, _GraphLog] = {}
        self._scanned: set = set()
        self._dead: list = []
        events = REGISTRY.counter(
            "bibfs_analytics_store_events_total",
            "Whole-graph analytics result store events (hit/miss/put/"
            "incremental/invalidated/load/evict)",
            ("store", "event"),
        )
        self._events = {
            e: events.labels(store=store_label, event=e)
            for e in STORE_EVENTS
        }
        self._g_entries = REGISTRY.gauge(
            "bibfs_analytics_store_entries",
            "Whole-graph analytics results currently stored",
            ("store",),
        ).labels(store=store_label)

    # ---- digest-lineage hooks (called by the graph store) -----------
    def note_register(self, name: str, digest) -> None:
        """A graph registered/recovered at ``digest`` — the lineage
        origin."""
        with self._lock:
            g = self._graphs.setdefault(name, _GraphLog())
            if g.head is None:
                g.head = digest

    def note_update(self, name: str, adds, dels) -> None:
        """An acked overlay delta batch (pre-fold). Cheap append only —
        this runs inside the graph store's locked commit."""
        with self._lock:
            g = self._graphs.setdefault(name, _GraphLog())
            if dels is not None and len(dels):
                g.pending_dels = True
            if adds is not None and len(adds):
                batch = np.asarray(adds, dtype=np.int64).reshape(-1, 2)
                g.pending_count += int(batch.shape[0])
                if g.pending_count <= self.MAX_PENDING_EDGES:
                    g.pending_adds.append(batch)

    def note_fold(self, name: str, new_digest, *, clean: bool) -> None:
        """The overlay compacted into a fresh snapshot: record the
        ``head -> new_digest`` transition. ``clean=False`` (rebase
        residue left behind) or pending deletes/overflow make it a
        barrier — entries behind it invalidate instead of maintaining."""
        with self._lock:
            g = self._graphs.setdefault(name, _GraphLog())
            adds_only = (
                clean and g.head is not None and not g.pending_dels
                and g.pending_count <= self.MAX_PENDING_EDGES
            )
            adds = None
            if adds_only:
                adds = (
                    np.concatenate(g.pending_adds)
                    if g.pending_adds
                    else np.zeros((0, 2), dtype=np.int64)
                )
            g.segments.append((g.head, new_digest, adds))
            del g.segments[: -self.MAX_SEGMENTS]
            g.head = new_digest
            g.pending_adds = []
            g.pending_dels = False
            g.pending_count = 0

    def note_swap(self, name: str, new_digest) -> None:
        """A wholesale snapshot replacement: every stored entry for the
        graph is stale with no maintainable lineage."""
        with self._lock:
            g = self._graphs.setdefault(name, _GraphLog())
            n_dead = len(g.entries)
            for e in g.entries.values():
                if e.path is not None:
                    self._dead.append(e.path)
            g.entries.clear()
            g.segments.clear()
            g.head = new_digest
            g.pending_adds = []
            g.pending_dels = False
            g.pending_count = 0
            if n_dead:
                self._events["invalidated"].inc(n_dead)
            self._refresh_entries_locked()

    def purge(self, name: str) -> None:
        """The graph left the store entirely."""
        with self._lock:
            g = self._graphs.pop(name, None)
            self._scanned.discard(name)
            if g is not None:
                for e in g.entries.values():
                    if e.path is not None:
                        self._dead.append(e.path)
                self._refresh_entries_locked()
        self._sweep()

    # ---- serving path ------------------------------------------------
    def lookup(self, name: str, key, digest):
        """The engine-seam consult. Returns ``("hit", entry)`` for an
        exact-digest answer, ``("maintain", entry, adds)`` when the
        entry's digest reaches ``digest`` through adds-only segments
        (``adds`` is the concatenated int64 [k, 2] batch — possibly
        empty — and the caller owns running the maintenance and
        committing it back), or None."""
        self._ensure_scanned(name)
        self._sweep()
        key = _key_id(key)
        with self._lock:
            g = self._graphs.get(name)
            entry = None if g is None else g.entries.get(key)
            if entry is None:
                self._events["miss"].inc()
                return None
            g.entries.move_to_end(key)
            if entry.digest == digest:
                self._load_locked(entry)
                if entry.arrays is None:
                    return self._drop_locked(g, key, entry)
                self._events["hit"].inc()
                return ("hit", entry)
            chain = self._chain_locked(g, entry.digest, digest)
            if chain is None or entry.kind not in MAINTAINABLE_KINDS:
                if chain is not None and not chain.shape[0]:
                    # no-op transitions: the answer is unchanged for
                    # EVERY kind — retag in place and serve
                    entry.digest = digest
                    self._load_locked(entry)
                    if entry.arrays is None:
                        return self._drop_locked(g, key, entry)
                    self._events["hit"].inc()
                    return ("hit", entry)
                return self._drop_locked(g, key, entry)
            self._load_locked(entry)
            if entry.arrays is None:
                return self._drop_locked(g, key, entry)
            return ("maintain", entry, chain)

    def put(self, name: str, key, digest, kind, arrays: dict,
            scalars: dict, *, event: str = "put") -> None:
        """Store (and persist) one computed whole-graph answer."""
        self._sweep()
        key = _key_id(key)
        path = self._persist(name, key, digest, kind, arrays, scalars)
        with self._lock:
            g = self._graphs.setdefault(name, _GraphLog())
            old = g.entries.pop(key, None)
            if old is not None and old.path and old.path != path:
                self._dead.append(old.path)
            g.entries[key] = _Entry(
                digest=digest, kind=kind, key=key,
                arrays=dict(arrays), scalars=dict(scalars), path=path,
            )
            g.entries.move_to_end(key)
            self._events[event].inc()
            while len(g.entries) > self.MAX_ENTRIES_PER_GRAPH:
                _k, ev = g.entries.popitem(last=False)
                if ev.path is not None:
                    self._dead.append(ev.path)
                self._events["evict"].inc()
            self._refresh_entries_locked()
        self._sweep()

    def commit_maintained(self, name: str, key, digest, kind,
                          arrays: dict, scalars: dict) -> None:
        """The caller ran the incremental maintenance — store the
        retagged answer (counted ``incremental``, the witness
        that no full recompute happened)."""
        self.put(name, key, digest, kind, arrays, scalars,
                 event="incremental")

    def stats(self) -> dict:
        with self._lock:
            return {
                "graphs": len(self._graphs),
                "entries": sum(
                    len(g.entries) for g in self._graphs.values()
                ),
                "segments": sum(
                    len(g.segments) for g in self._graphs.values()
                ),
                "durable": self._root is not None,
                # this store's slice of the event counters — the soak's
                # served-without-recompute witness
                "events": {
                    e: int(c.value) for e, c in self._events.items()
                },
            }

    # ---- lineage walk ------------------------------------------------
    def _chain_locked(self, g: _GraphLog, from_digest, to_digest):
        """The concatenated adds along ``from -> ... -> to``, or None
        when any hop is a barrier or the chain is broken."""
        hops = []
        cur = from_digest
        by_from = {s[0]: s for s in g.segments}
        seen = 0
        while cur != to_digest:
            seg = by_from.get(cur)
            seen += 1
            if seg is None or seg[2] is None or seen > len(g.segments):
                return None
            hops.append(seg[2])
            cur = seg[1]
        if not hops:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(hops)

    def _drop_locked(self, g: _GraphLog, key, entry):
        g.entries.pop(key, None)
        if entry.path is not None:
            self._dead.append(entry.path)
        self._events["invalidated"].inc()
        self._events["miss"].inc()
        self._refresh_entries_locked()
        return None

    def _refresh_entries_locked(self):
        self._g_entries.set(sum(
            len(g.entries) for g in self._graphs.values()
        ))

    # ---- persistence -------------------------------------------------
    def _graph_dir(self, name: str) -> str:
        return os.path.join(self._root, _hash_token(name))

    def _persist(self, name, key, digest, kind, arrays, scalars):
        """Commit one entry directory: build complete under a tmp name,
        fsync, publish with ONE rename (rename-last, the sidecar
        discipline). Returns the published path (None on a memory-only
        store)."""
        if self._root is None:
            return None
        gdir = self._graph_dir(name)
        final = os.path.join(
            gdir, f"{_hash_token(key)}-{_hash_token(digest)}"
        )
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(gdir, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for arr_name, arr in arrays.items():
            np.save(os.path.join(tmp, f"{arr_name}.npy"),
                    np.ascontiguousarray(arr))
        meta = {
            "name": name, "kind": kind, "key": _key_id(key),
            "digest": str(digest), "scalars": dict(scalars),
            "arrays": sorted(arrays),
        }
        meta_path = os.path.join(tmp, "meta.json")
        with open(meta_path, "w", encoding="utf-8") as f:
            json.dump(meta, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        return final

    def _ensure_scanned(self, name: str) -> None:
        """Lazy respawn recovery: adopt any persisted entries for
        ``name`` the first time it is looked up (arrays stay on disk
        until served — the mmap move)."""
        if self._root is None:
            return
        with self._lock:
            if name in self._scanned:
                return
            self._scanned.add(name)
        gdir = self._graph_dir(name)
        found = []
        dead = []
        if os.path.isdir(gdir):
            for sub in sorted(os.listdir(gdir)):
                path = os.path.join(gdir, sub)
                if ".tmp-" in sub:
                    dead.append(path)
                    continue
                try:
                    with open(os.path.join(path, "meta.json"),
                              encoding="utf-8") as f:
                        meta = json.load(f)
                except (OSError, ValueError):
                    dead.append(path)
                    continue
                if meta.get("name") != name:
                    continue
                found.append((meta, path))
        if not found and not dead:
            return
        with self._lock:
            self._dead.extend(dead)
            g = self._graphs.setdefault(name, _GraphLog())
            for meta, path in found:
                key = meta["key"]  # repr string — matched via _key_id
                kid = _key_id(key)
                if kid in g.entries:
                    self._dead.append(path)
                    continue
                g.entries[kid] = _Entry(
                    digest=meta["digest"], kind=meta["kind"], key=kid,
                    arrays=None, scalars=dict(meta["scalars"]),
                    path=path,
                )
                self._events["load"].inc()
            self._refresh_entries_locked()

    def _load_locked(self, entry: _Entry) -> None:
        """Materialize a scanned entry's arrays as read-only mmaps.
        A torn/missing sidecar empties the entry (the caller drops
        it). np.load here is in-memory-index territory but read-only
        and rare (first touch after respawn)."""
        if entry.arrays is not None:
            return
        arrays = {}
        meta_path = os.path.join(entry.path, "meta.json")
        try:
            # read-only mmap adoption, once per entry per process
            # (first touch after respawn); off-lock it would race a
            # concurrent invalidation dropping the entry mid-load
            with open(meta_path, encoding="utf-8") as f:  # bibfs: allow(lock-io): rare read-only respawn adoption, racy off-lock
                meta = json.load(f)
            for arr_name in meta["arrays"]:
                arrays[arr_name] = np.load(
                    os.path.join(entry.path, f"{arr_name}.npy"),
                    mmap_mode="r",
                )
        except (OSError, ValueError):
            entry.arrays = None
            return
        entry.arrays = arrays

    def _sweep(self) -> None:
        """Drain deferred deletions (always outside ``self._lock``)."""
        with self._lock:
            dead, self._dead = self._dead, []
        for path in dead:
            shutil.rmtree(path, ignore_errors=True)


def _key_id(key):
    """The in-memory entry key for a cache key: the tuple itself from
    a live put, its ``repr`` from a disk scan — normalized so both
    address the same entry."""
    return key if isinstance(key, str) else repr(key)


# ---- result <-> stored payload ---------------------------------------
def result_to_payload(kind: str, res) -> tuple[dict, dict]:
    """Split a resolved analytics result into its storable halves:
    ``(arrays, scalars)`` — the vectors persist as ``.npy`` sidecars,
    the scalars ride ``meta.json``."""
    if kind == "sssp":
        return ({"dist": res.dist},
                {"found": bool(res.found), "reached": int(res.reached),
                 "rounds": int(res.rounds), "time_s": float(res.time_s)})
    if kind == "pagerank":
        return ({"ranks": res.ranks},
                {"found": bool(res.found), "iters": int(res.iters),
                 "delta": float(res.delta), "time_s": float(res.time_s)})
    if kind == "components":
        return ({"labels": res.labels},
                {"found": bool(res.found), "count": int(res.count),
                 "rounds": int(res.rounds), "time_s": float(res.time_s)})
    if kind == "triangles":
        return ({}, {"found": bool(res.found), "count": int(res.count),
                     "time_s": float(res.time_s)})
    raise ValueError(f"unknown analytics kind {kind!r}")


def result_from_payload(kind: str, arrays: dict, scalars: dict):
    """Rebuild the result object a stored entry serves (arrays may be
    read-only mmaps — the result types freeze them anyway)."""
    from bibfs_tpu_torch.analytics.queries import (
        ComponentsResult,
        PageRankResult,
        SsspResult,
        TrianglesResult,
    )

    if kind == "sssp":
        return SsspResult(
            found=bool(scalars["found"]), dist=arrays["dist"],
            reached=int(scalars["reached"]),
            rounds=int(scalars["rounds"]),
            time_s=float(scalars["time_s"]),
        )
    if kind == "pagerank":
        return PageRankResult(
            found=bool(scalars["found"]), ranks=arrays["ranks"],
            iters=int(scalars["iters"]), delta=float(scalars["delta"]),
            time_s=float(scalars["time_s"]),
        )
    if kind == "components":
        return ComponentsResult(
            found=bool(scalars["found"]), labels=arrays["labels"],
            count=int(scalars["count"]), rounds=int(scalars["rounds"]),
            time_s=float(scalars["time_s"]),
        )
    if kind == "triangles":
        return TrianglesResult(
            found=bool(scalars["found"]), count=int(scalars["count"]),
            time_s=float(scalars["time_s"]),
        )
    raise ValueError(f"unknown analytics kind {kind!r}")


# ---- incremental maintenance (adds-only) -----------------------------
def maintain_sssp(dist_old, adds, n, row_ptr, col_ind, weights, seed):
    """Decrease-only relaxation for edge INSERTIONS: stored distances
    stay valid upper bounds, any improvement routes through a new
    edge — seed a Dijkstra-style worklist at the inserted endpoints
    and propagate over the current CSR. Exact, touches only the
    affected region. Returns ``(dist float64 [n], relaxed_count)``."""
    import heapq

    from bibfs_tpu_torch.query.weighted import edge_weight_hash

    dist_old = np.asarray(dist_old, dtype=np.float64)
    d = np.full(n, np.inf, dtype=np.float64)
    d[: dist_old.size] = dist_old[:n]
    heap = []
    adds = np.asarray(adds, dtype=np.int64).reshape(-1, 2)
    if adds.shape[0]:
        w_new = edge_weight_hash(adds[:, 0], adds[:, 1], seed)
        for (u, v), w in zip(adds, w_new):
            for a, b in ((int(u), int(v)), (int(v), int(u))):
                if d[a] + w < d[b]:
                    d[b] = d[a] + w
                    heapq.heappush(heap, (d[b], b))
    relaxed = 0
    while heap:
        du, u = heapq.heappop(heap)
        if du > d[u]:
            continue
        relaxed += 1
        for i in range(row_ptr[u], row_ptr[u + 1]):
            v = int(col_ind[i])
            nd = du + weights[i]
            if nd < d[v]:
                d[v] = nd
                heapq.heappush(heap, (nd, v))
    return d, relaxed


def maintain_components(labels_old, adds, n):
    """Component re-merge for edge INSERTIONS: union the stored
    min-labels across each new edge (new vertices start as their own
    label), then remap every vertex to its class minimum — the exact
    min-label-propagation answer without touching the old edges.
    Returns ``(labels int64 [n], count)``."""
    labels_old = np.asarray(labels_old, dtype=np.int64)
    labels = np.arange(n, dtype=np.int64)
    labels[: labels_old.size] = labels_old[:n]
    parent: dict = {}

    def find(x):
        root = x
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(x, x) != root:
            parent[x], x = root, parent[x]
        return root

    for u, v in np.asarray(adds, dtype=np.int64).reshape(-1, 2):
        ru, rv = find(int(labels[u])), find(int(labels[v]))
        if ru != rv:
            if ru < rv:
                parent[rv] = ru
            else:
                parent[ru] = rv
    if parent:
        uniq = np.unique(labels)
        remap = {int(x): find(int(x)) for x in uniq}
        labels = np.fromiter(
            (remap[int(x)] for x in labels), dtype=np.int64,
            count=labels.size,
        )
    count = int(np.unique(labels).size) if n else 0
    return labels, count
