"""Batched live edge updates over an immutable snapshot: the counterpart
of ``bibfs_tpu/store/delta.py``.

A :class:`DeltaOverlay` keeps the base :class:`GraphSnapshot` (and every
table built from it) untouched and holds updates as two small canonical
edge sets (``adds``/``dels``):

- **queries stay exact** — while a delta is pending, queries run
  :meth:`DeltaOverlay.solve`: a host level-synchronous BFS over the base
  CSR corrected by the overlay (added neighbours appended, deleted edges
  skipped), equal to a from-scratch solve on the updated graph;
- **compaction is off the hot path** — :meth:`DeltaOverlay.snapshot`
  builds the merged edge list into a fresh snapshot (new digest) on the
  store's background thread, and the store swaps it in. An overlay handed
  to a reader is never mutated afterwards: updates that raced the
  compaction are rebased by the store into a fresh overlay.

Updates are edge-only: the vertex set (``n``) is fixed by the snapshot.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from bibfs_tpu_torch.store.snapshot import GraphSnapshot


def canonical_edge(n: int, u, v) -> tuple[int, int]:
    """Validate one undirected edge against the vertex range and return it
    as ``(min, max)``."""
    u, v = int(u), int(v)
    if not (0 <= u < n and 0 <= v < n):
        raise ValueError(f"edge endpoint out of range for n={n}: ({u}, {v})")
    if u == v:
        raise ValueError(f"self-loop ({u}, {u}) is not a valid edge")
    return (u, v) if u < v else (v, u)


class DeltaOverlay:
    """Pending edge inserts and deletes over one base snapshot (module
    docstring). Thread-safe: the store mutates it while engine flushes
    read it."""

    def __init__(self, base: GraphSnapshot):
        self.base = base
        self._lock = threading.Lock()
        self._adds: set[tuple[int, int]] = set()
        self._dels: set[tuple[int, int]] = set()
        self._base_edges: np.ndarray | None = None  # lazy membership index
        self._base_csr = None  # own handle: survives base retirement

    # ---- mutation ----------------------------------------------------
    def _base_has(self, e: tuple[int, int]) -> bool:
        """Whether the canonical edge ``e`` is in the base snapshot. The
        index is one sorted ``int64`` key a base edge (``u * n + v``,
        ``u < v``), searched by bisection: an O(E) NumPy pass to build,
        where a Python set of the edge tuples took seconds and gigabytes
        on a graph of millions of edges. The keys are ascending because
        the snapshot's pairs are canonical (sorted) by contract."""
        n = self.base.n
        if self._base_edges is None:
            u = self.base.undirected_edges()
            self._base_edges = u[:, 0].astype(np.int64) * n + u[:, 1]
        key = int(e[0]) * n + int(e[1])
        i = int(np.searchsorted(self._base_edges, key))
        return i < self._base_edges.size and int(self._base_edges[i]) == key

    def ensure_index(self) -> None:
        """Build the O(E) base-edge membership index now (the store calls
        this outside its own lock, before the first ``apply``)."""
        with self._lock:
            self._base_has((0, 0))

    def apply(self, adds=(), dels=(), *, commit: bool = True) -> dict:
        """Apply one batch of undirected edge updates, atomically: every
        edge validates or nothing changes. Adding an edge the overlaid
        graph has, or deleting one it lacks, raises ``ValueError``; an
        add cancels a pending delete of the same edge (and vice versa).
        ``commit=False`` validates and returns the would-be counts only.
        Returns the post-batch ``{"adds": ..., "dels": ...}``."""
        n = self.base.n
        with self._lock:
            stage_a, stage_d = set(self._adds), set(self._dels)
            for u, v in adds:
                e = canonical_edge(n, u, v)
                if e in stage_d:
                    stage_d.discard(e)
                elif self._base_has(e) or e in stage_a:
                    raise ValueError(f"edge {e} already present")
                else:
                    stage_a.add(e)
            for u, v in dels:
                e = canonical_edge(n, u, v)
                if e in stage_a:
                    stage_a.discard(e)
                elif not self._base_has(e) or e in stage_d:
                    raise ValueError(f"edge {e} not present")
                else:
                    stage_d.add(e)
            if commit:
                self._adds, self._dels = stage_a, stage_d
            return {"adds": len(stage_a), "dels": len(stage_d)}

    def capture(self) -> tuple[set, set]:
        """A consistent copy of the pending sets (what a compaction folds)."""
        with self._lock:
            return set(self._adds), set(self._dels)

    def rebase(self, adds: set, dels: set) -> tuple[set, set]:
        """The overlay to carry onto the snapshot built from the captured
        ``(adds, dels)``: ``(a2, d2)`` with ``new + a2 - d2`` equal to this
        overlay's live graph now. Computed edge by edge over the four sets
        (an update during the build may cancel a captured edge, so plain
        set subtraction would be wrong)."""
        with self._lock:
            a_live, d_live = set(self._adds), set(self._dels)
            a2, d2 = set(), set()
            for e in a_live | d_live | adds | dels:
                in_live = (e in a_live
                           or (self._base_has(e) and e not in d_live))
                in_new = (e in adds
                          or (self._base_has(e) and e not in dels))
                if in_live and not in_new:
                    a2.add(e)
                elif in_new and not in_live:
                    d2.add(e)
            return a2, d2

    @property
    def delta_edges(self) -> int:
        with self._lock:
            return len(self._adds) + len(self._dels)

    # ---- exact query answering ---------------------------------------
    def correction(self) -> tuple[set, dict]:
        """A consistent ``(dels, add_adj)`` correction for :meth:`solve`;
        capture it once per flush and pass it to every solve (the batch
        then answers one delta state)."""
        with self._lock:
            dels = set(self._dels)
            add_adj: dict[int, list[int]] = {}
            for u, v in self._adds:
                add_adj.setdefault(u, []).append(v)
                add_adj.setdefault(v, []).append(u)
        return dels, add_adj

    def solve(self, src: int, dst: int, correction=None):
        """Exact shortest path on base + delta: level-synchronous BFS over
        the base CSR with the overlay's correction. Returns a
        :class:`~bibfs_tpu_torch.solvers.api.BFSResult`; never touches the
        device."""
        from bibfs_tpu_torch.solvers.api import BFSResult

        src, dst = int(src), int(dst)
        n = self.base.n
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"src/dst out of range for n={n}")
        t0 = time.perf_counter()
        if src == dst:
            return BFSResult(True, 0, [src], src, 0.0, 0, 0)
        if self._base_csr is None:
            # own handle: a retired base builds its CSR uncached
            self._base_csr = self.base.csr()
        row_ptr, col_ind = self._base_csr
        dels, add_adj = (
            self.correction() if correction is None else correction
        )
        parent = np.full(n, -1, dtype=np.int64)
        parent[src] = src
        frontier = [src]
        levels = 0
        edges_scanned = 0
        found = False
        while frontier and not found:
            levels += 1
            nxt = []
            for u in frontier:
                base_nbrs = col_ind[row_ptr[u]: row_ptr[u + 1]]
                extra = add_adj.get(u)
                for v in (
                    base_nbrs if extra is None
                    else list(base_nbrs) + extra
                ):
                    v = int(v)
                    edges_scanned += 1
                    if dels and ((u, v) if u < v else (v, u)) in dels:
                        continue
                    if parent[v] >= 0:
                        continue
                    parent[v] = u
                    if v == dst:
                        found = True
                        break
                    nxt.append(v)
                if found:
                    break
            frontier = nxt
        if not found:
            return BFSResult(
                False, None, None, None,
                time.perf_counter() - t0, levels, edges_scanned,
            )
        path = [dst]
        while path[-1] != src:
            path.append(int(parent[path[-1]]))
        path.reverse()
        return BFSResult(
            True, len(path) - 1, path, None,
            time.perf_counter() - t0, levels, edges_scanned,
        )

    # ---- compaction --------------------------------------------------
    def merged_edges(self, adds: set | None = None,
                     dels: set | None = None) -> np.ndarray:
        """The undirected base + delta edge list (``u < v`` rows) for the
        given captured sets (default: the live pending sets)."""
        if adds is None or dels is None:
            adds, dels = self.capture()
        base = self.base.undirected_edges()
        if dels:
            # vectorized membership on u * n + v keys
            n = np.int64(self.base.n)
            keys = base[:, 0] * n + base[:, 1]
            darr = np.array(sorted(dels), dtype=np.int64)
            base = base[~np.isin(keys, darr[:, 0] * n + darr[:, 1])]
        if adds:
            base = np.concatenate(
                [base, np.array(sorted(adds), dtype=np.int64)], axis=0
            )
        return base

    def merged_pairs(self, adds: set, dels: set) -> np.ndarray:
        """The canonical pairs of base + delta, equal to
        ``canonical_pairs(n, merged_edges(adds, dels))``: the delta's keys
        (``u * n + v``, both orientations) are deleted from and inserted
        into the base's sorted keys by bisection, one pass over the base
        instead of a sort of every edge. The base's pairs are canonical
        by the snapshot's contract, so its keys are already ascending."""
        n = self.base.n
        pairs = self.base.pairs
        keys = pairs[:, 0] * np.int64(n) + pairs[:, 1]

        def both(edges) -> np.ndarray:
            if not edges:
                return np.zeros(0, dtype=np.int64)
            e = np.array(sorted(edges), dtype=np.int64)
            return np.unique(np.concatenate(
                [e[:, 0] * n + e[:, 1], e[:, 1] * n + e[:, 0]]))

        dk = both(dels)
        if dk.size and keys.size:
            pos = np.searchsorted(keys, dk)
            inside = pos < keys.size
            pos = pos[inside]
            keys = np.delete(keys, pos[keys[pos] == dk[inside]])
        ak = both(adds)
        if ak.size:
            pos = np.searchsorted(keys, ak)
            if keys.size:
                fresh = (pos >= keys.size) | (
                    keys[np.minimum(pos, keys.size - 1)] != ak)
            else:
                fresh = np.ones(ak.size, dtype=bool)
            keys = np.insert(keys, pos[fresh], ak[fresh])
        out = np.empty((keys.size, 2), dtype=np.int64)
        out[:, 0] = keys // n
        out[:, 1] = keys % n
        return out

    def snapshot(self, adds: set | None = None,
                 dels: set | None = None) -> tuple[GraphSnapshot, set, set]:
        """Build base + delta into a fresh snapshot (the compaction; run it
        off the serving path). Returns ``(snapshot, adds, dels)``, the sets
        folded in (default: a fresh :meth:`capture`)."""
        if adds is None or dels is None:
            adds, dels = self.capture()
        snap = GraphSnapshot.build(
            self.base.n, pairs=self.merged_pairs(adds, dels)
        )
        return snap, adds, dels

    def stats(self) -> dict:
        with self._lock:
            return {"adds": len(self._adds), "dels": len(self._dels)}
