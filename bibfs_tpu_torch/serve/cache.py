"""Distance/result cache for the serving engine: the counterpart of
``bibfs_tpu/serve/cache.py``.

Two bounded LRU stores, both host-side and dispatch-free to read:

- **Source forests**, keyed ``(graph_id, root)``: the solved parent
  array of one side of a bidirectional search. Every search is
  level-synchronous, so any vertex inside the forest carries its TRUE
  BFS distance from the root — a follow-up query ``(root, x)`` (or its
  reverse ``(x, root)``: the graph is undirected) whose ``x`` lies in
  the forest is answered exactly by walking the parent chain, with zero
  solver dispatches. Distances are implicit (chain length), so an
  insert is just an O(n) row copy and a lookup is O(hops).

- **Pair memo**, keyed ``(graph_id, min(a,b), max(a,b))``: whole results
  including *negative* ones — a partial forest can never prove "no
  path" (the vertex might merely be unexplored), so unreachable pairs
  are only servable from this memo.

A forest is PARTIAL: the search stops at the provably-correct meet vote,
so only the explored region is present. Absence from the forest is a
cache miss, never an answer.

Every public method is THREAD-SAFE (one re-entrant lock around both
stores), so engines on several threads can share one cache. Eviction
accounting is complete — forest pops and pair-memo pops each feed their
own counter, and ``evictions`` is their sum — and every counter lives in
the process metrics registry
(``bibfs_dist_cache_events_total{cache,event}``,
``bibfs_dist_cache_entries{cache,store}``), so one ``/metrics`` scrape
reads the same ledger ``stats()`` snapshots.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from bibfs_tpu_torch.obs.metrics import REGISTRY, next_instance_label
from bibfs_tpu_torch.obs.trace import span

# stable documented metric names (README "Observability")
_EVENTS = ("forest_hit", "pair_hit", "miss", "insert",
           "forest_eviction", "pair_eviction", "invalidation")


def _cache_cells(label: str) -> tuple[dict, dict]:
    events = REGISTRY.counter(
        "bibfs_dist_cache_events_total",
        "Distance/result cache events by kind",
        ("cache", "event"),
    )
    entries = REGISTRY.gauge(
        "bibfs_dist_cache_entries",
        "Live distance-cache entries per store",
        ("cache", "store"),
    )
    return (
        {e: events.labels(cache=label, event=e) for e in _EVENTS},
        {s: entries.labels(cache=label, store=s)
         for s in ("forests", "pairs")},
    )


def walk_parents(par: np.ndarray, root: int, v: int) -> list[int] | None:
    """The forest path ``[root, ..., v]``, or None if ``v`` is outside
    the forest. Bounded by the array size, so a corrupt chain cannot
    loop forever."""
    if v == root:
        return [root]
    if not (0 <= v < par.size) or par[v] < 0:
        return None
    chain = [v]
    u = int(par[v])
    for _ in range(par.size):
        chain.append(u)
        if u == root:
            chain.reverse()
            return chain
        u = int(par[u])
        if u < 0:
            return None
    return None


class DistanceCache:
    """LRU source forests + pair memo (module docstring). ``entries``
    bounds the forest store (the memory owner: one int32[n] row each);
    ``pair_entries`` the memo (tiny tuples; defaults to 8x).
    ``metrics_label`` is the registry ``cache=`` label value (engines
    pass their own label so one scrape separates engines; standalone
    caches get a process-unique one)."""

    def __init__(self, entries: int = 64, pair_entries: int | None = None,
                 metrics_label: str | None = None):
        self.entries = int(entries)
        self.pair_entries = int(
            8 * entries if pair_entries is None else pair_entries
        )
        self.metrics_label = (
            next_instance_label("dist") if metrics_label is None
            else metrics_label
        )
        self._m, self._g = _cache_cells(self.metrics_label)
        self._lock = threading.RLock()
        self._forests: OrderedDict = OrderedDict()
        self._pairs: OrderedDict = OrderedDict()

    # counter attributes kept as registry-cell reads (back-compat: these
    # were plain ints before the obs migration)
    @property
    def forest_hits(self) -> int:
        return self._m["forest_hit"].value

    @property
    def pair_hits(self) -> int:
        return self._m["pair_hit"].value

    @property
    def misses(self) -> int:
        return self._m["miss"].value

    @property
    def inserts(self) -> int:
        return self._m["insert"].value

    @property
    def forest_evictions(self) -> int:
        return self._m["forest_eviction"].value

    @property
    def pair_evictions(self) -> int:
        return self._m["pair_eviction"].value

    @property
    def evictions(self) -> int:
        """Total LRU pops across BOTH stores (the complete churn count)."""
        return self.forest_evictions + self.pair_evictions

    @property
    def invalidations(self) -> int:
        return self._m["invalidation"].value

    # ---- inserts -----------------------------------------------------
    def put_forest(self, graph_id, root: int, par: np.ndarray, n: int):
        """Bank one side's parent array (sliced to the true vertex
        count; device padding rows are never part of any chain)."""
        if self.entries <= 0:
            return
        key = (graph_id, int(root))
        with span("cache_put", kind="forest"):
            row = np.asarray(par[:n], dtype=np.int32).copy()
            with self._lock:
                self._forests[key] = row
                self._forests.move_to_end(key)
                self._m["insert"].inc()
                while len(self._forests) > self.entries:
                    self._forests.popitem(last=False)
                    self._m["forest_eviction"].inc()
                self._g["forests"].set(len(self._forests))

    def put_path(self, graph_id, path, n: int):
        """Bank a solved shortest path as (partial) forests for BOTH its
        endpoints. Along a shortest path, vertex ``path[i]`` sits at true
        BFS distance ``i`` from ``path[0]`` (and ``len-1-i`` from the
        other end), so each direction of the chain is a valid
        parent-forest fragment — this is how the host dispatch path
        (which has no parent planes) still feeds the forest store.
        Merges into an existing forest when present (already-claimed
        parents stand; both chains are distance-consistent)."""
        if self.entries <= 0 or path is None or len(path) < 2:
            return
        with span("cache_put", kind="path"), self._lock:
            for chain in (path, list(reversed(path))):
                key = (graph_id, int(chain[0]))
                par = self._forests.get(key)
                if par is None:
                    par = np.full(n, -1, np.int32)
                    self._forests[key] = par
                    self._m["insert"].inc()
                for prev, v in zip(chain[:-1], chain[1:]):
                    if 0 <= v < par.size and par[v] < 0:
                        par[v] = prev
                self._forests.move_to_end(key)
            while len(self._forests) > self.entries:
                self._forests.popitem(last=False)
                self._m["forest_eviction"].inc()
            self._g["forests"].set(len(self._forests))

    def put_result(self, graph_id, src: int, dst: int,
                   found: bool, hops, path):
        """Memoize a whole materialized result, oriented canonically."""
        if self.pair_entries <= 0 or src == dst:
            return
        a, b = (src, dst) if src < dst else (dst, src)
        if found and path is not None and path[0] != a:
            path = list(reversed(path))
        with self._lock:
            self._pairs[(graph_id, a, b)] = (found, hops, path)
            self._pairs.move_to_end((graph_id, a, b))
            while len(self._pairs) > self.pair_entries:
                self._pairs.popitem(last=False)
                self._m["pair_eviction"].inc()
            self._g["pairs"].set(len(self._pairs))

    def invalidate(self, graph_id) -> int:
        """Drop every forest and pair entry namespaced under
        ``graph_id`` — the version-scoped invalidation a graph-store
        hot-swap triggers. Keys are content digests, so entries of a
        superseded version are already unreachable for new-version
        queries; this reclaims their memory (one int32[n] row per
        forest) instead of waiting for LRU churn. Returns the number of
        entries dropped (also counted under the ``invalidation``
        event)."""
        with self._lock:
            fkeys = [k for k in self._forests if k[0] == graph_id]
            pkeys = [k for k in self._pairs if k[0] == graph_id]
            for k in fkeys:
                del self._forests[k]
            for k in pkeys:
                del self._pairs[k]
            dropped = len(fkeys) + len(pkeys)
            if dropped:
                self._m["invalidation"].inc(dropped)
                self._g["forests"].set(len(self._forests))
                self._g["pairs"].set(len(self._pairs))
            return dropped

    # ---- lookup ------------------------------------------------------
    def lookup(self, graph_id, src: int, dst: int):
        """``(found, hops, path src->dst)`` or None (a miss). Tries the
        pair memo, then the src forest, then the dst forest (reverse
        twin)."""
        a, b = (src, dst) if src < dst else (dst, src)
        with span("cache_lookup"), self._lock:
            memo = self._pairs.get((graph_id, a, b))
            if memo is not None:
                self._pairs.move_to_end((graph_id, a, b))
                self._m["pair_hit"].inc()
                found, hops, path = memo
                if found and path is not None and src != path[0]:
                    path = list(reversed(path))
                return found, hops, path
            for root, leaf, reverse in ((src, dst, False), (dst, src, True)):
                par = self._forests.get((graph_id, root))
                if par is None:
                    continue
                chain = walk_parents(par, root, leaf)
                if chain is None:
                    continue
                self._forests.move_to_end((graph_id, root))
                self._m["forest_hit"].inc()
                if reverse:
                    chain.reverse()  # walk gave [dst..src]; want src->dst
                return True, len(chain) - 1, chain
            self._m["miss"].inc()
            return None

    def stats(self) -> dict:
        """Snapshot view over this cache's registry cells (the same
        numbers ``/metrics`` renders under ``cache="{metrics_label}"``)."""
        with self._lock:
            return {
                "forest_hits": self.forest_hits,
                "pair_hits": self.pair_hits,
                "hits": self.forest_hits + self.pair_hits,
                "misses": self.misses,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "forest_evictions": self.forest_evictions,
                "pair_evictions": self.pair_evictions,
                "invalidations": self.invalidations,
                "forests": len(self._forests),
                "pairs": len(self._pairs),
            }
