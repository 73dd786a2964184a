"""Named multi-graph store with atomic hot-swap: the counterpart of
``bibfs_tpu/store/registry.py`` (its in-memory store).

A :class:`GraphStore` maps names to their current
:class:`~bibfs_tpu_torch.store.snapshot.GraphSnapshot`, plus a pending
:class:`~bibfs_tpu_torch.store.delta.DeltaOverlay` when edge updates have
arrived since the last compaction. The engines resolve a name to a
snapshot at flush time and pin it for the flush, so a swap is:

1. build the replacement snapshot (a compaction on a background thread,
   or a snapshot built elsewhere and handed to :meth:`GraphStore.swap`);
2. under the store lock, point the name at it (a pointer flip);
3. in-flight flushes finish on the old snapshot through their pins; it
   retires when the last pin drops.

Updates below ``compact_threshold`` serve exactly through the overlay;
crossing it starts a background compaction that folds the overlay into a
fresh snapshot and swaps it in, rebasing updates that raced the build
into a fresh overlay (the old overlay is never mutated, so a flush that
holds it keeps answering the same edge set).

**Distance oracle** (``oracle_k=K``): each graph carries a landmark
:class:`~bibfs_tpu_torch.oracle.DistanceOracle` built in the background.
Every change of a graph's live edge state (an update batch, a swap, a
compaction) bumps ``graph_gen``; every index carries the gen it was built
for, and :meth:`GraphStore.oracle` returns only an index of the current
gen. Adds-only batches repair the index synchronously (exact; past
``oracle_repair_max`` adds a full rebuild is scheduled instead); a delete
invalidates it until the next compaction. The index builds sweep on the
store's ``device`` (default ``cuda``: the hand-written multi-source BFS
kernel). A build that fails is counted (``stats()``) and raised by
:meth:`GraphStore.wait_for_index`; it is never replaced by a host sweep.

Durability (the WAL, manifests, checkpoints, arrays sidecars, memory
tiers, history) comes with the durability slice of the port (ROADMAP
Queue 1, item 6b): its options raise ``NotImplementedError``. The
analytics result store comes with item 9.

Observability: the JAX package's ``bibfs_store_*`` and
``bibfs_oracle_*`` families (the memory-tier trio at zero), and the
``store_swap`` / ``store_compact`` / ``store_index_build`` spans.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
import weakref

from bibfs_tpu_torch.obs.metrics import REGISTRY, next_instance_label
from bibfs_tpu_torch.obs.trace import span
from bibfs_tpu_torch.store.delta import DeltaOverlay, canonical_edge
from bibfs_tpu_torch.store.snapshot import GraphSnapshot
from bibfs_tpu_torch.utils.annotations import guarded_by

#: where the durable options are ported
DURABILITY_SLICE = "the durability slice (ROADMAP Queue 1, item 6b)"

#: checkpoint snapshots of a durable store (``<name>.v<V>.<digest>.bin``):
#: never seed graphs of :meth:`GraphStore.from_dir`
_CKPT_BIN_RE = re.compile(r"\.v(\d+)\.[0-9a-f]{6,32}\.bin$")


def _durable_refused(option: str):
    return NotImplementedError(
        f"GraphStore({option}) is not ported yet: it comes with "
        f"{DURABILITY_SLICE}"
    )


class _Entry:
    """One named graph's mutable slot: the current snapshot, the pending
    overlay, the compaction serializer, and the oracle state (the current
    oracle, the live-graph generation, the in-flight builder, counts)."""

    __slots__ = ("snapshot", "overlay", "compactor", "compact_lock",
                 "swaps", "compactions", "compact_failures",
                 "graph_gen", "oracle", "oracle_builder", "oracle_cells",
                 "index_builds", "index_aborts", "index_repairs",
                 "index_failures", "index_error")

    def __init__(self, snapshot: GraphSnapshot):
        self.snapshot = snapshot
        self.overlay: DeltaOverlay | None = None
        self.compactor: threading.Thread | None = None
        self.compact_lock = threading.Lock()
        self.swaps = 0
        self.compactions = 0
        self.compact_failures = 0
        # bumped on every update batch, swap and compaction commit
        self.graph_gen = 1
        self.oracle = None  # DistanceOracle | None
        self.oracle_builder: threading.Thread | None = None
        self.oracle_cells: dict | None = None
        self.index_builds = 0
        self.index_aborts = 0
        self.index_repairs = 0
        self.index_failures = 0
        self.index_error: tuple[int, str] | None = None  # (gen, message)


@guarded_by("_lock", "_entries", "_default")
class GraphStore:
    """Named, versioned, hot-swappable graphs (module docstring).

    Parameters
    ----------
    compact_threshold : pending delta edges at which a background
        compaction (rebuild + swap) starts; None: explicit
        :meth:`compact` / :meth:`swap` only.
    oracle_k : landmarks per graph for the distance oracle (module
        docstring); None (default) disables it.
    oracle_repair_max : adds folded into one index by repair before a
        full rebuild is scheduled instead.
    oracle_seed : landmark-selection seed (selection is deterministic).
    obs_label : the ``store=`` label of this store's cells (default: a
        process-unique ``store-N``).
    device : where the index builds sweep (default ``cuda``: the CUDA
        multi-source BFS kernel; ``"cpu"`` runs its plain torch twin).
        Resolved when ``oracle_k`` is set, so a CUDA store without a card
        raises here.
    wal_dir, fsync, fsync_batch_records, faults, retain_history,
    mmap_arrays, residency_budget : the JAX package's durability and
        memory-tier options; any value but the default raises
        ``NotImplementedError`` (:data:`DURABILITY_SLICE`).
    """

    def __init__(self, *, compact_threshold: int | None = 256,
                 oracle_k: int | None = None,
                 oracle_repair_max: int = 64,
                 oracle_seed: int = 0,
                 obs_label: str | None = None,
                 device=None,
                 wal_dir=None, fsync=None, fsync_batch_records=None,
                 faults=None, retain_history: bool = False,
                 mmap_arrays=None, residency_budget=None):
        durable = {"wal_dir": wal_dir, "fsync": fsync,
                   "fsync_batch_records": fsync_batch_records,
                   "faults": faults, "retain_history": retain_history or None,
                   "mmap_arrays": mmap_arrays,
                   "residency_budget": residency_budget}
        for opt, val in durable.items():
            if val is not None:
                raise _durable_refused(f"{opt}=...")
        self.compact_threshold = (
            None if compact_threshold is None else int(compact_threshold)
        )
        if self.compact_threshold is not None and self.compact_threshold < 1:
            raise ValueError(
                f"compact_threshold must be >= 1, got {compact_threshold}"
            )
        self.oracle_k = None if oracle_k is None else int(oracle_k)
        if self.oracle_k is not None and self.oracle_k < 1:
            raise ValueError(f"oracle_k must be >= 1, got {oracle_k}")
        self.device = None
        if self.oracle_k is not None:
            from bibfs_tpu_torch.utils.platform import resolve_device

            self.device = resolve_device(device)
        self.oracle_repair_max = int(oracle_repair_max)
        self.oracle_seed = int(oracle_seed)
        self.obs_label = (
            next_instance_label("store") if obs_label is None else obs_label
        )
        self._lock = threading.RLock()
        self._entries: dict[str, _Entry] = {}
        self._default: str | None = None
        self.load_errors: list[dict] = []
        self._g_graphs = REGISTRY.gauge(
            "bibfs_store_graphs", "Graphs registered in a graph store",
            ("store",),
        ).labels(store=self.obs_label)
        self._c_swaps = REGISTRY.counter(
            "bibfs_store_swaps_total",
            "Atomic snapshot hot-swaps per graph",
            ("store", "graph"),
        )
        self._g_delta = REGISTRY.gauge(
            "bibfs_store_delta_edges",
            "Pending overlay edge updates per graph",
            ("store", "graph"),
        )
        self._c_compactions = REGISTRY.counter(
            "bibfs_store_compactions_total",
            "Delta compactions (overlay folded into a fresh snapshot)",
            ("store", "graph"),
        )
        self._c_compact_failures = REGISTRY.counter(
            "bibfs_store_compact_failures_total",
            "Background compactions that raised (overlay keeps serving; "
            "the next update re-triggers)",
            ("store", "graph"),
        )
        # the memory-tier families render at zero (every snapshot is hot)
        self._g_mmap_bytes = REGISTRY.gauge(
            "bibfs_store_mmap_bytes",
            "Sidecar bytes the graph's current snapshot keeps mapped "
            "(shared page-cache-backed, not process-private)",
            ("store", "graph"),
        )
        self._g_tier = REGISTRY.gauge(
            "bibfs_store_tier",
            "Graphs currently in each memory tier (mapped/hot/cold)",
            ("store", "tier"),
        )
        for t in ("mapped", "hot", "cold"):
            self._g_tier.labels(store=self.obs_label, tier=t).set(0)
        self._c_remaps = REGISTRY.counter(
            "bibfs_store_remap_total",
            "Recoveries served by mapping an arrays sidecar instead of "
            "rebuilding from the checkpoint .bin",
            ("store", "graph"),
        )
        self._c_index_builds = REGISTRY.counter(
            "bibfs_oracle_index_builds_total",
            "Full landmark-index builds committed per graph "
            "(incremental repairs not included)",
            ("store", "graph"),
        )
        self._g_index_age = REGISTRY.gauge(
            "bibfs_oracle_index_age_seconds",
            "Age of the graph's CURRENT landmark index (0 when the "
            "graph has none); refreshed at scrape time",
            ("store", "graph"),
        )
        if self.oracle_k is not None:
            # scrape-time age refresh, weakly bound: a dead store
            # unregisters itself
            self_ref = weakref.ref(self)

            def _collect_index_age():
                st = self_ref()
                if st is None:
                    return False
                now = time.time()
                with st._lock:
                    for nm, e in st._entries.items():
                        st._g_index_age.labels(
                            store=st.obs_label, graph=nm
                        ).set(
                            0.0 if e.oracle is None
                            else max(now - e.oracle.index.built_at, 0.0)
                        )
                return True

            REGISTRY.add_collector(_collect_index_age)

    @property
    def analytics(self):
        """The whole-graph analytics result store: not ported yet."""
        raise NotImplementedError(
            "GraphStore.analytics is not ported yet (ROADMAP Queue 1, item 9)"
        )

    # ---- registration -----------------------------------------------
    def add(self, name: str, n: int | None = None, edges=None, *,
            pairs=None, snapshot: GraphSnapshot | None = None
            ) -> GraphSnapshot:
        """Register a graph under ``name`` (its version-1 snapshot). The
        first added graph becomes the default."""
        name = str(name)
        if snapshot is None:
            if n is None:
                raise ValueError("add() needs n+edges/pairs or snapshot=")
            snapshot = GraphSnapshot.build(n, edges, pairs=pairs)
        entry = self._register(name, snapshot)
        self._kick_oracle(name, entry)
        return snapshot

    def _register(self, name: str, snapshot: GraphSnapshot) -> _Entry:
        with self._lock:
            if name in self._entries:
                raise ValueError(
                    f"graph {name!r} already registered (swap() replaces)"
                )
            # versions are store-relative: every graph starts at v1
            snapshot.version = 1
            entry = _Entry(snapshot)
            self._entries[name] = entry
            if self._default is None:
                self._default = name
            self._g_graphs.set(len(self._entries))
            self._g_tier.labels(store=self.obs_label, tier="hot").set(
                len(self._entries)
            )
            # mint the per-graph cells now: a scrape shows them at zero
            self._c_swaps.labels(store=self.obs_label, graph=name)
            self._g_delta.labels(store=self.obs_label, graph=name).set(0)
            self._c_compactions.labels(store=self.obs_label, graph=name)
            self._c_compact_failures.labels(store=self.obs_label, graph=name)
            self._g_mmap_bytes.labels(store=self.obs_label, graph=name).set(
                snapshot.mapped_bytes()
            )
            self._c_remaps.labels(store=self.obs_label, graph=name)
            if self.oracle_k is not None:
                from bibfs_tpu_torch.oracle import oracle_cells

                entry.oracle_cells = oracle_cells(self._oracle_label(name))
                self._c_index_builds.labels(store=self.obs_label, graph=name)
                self._g_index_age.labels(
                    store=self.obs_label, graph=name
                ).set(0.0)
        return entry

    @classmethod
    def from_dir(cls, path, *, durable: bool = False,
                 **kwargs) -> "GraphStore":
        """A store over every ``*.bin`` graph in a directory, each under its
        file stem (``social.bin`` -> ``social``), sorted so the default
        graph is deterministic. A graph that does not load is skipped with
        a counted warning (``store.load_errors``); only a directory with no
        loadable graph raises. ``durable=True`` raises
        ``NotImplementedError`` (:data:`DURABILITY_SLICE`)."""
        from bibfs_tpu_torch.graph.io import read_graph_bin

        if durable:
            raise _durable_refused("from_dir(durable=True)")
        path = os.fspath(path)
        store = cls(**kwargs)
        names = set()
        for fname in os.listdir(path):
            if fname.endswith(".bin") and not _CKPT_BIN_RE.search(fname):
                names.add(fname[: -len(".bin")])
            elif fname.endswith(".manifest.json"):
                names.add(fname[: -len(".manifest.json")])
        if not names:
            raise ValueError(f"no *.bin graphs in {path!r}")
        for name in sorted(names):
            try:
                n, edges = read_graph_bin(os.path.join(path, f"{name}.bin"))
                store.add(name, n, edges)
            except (OSError, ValueError) as e:
                store.load_errors.append({
                    "graph": name,
                    "error": f"{type(e).__name__}: {e}"[:300],
                })
                print(f"[Store] skipping graph {name!r}: {e}", file=sys.stderr)
        if not store.names():
            raise ValueError(
                f"no readable graph in {path!r} "
                f"({len(store.load_errors)} skipped)"
            )
        return store

    # ---- resolution --------------------------------------------------
    def _entry(self, name: str) -> _Entry:
        entry = self._entries.get(str(name))
        if entry is None:
            raise KeyError(
                f"unknown graph {name!r} (have: {sorted(self._entries)})"
            )
        return entry

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def default_graph(self) -> str:
        with self._lock:
            if self._default is None:
                raise ValueError("store has no graphs")
            return self._default

    def current(self, name: str) -> GraphSnapshot:
        """The graph's current snapshot (an identity read; pin it with
        :meth:`acquire` before using it across a swap)."""
        with self._lock:
            return self._entry(name).snapshot

    def acquire(self, name: str) -> GraphSnapshot:
        """The current snapshot, retained under the store lock so a
        concurrent swap cannot retire it between the read and the pin.
        The caller owes one ``release()``."""
        with self._lock:
            return self._entry(name).snapshot.retain()

    def touch(self, name: str) -> None:
        """The engines' access-recency seam: a no-op until the durability
        slice brings the memory tiers whose demotion order reads it."""

    def overlay(self, name: str) -> DeltaOverlay | None:
        """The graph's pending overlay, or None when it has no pending
        updates (the engines' exact-answering route check)."""
        with self._lock:
            ov = self._entry(name).overlay
        if ov is not None and ov.delta_edges == 0:
            return None
        return ov

    # ---- live updates ------------------------------------------------
    def update(self, name: str, adds=(), dels=()) -> dict:
        """Apply one batch of undirected edge updates to ``name``'s overlay
        (created on the first update). Crossing ``compact_threshold``
        starts a background compaction. Returns ``{"adds": ..., "dels":
        ..., "compacting": bool}``."""
        name = str(name)
        adds = [tuple(e) for e in adds]  # consumed twice when the
        dels = [tuple(e) for e in dels]  # oracle repairs (below)
        while True:
            with self._lock:
                entry = self._entry(name)
                if entry.overlay is None:
                    entry.overlay = DeltaOverlay(entry.snapshot)
                overlay = entry.overlay
            # the first apply needs the O(E) membership index: build it off
            # the store lock
            overlay.ensure_index()
            with self._lock:
                if self._entry(name).overlay is not overlay:
                    continue  # a swap replaced the overlay meanwhile
                counts = overlay.apply(adds, dels)
                # the live graph changed: the gen moves in the same locked
                # section, so no reader pairs the new edges with the old
                # index
                entry.graph_gen += 1
                gen_after = entry.graph_gen
                prev_oracle = entry.oracle
                delta = counts["adds"] + counts["dels"]
                self._g_delta.labels(store=self.obs_label, graph=name).set(
                    delta
                )
                compacting = entry.compactor is not None
                if (not compacting and self.compact_threshold is not None
                        and delta >= self.compact_threshold):
                    entry.compactor = threading.Thread(
                        target=self._compact_job, args=(name, entry),
                        name=f"bibfs-compact-{name}", daemon=True,
                    )
                    entry.compactor.start()
                    compacting = True
            self._oracle_after_update(
                name, entry, overlay, adds, dels, gen_after, prev_oracle
            )
            return {**counts, "compacting": compacting}

    # ---- oracle lifecycle --------------------------------------------
    def _oracle_label(self, name: str) -> str:
        return f"{self.obs_label}/{name}"

    def oracle(self, name: str):
        """The graph's :class:`~bibfs_tpu_torch.oracle.DistanceOracle`, or
        None when disabled or not built for the current live edge state
        (a gen mismatch: the index describes a superseded graph)."""
        if self.oracle_k is None:
            return None
        with self._lock:
            entry = self._entry(name)
            orc = entry.oracle
            if orc is None or orc.index.gen != entry.graph_gen:
                return None
            return orc

    def wait_for_index(self, name: str, timeout: float = 60.0) -> bool:
        """Block until ``name`` has a current index (True) or ``timeout``
        passes (False); raises ``RuntimeError`` when the build for the
        current gen failed. Serving never waits: queries go to the solvers
        until the index commits. Re-kicks the builder at most once per gen
        when none is in flight (e.g. after an aborted build)."""
        name = str(name)
        deadline = time.monotonic() + timeout
        kicked_gen = None
        while True:
            if self.oracle(name) is not None:
                return True
            with self._lock:
                entry = self._entry(name)
                builder = entry.oracle_builder
                gen = entry.graph_gen
                err = entry.index_error
            if builder is None and err is not None and err[0] == gen:
                raise RuntimeError(
                    f"landmark index build of {name!r} failed: {err[1]}"
                )
            if time.monotonic() >= deadline:
                return False
            if builder is None and gen != kicked_gen:
                self._kick_oracle(name, entry)
                kicked_gen = gen
            time.sleep(0.02)

    def _oracle_after_update(self, name, entry, overlay, adds, dels,
                             gen_after, prev_oracle) -> None:
        """Index upkeep after a batch, off the store lock: an adds-only
        batch against a current index repairs into a fresh index and
        commits it if nothing raced; anything else schedules a rebuild."""
        if self.oracle_k is None:
            return
        prev_ok = (
            prev_oracle is not None
            and prev_oracle.index.gen == gen_after - 1
        )
        if (dels or not prev_ok
                or prev_oracle.index.repaired_edges + len(adds)
                > self.oracle_repair_max):
            self._kick_oracle(name, entry)
            return
        from bibfs_tpu_torch.oracle import DistanceOracle

        n = entry.snapshot.n
        canon = [canonical_edge(n, u, v) for u, v in adds]
        del_set, add_adj = overlay.correction()
        if del_set:
            # a valid index implies a dels-free overlay; never repair
            # across a delete
            self._kick_oracle(name, entry)
            return
        row_ptr, col_ind = entry.snapshot.csr()
        with span("store_index_build", graph=name, kind="repair",
                  adds=len(canon)):
            index = prev_oracle.index.repair_adds(
                row_ptr, col_ind, add_adj, canon, gen=gen_after
            )
        with self._lock:
            if (entry.graph_gen == gen_after
                    and entry.oracle is prev_oracle):
                entry.oracle = DistanceOracle(
                    index, metrics_label=self._oracle_label(name),
                    cells=entry.oracle_cells,
                )
                entry.index_repairs += 1

    def _kick_oracle(self, name, entry) -> None:
        """Start a background index build for ``name``'s live graph unless
        one is in flight (or the oracle is off)."""
        if self.oracle_k is None:
            return
        with self._lock:
            if (entry.oracle_builder is not None
                    and entry.oracle_builder.is_alive()):
                return
            entry.oracle_builder = threading.Thread(
                target=self._oracle_job, args=(name, entry),
                name=f"bibfs-oracle-{name}", daemon=True,
            )
            entry.oracle_builder.start()

    def _oracle_job(self, name, entry) -> None:
        """The background builder: capture (snapshot, overlay, gen) off the
        store lock, sweep, and commit under it only if the gen still
        matches; a mutation during the build aborts the commit and the
        build retries a bounded number of times."""
        from bibfs_tpu_torch.oracle import DistanceOracle, build_index

        gen = None
        try:
            for _attempt in range(3):
                with self._lock:
                    snap = entry.snapshot
                    overlay = entry.overlay
                    gen = entry.graph_gen
                if overlay is not None and overlay.stats()["dels"] > 0:
                    # no exact repair across a delete, and the overlaid
                    # graph is no snapshot: the next compaction re-kicks
                    return
                if overlay is not None and overlay.delta_edges > 0:
                    from bibfs_tpu_torch.graph.csr import build_csr

                    row_ptr, col_ind = build_csr(
                        snap.n, overlay.merged_edges()
                    )
                else:
                    row_ptr, col_ind = snap.csr()
                with span("store_index_build", graph=name,
                          k=self.oracle_k, gen=gen):
                    index = build_index(
                        snap.n, row_ptr, col_ind, self.oracle_k,
                        seed=self.oracle_seed, digest=snap.digest,
                        version=snap.version, gen=gen, device=self.device,
                    )
                with self._lock:
                    if entry.graph_gen == gen:
                        entry.oracle = DistanceOracle(
                            index,
                            metrics_label=self._oracle_label(name),
                            cells=entry.oracle_cells,
                        )
                        entry.index_builds += 1
                        entry.index_error = None
                        self._c_index_builds.labels(
                            store=self.obs_label, graph=name
                        ).inc()
                        return
                    entry.index_aborts += 1
        except Exception as e:
            # counted and kept for wait_for_index: the queries stay on the
            # solver routes, and no host sweep stands in for the device
            with self._lock:
                entry.index_failures += 1
                entry.index_error = (gen, f"{type(e).__name__}: {e}"[:300])
        finally:
            with self._lock:
                entry.oracle_builder = None

    # ---- compaction + hot-swap ---------------------------------------
    def _compact_job(self, name: str, entry: _Entry) -> None:
        try:
            self._compact_inline(name)
        except Exception:
            # the overlay keeps serving exactly and the next update
            # re-triggers; counted so it shows
            with self._lock:
                entry.compact_failures += 1
            self._c_compact_failures.labels(
                store=self.obs_label, graph=name
            ).inc()
        finally:
            with self._lock:
                entry.compactor = None

    def _compact_inline(self, name: str) -> GraphSnapshot:
        """Build base + delta into a fresh snapshot off the store lock,
        swap it in, and rebase updates that raced the build into a fresh
        overlay. A swap that lands during the build wins: the compaction
        aborts."""
        with self._lock:
            entry = self._entry(name)
        with entry.compact_lock:
            with self._lock:
                overlay = entry.overlay
                if overlay is None or overlay.delta_edges == 0:
                    return entry.snapshot  # nothing pending
                adds, dels = overlay.capture()
            with span("store_compact", graph=name,
                      delta=len(adds) + len(dels)):
                new, adds, dels = overlay.snapshot(adds, dels)
                # pre-build the carried overlay's index off the lock too
                rebased = DeltaOverlay(new)
                rebased.ensure_index()
                with self._lock:
                    if self._entry(name).overlay is not overlay:
                        # an external swap() discarded this overlay: its
                        # snapshot is the caller's declared truth
                        return entry.snapshot
                    new.version = entry.snapshot.version + 1
                    self._swap_locked(name, entry, new)
                    a2, d2 = overlay.rebase(adds, dels)
                    if a2 or d2:
                        rebased.apply(sorted(a2), sorted(d2))
                        entry.overlay = rebased
                    else:
                        entry.overlay = None
                    self._g_delta.labels(
                        store=self.obs_label, graph=name
                    ).set(len(a2) + len(d2))
                    entry.compactions += 1
                    self._c_compactions.labels(
                        store=self.obs_label, graph=name
                    ).inc()
            # the swap dropped the old index: rebuild for the new snapshot
            self._kick_oracle(name, entry)
            return new

    def compact(self, name: str) -> GraphSnapshot:
        """Fold whatever is pending into a fresh snapshot and swap it in
        now (the CLI's ``swap``), serialized against a background
        compaction."""
        return self._compact_inline(str(name))

    def roll(self, name: str, adds=(), dels=()) -> GraphSnapshot:
        """Apply one update batch and fold it synchronously into a fresh,
        hot-swapped snapshot (a no-op returning the current snapshot when
        nothing is given or pending)."""
        name = str(name)
        if adds or dels:
            self.update(name, adds=adds, dels=dels)
        return self.compact(name)

    def swap(self, name: str, snapshot: GraphSnapshot) -> GraphSnapshot:
        """Point ``name`` at a snapshot built elsewhere (its version must
        be above the current one). Returns the old snapshot, already
        released by the store (it retires once in-flight pins drop). A
        pending overlay is discarded: the new snapshot is the caller's
        declared truth."""
        name = str(name)
        with self._lock:
            entry = self._entry(name)
            old = self._swap_locked(name, entry, snapshot)
            entry.overlay = None
            self._g_delta.labels(store=self.obs_label, graph=name).set(0)
        self._kick_oracle(name, entry)
        return old

    def _swap_locked(self, name: str, entry: _Entry,
                     new: GraphSnapshot) -> GraphSnapshot:
        old = entry.snapshot
        if new.version <= old.version:
            raise ValueError(
                f"swap must move {name!r} forward: new version "
                f"{new.version} <= current {old.version}"
            )
        with span("store_swap", graph=name, version=new.version,
                  old_version=old.version):
            entry.snapshot = new
            entry.swaps += 1
            # gen and snapshot move in one locked mutation and the old
            # index goes: a reader sees (old snapshot, old index) or (new
            # snapshot, no index), never a cross pairing
            entry.graph_gen += 1
            entry.oracle = None
            self._c_swaps.labels(store=self.obs_label, graph=name).inc()
            old.release()  # the store's reference; flush pins remain
        return old

    # ---- durability (not ported) ------------------------------------
    def history(self, name: str) -> list[dict]:
        """A graph's committed version history: not ported yet."""
        raise _durable_refused("history")

    def reconstruct_version(self, name: str, version: int) -> GraphSnapshot:
        """A graph as of a committed version: not ported yet."""
        raise _durable_refused("reconstruct_version")

    # ---- introspection ----------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            graphs = {}
            for name, entry in self._entries.items():
                graphs[name] = {
                    **entry.snapshot.stats(),
                    "delta_edges": (
                        0 if entry.overlay is None
                        else entry.overlay.delta_edges
                    ),
                    "swaps": entry.swaps,
                    "compactions": entry.compactions,
                    "compact_failures": entry.compact_failures,
                    "compacting": entry.compactor is not None,
                    "oracle": self._oracle_stats_locked(entry),
                }
            return {
                "graphs": graphs,
                "default": self._default,
                "compact_threshold": self.compact_threshold,
                "oracle_k": self.oracle_k,
                "durable": False,
                "retain_history": False,
                "fsync": None,
                "load_errors": list(self.load_errors),
                "device": None if self.device is None else str(self.device),
            }

    def _oracle_stats_locked(self, entry: _Entry) -> dict | None:
        if self.oracle_k is None:
            return None
        orc = entry.oracle
        current = orc is not None and orc.index.gen == entry.graph_gen
        out = {
            "k": self.oracle_k,
            "ready": current,
            "gen": entry.graph_gen,
            "builds": entry.index_builds,
            "repairs": entry.index_repairs,
            "aborts": entry.index_aborts,
            "failures": entry.index_failures,
            "building": entry.oracle_builder is not None,
            "last_error": (
                None if entry.index_error is None else entry.index_error[1]
            ),
        }
        if orc is not None:
            out["index"] = orc.index.stats()
            out["hits"] = {k: c.value for k, c in orc.cells.items()}
        elif entry.oracle_cells is not None:
            out["hits"] = {
                k: c.value for k, c in entry.oracle_cells.items()
            }
        return out

    def close(self) -> None:
        """Join in-flight background compactions and index builds (and the
        builds a finishing compaction starts)."""
        while True:
            with self._lock:
                jobs = [
                    e.compactor for e in self._entries.values()
                    if e.compactor is not None
                ] + [
                    e.oracle_builder for e in self._entries.values()
                    if e.oracle_builder is not None
                ]
            if not jobs:
                return
            for job in jobs:
                job.join()
