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

**Durability** (``wal_dir=DIR``): every acked update batch is appended
to a per-graph write-ahead log (:mod:`bibfs_tpu_torch.store.wal`) before
it commits to the overlay (validate, log, commit, in one locked section),
and the ack goes out only once the record is durable under the ``fsync``
policy. A compaction is a checkpoint: the folded snapshot lands as an
atomic ``<name>.v<V>.<digest12>.bin``, its arrays sidecar beside it
(``store/sidecar.py``), ``<name>.manifest.json`` commits by atomic
rename, and the WAL switches to a fresh segment in the same locked
section as the capture. Recovery (:meth:`GraphStore.from_dir` with
``durable=True``) maps the manifest's sidecar (``GraphSnapshot.
from_sidecar``, the digest recomputed from the mapped bytes), or
rebuilds from its ``.bin`` when the sidecar is missing, fails its checks
(with a printed warning) or ``mmap_arrays`` is off, replays the
surviving segments in order (a torn tail truncated), and re-arms the
overlay; ``bibfs_store_remap_total`` counts the mapped recoveries. The fault sites
``wal_write`` / ``wal_fsync`` / ``manifest_rename`` / ``sidecar_rename``
(``serve/faults.py``) inject the disk failures this must survive.
``retain_history=True`` keeps every committed version readable
(:meth:`GraphStore.history`, :meth:`GraphStore.reconstruct_version`,
``store/history.py``).

Where the port's sidecars go further than the reference's: the store
builds, off the serving path, the serving layouts named in
``sidecar_layouts`` (``"ell"``, the device route's table; ``"blocked"``,
the tile tables) before it writes a sidecar, and on an oracle store a
compaction builds the new snapshot's landmark index (on the store's
device) before its checkpoint; so the sidecar carries the ``ell.*``,
``blocked.*`` and ``oracle.*`` groups, and a recovery that maps it
uploads the ELL from the mapping and adopts the index (repairing the
replayed adds into it) instead of sweeping again. The reference writes
those groups only when the snapshot already built them, and rebuilds the
index at recovery.

**Memory tiers**: a **residency budget** (``residency_budget=`` bytes)
arms the accountant: while the process-private resident total exceeds
it, the least recently used hot graph is demoted to the compressed cold
tier (``graph/compress.py``); any access promotes it back, exactly.
Engines stamp recency through :meth:`GraphStore.touch`.
:meth:`GraphStore.memory_stats` reports each graph's tier, resident and
mapped bytes and the headroom (the CLI's stdin ``memory``). A demote
frees host memos only; the tables an engine uploaded to the card stay.
The analytics result store comes with item 9.

Observability: the JAX package's ``bibfs_store_*``, ``bibfs_oracle_*``
and, on a durable store, ``bibfs_wal_*`` / ``bibfs_checkpoints_total`` /
``bibfs_recovery_*`` families; its ``store_swap`` / ``store_compact`` /
``store_checkpoint`` / ``store_recover`` / ``store_index_build`` spans,
and inside a checkpoint the port's ``store_checkpoint_bin`` /
``store_checkpoint_layouts`` / ``store_sidecar``.
"""

from __future__ import annotations

import json
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
from bibfs_tpu_torch.store.wal import (
    FSYNC_POLICIES,
    WalWriter,
    fsync_dir,
    list_segments,
    read_wal,
    repair_wal,
    segment_path,
)
from bibfs_tpu_torch.utils.annotations import guarded_by

#: checkpoint snapshots of a durable store (``<name>.v<V>.<digest12>.bin``):
#: never seed graphs of :meth:`GraphStore.from_dir`. The digest suffix is
#: required, so a seed that merely looks versioned (``roads.v2.bin``) is
#: neither hidden nor ever collected
_CKPT_BIN_RE = re.compile(r"\.v(\d+)\.[0-9a-f]{6,32}\.bin$")

#: "no override" for ``_write_manifest_locked``'s ``arrays_dir`` (None is
#: a value there: "this checkpoint has no sidecar")
_UNSET = object()


class _Entry:
    """One named graph's mutable slot: the current snapshot, the pending
    overlay, the compaction serializer, and the oracle state (the current
    oracle, the live-graph generation, the in-flight builder, counts)."""

    __slots__ = ("snapshot", "overlay", "compactor", "compact_lock",
                 "swaps", "compactions", "compact_failures",
                 "graph_gen", "oracle", "oracle_builder", "oracle_cells",
                 "index_builds", "index_aborts", "index_repairs",
                 "index_failures", "index_error",
                 "wal", "wal_seq", "bin_file", "checkpoints", "recovered",
                 "arrays_dir", "touched")

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
        # durability (unused on a store without wal_dir)
        self.wal: WalWriter | None = None
        self.wal_seq = 0
        self.bin_file: str | None = None
        self.checkpoints = 0
        self.recovered: dict | None = None
        # the committed arrays sidecar, and the residency accountant's
        # recency stamp
        self.arrays_dir: str | None = None
        self.touched = time.monotonic()


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
    wal_dir : the directory of the durability layer (module docstring):
        WAL segments, checkpoint ``.bin`` files, sidecars and manifests.
        None (default): acked updates live in process memory only.
    fsync : the WAL's fsync policy, ``always`` / ``batch`` / ``off``
        (``store/wal.py``). Default ``batch``.
    fsync_batch_records : group-commit size under ``fsync="batch"``.
    faults : a :class:`bibfs_tpu_torch.serve.faults.FaultPlan` firing at
        the durability seams; default: built from ``BIBFS_FAULTS`` when
        set, else none.
    retain_history : keep superseded checkpoint bins and WAL segments, so
        every committed version stays reconstructible (needs ``wal_dir``).
    mmap_arrays : write arrays sidecars at checkpoints and recover by
        mapping them (default True); False rebuilds from the ``.bin``.
    residency_budget : process-private resident bytes past which the
        accountant demotes least recently used hot graphs to the cold
        tier; None (default) disables demotion.
    sidecar_layouts : serving layouts every sidecar this store writes
        carries, built first where the snapshot lacks them: ``"ell"``
        and/or ``"blocked"`` (module docstring). Default ``()``: only what
        the snapshot already built, as the reference.
    """

    def __init__(self, *, compact_threshold: int | None = 256,
                 oracle_k: int | None = None,
                 oracle_repair_max: int = 64,
                 oracle_seed: int = 0,
                 obs_label: str | None = None,
                 device=None,
                 wal_dir=None, fsync: str = "batch",
                 fsync_batch_records: int = 64, faults=None,
                 retain_history: bool = False,
                 mmap_arrays: bool = True,
                 residency_budget: int | None = None,
                 sidecar_layouts=()):
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
        # the memory-tier families (refreshed at scrape time below)
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
        self.mmap_arrays = bool(mmap_arrays)
        self.sidecar_layouts = tuple(sidecar_layouts)
        unknown = set(self.sidecar_layouts) - {"ell", "blocked"}
        if unknown:
            raise ValueError(
                f"unknown sidecar layouts {sorted(unknown)} (known: ell, "
                "blocked)"
            )
        self.residency_budget = (
            None if residency_budget is None else int(residency_budget)
        )
        if self.residency_budget is not None and self.residency_budget < 0:
            raise ValueError(
                f"residency_budget must be >= 0 bytes, got {residency_budget}"
            )
        # scrape-time tier census and mapped bytes, weakly bound: a dead
        # store unregisters itself
        mem_ref = weakref.ref(self)

        def _collect_memory():
            st = mem_ref()
            if st is None:
                return False
            st._refresh_memory_metrics()
            return True

        REGISTRY.add_collector(_collect_memory)
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync policy {fsync!r} "
                f"(known: {', '.join(FSYNC_POLICIES)})"
            )
        self.wal_dir = None if wal_dir is None else os.fspath(wal_dir)
        self.retain_history = bool(retain_history)
        if self.retain_history and self.wal_dir is None:
            raise ValueError(
                "retain_history=True needs a durable store (wal_dir=): "
                "history is reconstructed from the WAL + checkpoints"
            )
        self.fsync = fsync
        self.fsync_batch_records = int(fsync_batch_records)
        if faults is None:
            from bibfs_tpu_torch.serve.faults import FaultPlan

            faults = FaultPlan.from_env()
        self._faults = faults
        if self.wal_dir is not None:
            if not os.path.isdir(self.wal_dir):
                raise ValueError(f"wal_dir {self.wal_dir!r} is not a directory")
            self._c_wal_records = REGISTRY.counter(
                "bibfs_wal_records_total",
                "Write-ahead-log records appended (one acked update "
                "batch each)",
                ("store", "graph"),
            )
            self._c_wal_fsyncs = REGISTRY.counter(
                "bibfs_wal_fsyncs_total",
                "Write-ahead-log fsyncs issued (policy-dependent)",
                ("store", "graph"),
            )
            self._c_checkpoints = REGISTRY.counter(
                "bibfs_checkpoints_total",
                "Crash-consistent checkpoints committed (snapshot .bin "
                "+ manifest + WAL segment switch)",
                ("store", "graph"),
            )
            self._c_recovery_replayed = REGISTRY.counter(
                "bibfs_recovery_replayed_records",
                "WAL records replayed during recovery",
                ("store", "graph"),
            )
            self._g_recovery_seconds = REGISTRY.gauge(
                "bibfs_recovery_seconds",
                "Duration of the graph's last manifest+replay recovery",
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
        first added graph becomes the default. On a durable store this
        also writes the graph's seed ``.bin`` (if absent), its sidecar, its
        v1 manifest and opens its first WAL segment, and refuses a name
        that already has durable state on disk (recover it with
        ``from_dir(durable=True)``: appending to a dead process's WAL would
        interleave two histories)."""
        name = str(name)
        if snapshot is None:
            if n is None:
                raise ValueError("add() needs n+edges/pairs or snapshot=")
            snapshot = GraphSnapshot.build(n, edges, pairs=pairs)
        if self.wal_dir is not None and (
            os.path.exists(self._manifest_path(name))
            or list_segments(self.wal_dir, name)
        ):
            raise ValueError(
                f"graph {name!r} has durable state in {self.wal_dir!r}; "
                "recover it with GraphStore.from_dir(..., durable=True)"
            )
        entry = self._register(name, snapshot)
        if self.wal_dir is not None:
            try:
                self._durable_register(name, entry)
            except BaseException:
                # unregister: a half-registered graph would ack updates
                # with no WAL on a store the caller believes durable
                with self._lock:
                    self._entries.pop(name, None)
                    if self._default == name:
                        self._default = min(self._entries, default=None)
                    self._g_graphs.set(len(self._entries))
                raise
        self._kick_oracle(name, entry)
        self._maybe_rebalance()
        return snapshot

    def _register(self, name: str, snapshot: GraphSnapshot, *,
                  version: int = 1) -> _Entry:
        """The in-memory half of registration (a recovery registers at the
        manifest's version instead of 1)."""
        with self._lock:
            if name in self._entries:
                raise ValueError(
                    f"graph {name!r} already registered (swap() replaces)"
                )
            # versions are store-relative: every graph starts at v1
            snapshot.version = int(version)
            entry = _Entry(snapshot)
            self._entries[name] = entry
            if self._default is None:
                self._default = name
            self._g_graphs.set(len(self._entries))
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
        graph is deterministic.

        ``durable=True`` roots the durability layer in the same directory
        (``wal_dir=path`` unless given) and recovers every graph that left a
        manifest or WAL behind (module docstring). Checkpoint ``.bin``
        files are never seed graphs.

        A graph that does not load (a torn ``.bin``, a bad manifest, a
        digest mismatch, a forked WAL) is skipped with a counted warning
        (``store.load_errors``); only a directory with no loadable graph
        raises."""
        from bibfs_tpu_torch.graph.io import read_graph_bin

        path = os.fspath(path)
        if durable:
            kwargs.setdefault("wal_dir", path)
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
                if store.wal_dir is not None and (
                    os.path.exists(store._manifest_path(name))
                    or list_segments(store.wal_dir, name)
                ):
                    store._recover_graph(name)
                else:
                    n, edges = read_graph_bin(os.path.join(path, f"{name}.bin"))
                    store.add(name, n, edges)
            except (OSError, ValueError, KeyError,
                    json.JSONDecodeError) as e:
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

    # ---- durability (WAL, checkpoints, recovery) ---------------------
    def _fire(self, site: str) -> None:
        if self._faults is not None:
            self._faults.fire(site)

    def _manifest_path(self, name: str) -> str:
        return os.path.join(self.wal_dir, f"{name}.manifest.json")

    def _open_segment(self, name: str, seq: int) -> WalWriter:
        rec = self._c_wal_records.labels(store=self.obs_label, graph=name)
        fsn = self._c_wal_fsyncs.labels(store=self.obs_label, graph=name)
        return WalWriter(
            segment_path(self.wal_dir, name, seq),
            fsync=self.fsync,
            batch_records=self.fsync_batch_records,
            fire=self._fire,
            on_record=rec.inc,
            on_fsync=fsn.inc,
        )

    def _durable_register(self, name: str, entry: _Entry) -> None:
        """A fresh durable registration: the seed ``.bin`` (written
        atomically if absent, else digest-checked against the registered
        snapshot), its sidecar, the v1 manifest, the first WAL segment."""
        from bibfs_tpu_torch.graph.io import read_graph_bin, write_graph_bin

        entry.bin_file = f"{name}.bin"
        seed = os.path.join(self.wal_dir, entry.bin_file)
        if not os.path.exists(seed):
            write_graph_bin(
                seed, entry.snapshot.n, entry.snapshot.undirected_edges()
            )
        else:
            n, edges = read_graph_bin(seed)
            on_disk = GraphSnapshot.build(n, edges)
            if on_disk.digest != entry.snapshot.digest:
                raise ValueError(
                    f"{entry.bin_file} already exists with different "
                    f"content (digest {on_disk.digest} != registered "
                    f"{entry.snapshot.digest}); refusing to register a "
                    "graph its own seed could not recover"
                )
        if self.mmap_arrays:
            # the seed's sidecar, before the manifest references it (off
            # the store lock): a respawn of this graph then maps it
            from bibfs_tpu_torch.store.sidecar import write_sidecar

            self._build_layouts(name, entry.snapshot)
            entry.arrays_dir = write_sidecar(
                self.wal_dir, name, entry.snapshot, fire=self._fire
            )
        entry.wal_seq = 1
        self._c_checkpoints.labels(store=self.obs_label, graph=name)
        self._c_recovery_replayed.labels(store=self.obs_label, graph=name)
        self._g_recovery_seconds.labels(
            store=self.obs_label, graph=name
        ).set(0.0)
        with self._lock:
            self._write_manifest_locked(name, entry)
        entry.wal = self._open_segment(name, entry.wal_seq)

    def _write_manifest_locked(self, name: str, entry: _Entry, *,
                               snapshot: GraphSnapshot | None = None,
                               bin_file: str | None = None,
                               arrays_dir=_UNSET) -> None:
        """Commit the graph's manifest by atomic rename: a tmp file,
        flushed and fsynced, ``os.replace`` (the ``manifest_rename`` fault
        site), a directory fsync. A failure anywhere leaves the previous
        manifest governing recovery, with the WAL segments it needs still
        on disk. ``snapshot`` / ``bin_file`` / ``arrays_dir`` override the
        entry's (``swap()`` commits before its in-memory flip). A
        ``retain_history`` store then appends the version to its history
        (best-effort: a failed append does not undo the commit)."""
        snapshot = entry.snapshot if snapshot is None else snapshot
        manifest = {
            "graph": name,
            "version": snapshot.version,
            "digest": snapshot.digest,
            "n": snapshot.n,
            "edges": snapshot.num_edges,
            "bin": entry.bin_file if bin_file is None else bin_file,
            # the mapped recovery's pointer; None: recovery rebuilds
            "arrays": (
                entry.arrays_dir if arrays_dir is _UNSET else arrays_dir
            ),
            "wal": f"{name}.wal.{entry.wal_seq}",
            "wal_seq": entry.wal_seq,
            "wal_offset": 0,
            "checkpoints": entry.checkpoints,
        }
        path = self._manifest_path(name)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            self._fire("manifest_rename")
            os.replace(tmp, path)
        except BaseException:
            self._unlink_quiet(tmp)
            raise
        fsync_dir(self.wal_dir)
        if not self.retain_history:
            return
        from bibfs_tpu_torch.store.history import append_history

        try:
            append_history(self.wal_dir, name, {
                "version": snapshot.version,
                "digest": snapshot.digest,
                "bin": manifest["bin"],
                "wal_seq": entry.wal_seq,
                "n": snapshot.n,
                "edges": snapshot.num_edges,
            })
        except OSError as e:
            print(
                f"[Store] history append failed for {name!r} "
                f"v{snapshot.version}: {e}",
                file=sys.stderr,
            )

    def _wal_roll_locked(self, name: str, entry: _Entry) -> int:
        """Switch the graph to a fresh WAL segment; in the same locked
        section as the overlay capture it fences."""
        old = entry.wal
        entry.wal_seq += 1
        entry.wal = self._open_segment(name, entry.wal_seq)
        if old is not None:
            old.close()  # flushes and fsyncs the completed segment
        return entry.wal_seq

    def _checkpoint_locked(self, name: str, entry: _Entry, bin_file: str,
                           arrays_dir: str | None = None) -> None:
        """Commit a checkpoint of the current (just swapped) snapshot: the
        manifest points at ``bin_file``, ``arrays_dir`` (both already
        written) and the current WAL segment."""
        with span("store_checkpoint", graph=name,
                  version=entry.snapshot.version, wal_seq=entry.wal_seq):
            entry.bin_file = bin_file
            entry.arrays_dir = arrays_dir
            self._write_manifest_locked(name, entry)
            entry.checkpoints += 1
            self._c_checkpoints.labels(
                store=self.obs_label, graph=name
            ).inc()

    def _unlink_quiet(self, path) -> None:
        if not path:
            return
        try:
            os.unlink(path if os.path.isabs(str(path))
                      else os.path.join(self.wal_dir, str(path)))
        except OSError:
            pass

    def _ckpt_bin_name(self, name: str, snapshot: GraphSnapshot) -> str:
        """A checkpoint's filename: version and digest prefix, so two
        writers can only collide on byte-identical files."""
        return f"{name}.v{snapshot.version}.{snapshot.digest[:12]}.bin"

    def _gc_durable(self, name: str, entry: _Entry) -> None:
        """Delete superseded checkpoint bins, sidecars and WAL segments
        (below the committed manifest), best-effort, once the manifest
        rename made them unreachable. The manifest's own bin and sidecar
        and the seed ``<name>.bin`` stay. A ``retain_history`` store keeps
        everything: its superseded files are the history."""
        if self.retain_history:
            return
        from bibfs_tpu_torch.store.sidecar import (
            ARRAYS_DIR_RE,
            remove_sidecar_quiet,
        )

        cur_v = entry.snapshot.version
        cur_seq = entry.wal_seq
        keep = entry.bin_file
        keep_arrays = entry.arrays_dir
        for seq, path in list_segments(self.wal_dir, name):
            if seq < cur_seq:
                self._unlink_quiet(path)
        prefix = f"{name}.v"
        for fname in os.listdir(self.wal_dir):
            if not fname.startswith(prefix) or fname == keep:
                continue
            m = _CKPT_BIN_RE.search(fname)
            if (m is not None and fname[: m.start()] == name
                    and int(m.group(1)) <= cur_v):
                self._unlink_quiet(os.path.join(self.wal_dir, fname))
                continue
            if fname == keep_arrays:
                continue
            # superseded sidecars go with their bins, and so does a dead
            # writer's uncommitted ``.arrays.tmp.<pid>``; both bounded by
            # version, so a writer of a newer version is never swept
            m = ARRAYS_DIR_RE.search(fname)
            if m is None:
                m = re.search(
                    r"\.v(\d+)\.[0-9a-f]{6,32}\.arrays\.tmp\.\d+$", fname
                )
            if (m is not None and fname[: m.start()] == name
                    and int(m.group(1)) <= cur_v):
                remove_sidecar_quiet(os.path.join(self.wal_dir, fname))

    def _recover_graph(self, name: str) -> None:
        """Manifest and replay (module docstring): the manifest's snapshot
        (mapped from its sidecar, or rebuilt from its ``.bin``; its digest
        checked), every surviving WAL segment ``>= wal_seq`` replayed in
        order with a torn tail of the last one truncated, the overlay
        re-armed, and the landmark index adopted from the sidecar or
        rebuilt. Raises before registering anything on a broken base, a
        digest mismatch, a torn segment that is not the last, or a record
        its own prefix rejects: a history that cannot be proven whole is
        refused, never served in part. ``entry.recovered`` keeps the
        seconds of each step (``split_s``)."""
        from bibfs_tpu_torch.graph.io import read_graph_bin

        t0 = time.perf_counter()
        mpath = self._manifest_path(name)
        manifest = None
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
        bin_file = f"{name}.bin" if manifest is None else str(manifest["bin"])
        version = 1 if manifest is None else int(manifest["version"])
        wal_seq = 1 if manifest is None else int(manifest["wal_seq"])
        arrays_dir = None if manifest is None else manifest.get("arrays")
        snap = None
        remapped = False
        if arrays_dir is not None and self.mmap_arrays:
            # map the committed sidecar: its size checked here, its content
            # digest recomputed from the mapped pairs by from_sidecar; any
            # failure falls through to the .bin rebuild, loudly
            from bibfs_tpu_torch.store.sidecar import load_sidecar

            try:
                smap = load_sidecar(
                    os.path.join(self.wal_dir, str(arrays_dir)),
                    verify="size",
                )
                if (manifest.get("digest") is not None
                        and smap.digest != manifest["digest"]):
                    raise ValueError(
                        f"sidecar digest {smap.digest} != manifest "
                        f"{manifest['digest']} (stale sidecar)"
                    )
                snap = GraphSnapshot.from_sidecar(smap, version=version)
                remapped = True
            except (OSError, ValueError, KeyError) as e:
                print(
                    f"[Store] sidecar remap failed for {name!r} "
                    f"({arrays_dir}): {e}; rebuilding from {bin_file}",
                    file=sys.stderr,
                )
                snap = None
        if snap is None:
            arrays_dir = None  # the manifest's sidecar does not serve
            n, edges = read_graph_bin(os.path.join(self.wal_dir, bin_file))
            snap = GraphSnapshot.build(n, edges)
        if manifest is not None and manifest.get("digest") is not None \
                and manifest["digest"] != snap.digest:
            raise ValueError(
                f"{bin_file}: content digest {snap.digest} does not "
                f"match manifest {manifest['digest']} — refusing to "
                "serve a snapshot that is not the one checkpointed"
            )
        t_base = time.perf_counter()
        replayed = 0
        truncated = False
        overlay = None
        segments = [
            (sq, sp) for sq, sp in list_segments(self.wal_dir, name)
            if sq >= wal_seq
        ]
        # the replay is proven before anything registers
        with span("store_recover", graph=name, version=version,
                  segments=len(segments)):
            for i, (_seq, spath) in enumerate(segments):
                if i == len(segments) - 1:
                    # the one tear a crash can leave: mid-append on the
                    # live segment; truncate it so appends resume on a
                    # valid prefix
                    records, torn = repair_wal(spath)
                    truncated = truncated or torn
                else:
                    records, _good, torn = read_wal(spath)
                    if torn:
                        # a completed segment torn: the records of later
                        # segments depend on the lost ones
                        raise ValueError(
                            f"{os.path.basename(spath)}: torn "
                            "non-final WAL segment — acked records "
                            "beyond it are unrecoverable; refusing to "
                            "serve a forked history"
                        )
                for _rec_version, adds, dels in records:
                    if overlay is None:
                        overlay = DeltaOverlay(snap)
                        overlay.ensure_index()
                    try:
                        overlay.apply(adds, dels)
                    except ValueError as e:
                        raise ValueError(
                            f"{os.path.basename(spath)}: WAL record "
                            f"inconsistent with its own prefix ({e}); "
                            "refusing to serve a forked history"
                        ) from e
                    replayed += 1
            t_replay = time.perf_counter()
            entry = self._register(name, snap, version=version)
            entry.bin_file = bin_file
            entry.arrays_dir = None if arrays_dir is None else str(arrays_dir)
            self._c_checkpoints.labels(store=self.obs_label, graph=name)
            entry.graph_gen += replayed  # one live-graph gen per batch
            entry.wal_seq = segments[-1][0] if segments else wal_seq
            entry.wal = self._open_segment(name, entry.wal_seq)
            delta = 0
            if overlay is not None and overlay.delta_edges > 0:
                entry.overlay = overlay
                delta = overlay.delta_edges
            self._g_delta.labels(store=self.obs_label, graph=name).set(delta)
        adopted = self._adopt_index(name, entry)
        t_end = time.perf_counter()
        dt = t_end - t0
        self._c_recovery_replayed.labels(
            store=self.obs_label, graph=name
        ).inc(replayed)
        self._g_recovery_seconds.labels(
            store=self.obs_label, graph=name
        ).set(dt)
        if remapped:
            self._c_remaps.labels(store=self.obs_label, graph=name).inc()
            self._g_mmap_bytes.labels(store=self.obs_label, graph=name).set(
                snap.mapped_bytes()
            )
        entry.recovered = {
            "version": version,
            "replayed_records": replayed,
            "torn_tail_truncated": truncated,
            "segments": len(segments),
            "delta_edges": delta,
            "recovery_s": round(dt, 6),
            "remapped": remapped,
            "index_adopted": adopted,
            # where the seconds went: the base snapshot (the sidecar mapped
            # and its digest recomputed, or the .bin read and rebuilt), the
            # WAL replay, the registration and the index adoption
            "split_s": {
                "base": t_base - t0,
                "replay": t_replay - t_base,
                "register": t_end - t_replay,
            },
        }
        if (self.compact_threshold is not None
                and delta >= self.compact_threshold):
            # a long replay re-armed a big overlay: fold it now
            with self._lock:
                if entry.compactor is None:
                    entry.compactor = threading.Thread(
                        target=self._compact_job, args=(name, entry),
                        name=f"bibfs-compact-{name}", daemon=True,
                    )
                    entry.compactor.start()
        if not adopted:
            self._kick_oracle(name, entry)
        self._maybe_rebalance()

    def _adopt_index(self, name: str, entry: _Entry) -> bool:
        """Make the mapped sidecar's ``oracle.*`` group the graph's index
        when it holds ``oracle_k`` landmarks of this snapshot: as it is when
        nothing was replayed, with the replayed adds repaired in (exact,
        ``oracle/trees.py``) when the overlay holds adds only and no more
        than ``oracle_repair_max``. True iff an index was installed; a
        replayed delete leaves the graph without one until the next
        compaction, as a delete does on a live store."""
        if self.oracle_k is None:
            return False
        snap = entry.snapshot
        got = snap.oracle_arrays()
        if got is None:
            return False
        from bibfs_tpu_torch.oracle import DistanceOracle, LandmarkIndex

        landmarks, dist, meta = got
        if int(landmarks.shape[0]) != self.oracle_k:
            return False
        index = LandmarkIndex(
            snap.n, landmarks, dist, digest=snap.digest,
            version=snap.version, gen=entry.graph_gen,
            built_at=meta.get("built_at"),
            repaired_edges=int(meta.get("repaired_edges", 0)),
        )
        overlay = entry.overlay
        if overlay is not None:
            del_set, add_adj = overlay.correction()
            adds, _dels = overlay.capture()
            if (del_set or index.repaired_edges + len(adds)
                    > self.oracle_repair_max):
                return False
            row_ptr, col_ind = snap.csr()
            with span("store_index_build", graph=name, kind="repair",
                      adds=len(adds)):
                index = index.repair_adds(
                    row_ptr, col_ind, add_adj, sorted(adds),
                    gen=entry.graph_gen,
                )
        with self._lock:
            entry.oracle = DistanceOracle(
                index, metrics_label=self._oracle_label(name),
                cells=entry.oracle_cells,
            )
        return True

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
            entry = self._entry(name)
            entry.touched = time.monotonic()  # the accountant's LRU stamp
            return entry.snapshot.retain()

    def touch(self, name: str) -> None:
        """Refresh ``name``'s recency stamp without pinning: the engines
        call this where they pin a snapshot for a flush (a served graph
        resolves through a runtime that is already retained, so without
        it :meth:`rebalance` would demote by first acquire, not by use).
        An unknown name is ignored: the engine may race a remove."""
        with self._lock:
            entry = self._entries.get(str(name))
            if entry is not None:
                entry.touched = time.monotonic()

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
        ..., "compacting": bool}``.

        On a durable store the batch is logged between its validation and
        the in-memory commit, in one locked section, and returning is the
        ack: it comes only once the record is durable under the fsync
        policy. A failed append (a disk fault, an injected ``wal_write`` /
        ``wal_fsync``) raises with nothing committed. Under
        ``fsync="always"`` the fsync runs under the store lock, so updates
        serialize against name resolution for one fsync."""
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
                if entry.wal is not None:
                    # validate, log, commit: the dry run refuses a bad batch
                    # before it reaches the log and makes the apply below
                    # infallible, so log and overlay never disagree
                    overlay.apply(adds, dels, commit=False)
                    entry.wal.append(entry.snapshot.version, adds, dels)
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
            self._maybe_rebalance()
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
        aborts.

        On a durable store a compaction is a checkpoint: the capture and
        the WAL segment switch share one locked section, the snapshot lands
        as an atomic ``<name>.v<V>.<digest12>.bin`` beside its sidecar (with
        the ``sidecar_layouts`` and, on an oracle store, the index of
        :meth:`_checkpoint_index`), and the manifest rename commits it;
        superseded files go only after that."""
        with self._lock:
            entry = self._entry(name)
        with entry.compact_lock:
            with self._lock:
                overlay = entry.overlay
                if overlay is None or overlay.delta_edges == 0:
                    return entry.snapshot  # nothing pending
                adds, dels = overlay.capture()
                base = entry.snapshot
                if entry.wal is not None:
                    self._wal_roll_locked(name, entry)
            index = None
            with span("store_compact", graph=name,
                      delta=len(adds) + len(dels)):
                new, adds, dels = overlay.snapshot(adds, dels)
                bin_file = None
                arrays_dir = None
                if entry.wal is not None:
                    from bibfs_tpu_torch.graph.io import write_graph_bin

                    new.version = base.version + 1  # re-stamped at commit
                    bin_file = self._ckpt_bin_name(name, new)
                    with span("store_checkpoint_bin", graph=name):
                        write_graph_bin(
                            os.path.join(self.wal_dir, bin_file),
                            new.n, new.undirected_edges(),
                        )
                    if self.mmap_arrays:
                        from bibfs_tpu_torch.store.sidecar import (
                            write_sidecar,
                        )

                        self._build_layouts(name, new)
                        index = self._checkpoint_index(name, entry, new)
                        with span("store_sidecar", graph=name):
                            arrays_dir = write_sidecar(
                                self.wal_dir, name, new, oracle_index=index,
                                fire=self._fire,
                            )
                # pre-build the carried overlay's index off the lock too
                rebased = DeltaOverlay(new)
                rebased.ensure_index()
                with self._lock:
                    if self._entry(name).overlay is not overlay:
                        # an external swap() discarded this overlay: its
                        # snapshot is the caller's declared truth. The
                        # switched segment replays harmlessly; the orphan
                        # files go unless the swap committed the same ones
                        if entry.bin_file != bin_file:
                            self._unlink_quiet(bin_file)
                        if (arrays_dir is not None
                                and entry.arrays_dir != arrays_dir):
                            from bibfs_tpu_torch.store.sidecar import (
                                remove_sidecar_quiet,
                            )

                            remove_sidecar_quiet(
                                os.path.join(self.wal_dir, arrays_dir)
                            )
                        return entry.snapshot
                    new.version = entry.snapshot.version + 1
                    self._swap_locked(name, entry, new)
                    a2, d2 = overlay.rebase(adds, dels)
                    if a2 or d2:
                        rebased.apply(sorted(a2), sorted(d2))
                        entry.overlay = rebased
                    else:
                        entry.overlay = None
                        if index is not None:
                            # the checkpoint's index is the live graph's
                            self._install_index_locked(name, entry, index)
                    self._g_delta.labels(
                        store=self.obs_label, graph=name
                    ).set(len(a2) + len(d2))
                    entry.compactions += 1
                    self._c_compactions.labels(
                        store=self.obs_label, graph=name
                    ).inc()
                    if entry.wal is not None:
                        # the manifest rename is the commit; a failure here
                        # raises as a counted compaction failure with the
                        # swap live, and the old manifest (whose segments
                        # are all still on disk) governs recovery
                        self._checkpoint_locked(
                            name, entry, bin_file, arrays_dir
                        )
            if entry.wal is not None:
                self._gc_durable(name, entry)
            # the swap dropped the old index: rebuild for the new snapshot
            # unless the checkpoint's own was installed
            if self.oracle(name) is None:
                self._kick_oracle(name, entry)
            self._maybe_rebalance()
            return new

    def _build_layouts(self, name: str, snap: GraphSnapshot) -> None:
        """Build the ``sidecar_layouts`` ``snap`` lacks, off the store lock,
        before its sidecar is written."""
        if not self.sidecar_layouts:
            return
        with span("store_checkpoint_layouts", graph=name):
            if "ell" in self.sidecar_layouts:
                snap.ell()
            if "blocked" in self.sidecar_layouts:
                snap.blocked()

    def _checkpoint_index(self, name: str, entry: _Entry,
                          new: GraphSnapshot):
        """On an oracle store, ``new``'s landmark index for its checkpoint's
        sidecar, built off the store lock on the store's device (module
        docstring). A build that fails is counted like the background
        builder's, and the checkpoint goes on without it."""
        if self.oracle_k is None:
            return None
        from bibfs_tpu_torch.oracle import build_index

        row_ptr, col_ind = new.csr()
        try:
            with span("store_index_build", graph=name, k=self.oracle_k,
                      kind="checkpoint"):
                index = build_index(
                    new.n, row_ptr, col_ind, self.oracle_k,
                    seed=self.oracle_seed, digest=new.digest,
                    version=new.version, device=self.device,
                )
        except Exception as e:
            with self._lock:
                entry.index_failures += 1
                entry.index_error = (
                    entry.graph_gen, f"{type(e).__name__}: {e}"[:300]
                )
            return None
        with self._lock:
            entry.index_builds += 1
        self._c_index_builds.labels(store=self.obs_label, graph=name).inc()
        return index

    def _install_index_locked(self, name: str, entry: _Entry,
                              index) -> None:
        """Make ``index`` (built for the current snapshot with nothing
        pending) the graph's current index."""
        from bibfs_tpu_torch.oracle import DistanceOracle

        index.gen = entry.graph_gen
        entry.oracle = DistanceOracle(
            index, metrics_label=self._oracle_label(name),
            cells=entry.oracle_cells,
        )
        entry.index_error = None

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
        declared truth.

        On a durable store the declared truth is checkpointed before the
        in-memory flip, in one locked section with the WAL segment switch:
        a manifest failure then raises with the in-memory state (and every
        later ack) unchanged."""
        name = str(name)
        bin_file = None
        arrays_dir = None
        with self._lock:
            entry = self._entry(name)
            if entry.wal is not None:
                if snapshot.version <= entry.snapshot.version:
                    raise ValueError(
                        f"swap must move {name!r} forward: new version "
                        f"{snapshot.version} <= current "
                        f"{entry.snapshot.version}"
                    )
                bin_file = self._ckpt_bin_name(name, snapshot)
        if bin_file is not None:
            # the heavy writes, off the store lock
            from bibfs_tpu_torch.graph.io import write_graph_bin

            write_graph_bin(
                os.path.join(self.wal_dir, bin_file),
                snapshot.n, snapshot.undirected_edges(),
            )
            if self.mmap_arrays:
                from bibfs_tpu_torch.store.sidecar import write_sidecar

                self._build_layouts(name, snapshot)
                arrays_dir = write_sidecar(
                    self.wal_dir, name, snapshot, fire=self._fire
                )
        try:
            with self._lock:
                entry = self._entry(name)
                if entry.wal is not None:
                    # re-checked under this lock hold: nothing interleaves
                    # between the durable commit and the flip
                    if snapshot.version <= entry.snapshot.version:
                        raise ValueError(
                            f"swap must move {name!r} forward: new "
                            f"version {snapshot.version} <= current "
                            f"{entry.snapshot.version}"
                        )
                    self._wal_roll_locked(name, entry)
                    with span("store_checkpoint", graph=name,
                              version=snapshot.version,
                              wal_seq=entry.wal_seq):
                        self._write_manifest_locked(
                            name, entry, snapshot=snapshot,
                            bin_file=bin_file, arrays_dir=arrays_dir,
                        )
                        entry.bin_file = bin_file
                        entry.arrays_dir = arrays_dir
                        entry.checkpoints += 1
                        self._c_checkpoints.labels(
                            store=self.obs_label, graph=name
                        ).inc()
                old = self._swap_locked(name, entry, snapshot)
                entry.overlay = None
                self._g_delta.labels(store=self.obs_label, graph=name).set(0)
        except BaseException:
            # never unlink a file a committed manifest references
            if entry.bin_file != bin_file:
                self._unlink_quiet(bin_file)
            raise
        if entry.wal is not None:
            self._gc_durable(name, entry)
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

    # ---- residency accountant (memory tiers, module docstring) -------
    def _refresh_memory_metrics(self) -> None:
        """Scrape-time refresh: per-graph mapped bytes and the tier
        census."""
        with self._lock:
            snaps = {name: e.snapshot for name, e in self._entries.items()}
        tiers = {"mapped": 0, "hot": 0, "cold": 0}
        for name, snap in snaps.items():
            self._g_mmap_bytes.labels(
                store=self.obs_label, graph=name
            ).set(snap.mapped_bytes())
            tiers[snap.tier] += 1
        for tier, count in tiers.items():
            self._g_tier.labels(store=self.obs_label, tier=tier).set(count)

    def _maybe_rebalance(self) -> None:
        if self.residency_budget is not None:
            self.rebalance()

    def rebalance(self) -> dict:
        """One accountant pass: while the store's private resident total
        exceeds ``residency_budget``, demote the least recently used hot
        graph to the cold tier (the encode runs off the store lock; the
        serving pointer never moves). Runs after every registration,
        update batch and compaction; callable any time. Returns what it
        did."""
        with self._lock:
            candidates = [
                (e.touched, name, e.snapshot)
                for name, e in self._entries.items()
            ]
        total = sum(s.resident_bytes() for _, _, s in candidates)
        demoted: list[str] = []
        freed = 0
        if self.residency_budget is not None:
            for _touched, name, snap in sorted(candidates,
                                               key=lambda c: c[0]):
                if total <= self.residency_budget:
                    break
                if snap.tier != "hot":
                    continue
                got = snap.demote()
                if got > 0:
                    total -= got
                    freed += got
                    demoted.append(name)
        self._refresh_memory_metrics()
        return {"demoted": demoted, "freed_bytes": freed,
                "resident_bytes": total}

    def memory_stats(self) -> dict:
        """Per-graph tier, resident and mapped bytes, and the budget's
        headroom (the CLI's stdin ``memory``)."""
        with self._lock:
            per = {}
            for name, entry in self._entries.items():
                per[name] = {
                    **entry.snapshot.memory(),
                    "version": entry.snapshot.version,
                    "digest": entry.snapshot.digest,
                    "arrays": entry.arrays_dir,
                }
        resident = sum(g["resident_bytes"] for g in per.values())
        mapped = sum(g["mapped_bytes"] for g in per.values())
        budget = self.residency_budget
        return {
            "graphs": per,
            "resident_bytes": resident,
            "mapped_bytes": mapped,
            "residency_budget": budget,
            "headroom_bytes": None if budget is None else budget - resident,
            "mmap_arrays": self.mmap_arrays,
        }

    # ---- time-travel reads (store/history.py) ------------------------
    def history(self, name: str) -> list[dict]:
        """The graph's committed version entries (empty on a store that is
        not durable, or before the first commit)."""
        if self.wal_dir is None:
            return []
        from bibfs_tpu_torch.store.history import load_history

        return load_history(self.wal_dir, str(name))

    def reconstruct_version(self, name: str, version: int) -> GraphSnapshot:
        """The graph as of committed ``version``: a fresh, unpinned
        snapshot the caller owns, digest-checked against the history
        recorded at commit. The current version answers from the live base
        snapshot's pairs. Raises ``ValueError`` for an unknown or no longer
        provable version."""
        name, version = str(name), int(version)
        with self._lock:
            cur = self._entry(name).snapshot
        if version == cur.version:
            # a fresh object sharing the immutable pairs: the caller's
            # refcount is decoupled from the store's
            return GraphSnapshot(
                cur.n, cur.pairs, digest=cur.digest, version=version
            )
        if self.wal_dir is None:
            raise ValueError(
                f"as_of version {version} != current {cur.version} "
                f"needs a durable store (wal_dir=) to reconstruct from"
            )
        from bibfs_tpu_torch.store.history import reconstruct_version

        return reconstruct_version(self.wal_dir, name, version)

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
                if entry.wal is not None:
                    graphs[name]["durable"] = {
                        "wal_seq": entry.wal_seq,
                        "wal": entry.wal.stats(),
                        "bin": entry.bin_file,
                        "arrays": entry.arrays_dir,
                        "checkpoints": entry.checkpoints,
                        "recovered": entry.recovered,
                    }
            return {
                "graphs": graphs,
                "default": self._default,
                "compact_threshold": self.compact_threshold,
                "oracle_k": self.oracle_k,
                "durable": self.wal_dir is not None,
                "retain_history": self.retain_history,
                "fsync": self.fsync if self.wal_dir is not None else None,
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
        builds a finishing compaction starts), then close the WAL writers
        (the final fsync barrier)."""
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
                break
            for job in jobs:
                job.join()
        with self._lock:
            wals = [e.wal for e in self._entries.values() if e.wal is not None]
        for w in wals:
            try:
                w.close()
            except OSError:
                pass
