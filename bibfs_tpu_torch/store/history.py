"""Version history of a durable store: the counterpart of
``bibfs_tpu/store/history.py``, the same ``<name>.history.json``.

- ``<name>.history.json`` — one entry per committed version ``{version,
  digest, bin, wal_seq, n, edges}``, appended at every manifest commit
  (registration, compaction checkpoint, swap) of a
  ``retain_history=True`` store by an atomic tmp + ``os.replace``. A
  store that does not retain history writes none: its next commit
  deletes what an entry would point at.
- :func:`reconstruct_version` — the edge set as of version ``v``, from
  the retained checkpoint ``.bin`` when it survives (one read and a
  digest check), else the seed plus a replay of every WAL segment below
  the version's first segment (``wal_seq``): a checkpoint's capture and
  its segment switch share one locked section, so the segments below
  ``wal_seq(v)`` are exactly the records folded into ``v``. Either route
  must land on the recorded digest, or the read raises.
"""

from __future__ import annotations

import json
import os

import numpy as np

from bibfs_tpu_torch.store.wal import fsync_dir, list_segments, read_wal


def history_path(wal_dir, name: str) -> str:
    return os.path.join(os.fspath(wal_dir), f"{name}.history.json")


def load_history(wal_dir, name: str) -> list[dict]:
    """The graph's committed version entries, ascending by version
    (missing/corrupt file reads as empty — reconstruction then fails
    per-version with a clear error, never a crash here)."""
    try:
        with open(history_path(wal_dir, name)) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return []
    entries = data.get("entries")
    if not isinstance(entries, list):
        return []
    clean = []
    for e in entries:
        try:
            clean.append({
                "version": int(e["version"]),
                "digest": str(e["digest"]),
                "bin": str(e["bin"]),
                "wal_seq": int(e["wal_seq"]),
                "n": int(e["n"]),
                "edges": int(e["edges"]),
            })
        except (TypeError, KeyError, ValueError):
            continue
    clean.sort(key=lambda e: e["version"])
    return clean


def append_history(wal_dir, name: str, entry: dict) -> None:
    """Record one committed version (idempotent per version number —
    a re-commit of the same version replaces its entry). Atomic
    tmp+``os.replace`` + directory fsync, the manifest's own commit
    discipline: the file sits in the durable directory and must never
    be half-written."""
    entries = [
        e for e in load_history(wal_dir, name)
        if e["version"] != int(entry["version"])
    ]
    entries.append({
        "version": int(entry["version"]),
        "digest": str(entry["digest"]),
        "bin": str(entry["bin"]),
        "wal_seq": int(entry["wal_seq"]),
        "n": int(entry["n"]),
        "edges": int(entry["edges"]),
    })
    entries.sort(key=lambda e: e["version"])
    path = history_path(wal_dir, name)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": entries}, f,
                      indent=1, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(wal_dir)


def replay_edge_set(n: int, seed_edges: np.ndarray, wal_dir, name: str,
                    below_seq: int) -> np.ndarray:
    """The undirected edge set after replaying every WAL segment with
    ``seq < below_seq`` over the seed, in sequence order — the record
    set the checkpoint that opened segment ``below_seq`` folded in
    (module docstring). Raises on a torn segment: a history read must
    be provable, never approximate."""
    from bibfs_tpu_torch.store.delta import canonical_edge

    edges = {
        canonical_edge(n, int(u), int(v)) for u, v in seed_edges
    }
    for seq, path in list_segments(wal_dir, name):
        if seq >= below_seq:
            continue
        records, _good, torn = read_wal(path)
        if torn:
            raise ValueError(
                f"{os.path.basename(path)}: torn WAL segment in the "
                f"history replay for {name!r} — refusing an unprovable "
                "reconstruction"
            )
        for _ver, adds, dels in records:
            for u, v in adds:
                edges.add(canonical_edge(n, int(u), int(v)))
            for u, v in dels:
                edges.discard(canonical_edge(n, int(u), int(v)))
    if not edges:
        return np.zeros((0, 2), dtype=np.int64)
    return np.array(sorted(edges), dtype=np.int64)


def reconstruct_version(wal_dir, name: str, version: int):
    """The graph as of committed ``version``: a fresh
    :class:`~bibfs_tpu_torch.store.snapshot.GraphSnapshot`, digest-verified
    against the history entry recorded when that version committed.
    Raises ``ValueError`` when the version is unknown or its artifacts
    (checkpoint bin AND the WAL chain) no longer prove it."""
    from bibfs_tpu_torch.graph.io import read_graph_bin
    from bibfs_tpu_torch.store.snapshot import GraphSnapshot

    version = int(version)
    entries = {e["version"]: e for e in load_history(wal_dir, name)}
    entry = entries.get(version)
    if entry is None:
        known = sorted(entries)
        raise ValueError(
            f"no history entry for {name!r} version {version} "
            f"(recorded: {known or 'none'})"
        )
    bin_path = os.path.join(os.fspath(wal_dir), entry["bin"])
    snap = None
    if os.path.exists(bin_path):
        n, edges = read_graph_bin(bin_path)
        snap = GraphSnapshot.build(n, edges, version=version)
        if snap.digest != entry["digest"]:
            # a reused filename with different content (should be
            # impossible for digest-suffixed checkpoint bins, possible
            # for a hand-replaced seed): fall through to WAL replay,
            # which carries its own proof
            snap = None
    if snap is None:
        seed_path = os.path.join(os.fspath(wal_dir), f"{name}.bin")
        if not os.path.exists(seed_path):
            raise ValueError(
                f"{name!r} version {version}: checkpoint bin "
                f"{entry['bin']} is gone and no seed remains — "
                "unreconstructible (run the store with "
                "retain_history=True to keep history readable)"
            )
        n, seed_edges = read_graph_bin(seed_path)
        edges = replay_edge_set(
            n, seed_edges, wal_dir, name, entry["wal_seq"]
        )
        snap = GraphSnapshot.build(n, edges, version=version)
        if snap.digest != entry["digest"]:
            raise ValueError(
                f"{name!r} version {version}: WAL replay digest "
                f"{snap.digest} != recorded {entry['digest']} — part "
                "of the segment chain is missing (run the store with "
                "retain_history=True to keep history readable)"
            )
    return snap
