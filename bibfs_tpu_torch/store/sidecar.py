"""Arrays sidecar, the zero-copy on-disk twin of a checkpoint ``.bin``:
the counterpart of ``bibfs_tpu/store/sidecar.py``, the same files and the
same ``manifest.json``, so either package loads a sidecar the other wrote.

A checkpoint bin (``<name>.v<V>.<digest12>.bin``) is the portable truth,
but loading it re-canonicalizes O(E log E) and rebuilds every derived
table in each process. The sidecar (``<name>.v<V>.<digest12>.arrays/``)
holds the snapshot's derived arrays as raw little-endian files that a
process maps read-only (``np.memmap``):

- ``pairs``         int64 ``[D, 2]``  canonical directed pairs (the
  digest's input; ``pairs[:, 1]`` is the CSR ``col_ind``);
- ``csr.indptr``    int64 ``[n+1]``   CSR row pointers;
- ``csr32.indices`` int32 ``[D]``     the native host solver's columns;
- the optional groups, written only when the snapshot already holds
  them: ``ell.*`` (the serving ELL table), ``blocked.*`` (the tile
  tables), ``oracle.*`` (the landmark ``[n, K]`` distances and ids).

``manifest.json`` binds them: the graph's digest, version, n and edges,
each file's dtype, shape and BLAKE2b, and the scalars that rebuild the
dataclasses.

**Commit: rename last.** Every file lands in a same-directory
``<final>.tmp.<pid>`` directory, flushed and fsynced; the directory is
fsynced, renamed onto the final name, and the parent fsynced. A crash
before the rename leaves a ``*.tmp.*`` orphan that no loader matches;
after it, a whole sidecar. A final directory already present for the
same (version, digest) is kept.

:func:`load_sidecar` maps every file, checks sizes against the manifest
and by default re-hashes the contents. A sidecar that fails a check
raises; the store's recovery then rebuilds from the ``.bin``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np

from bibfs_tpu_torch.store.wal import fsync_dir

SIDECAR_FORMAT = 1

#: sidecar directories (``<name>.v<V>.<digest12>.arrays``) — same
#: shape contract as ``_CKPT_BIN_RE`` in store/registry.py, and like it
#: the digest suffix is REQUIRED for gc eligibility.
ARRAYS_DIR_RE = re.compile(r"\.v(\d+)\.[0-9a-f]{6,32}\.arrays$")

#: hash chunk: big enough to stream at disk bandwidth, small enough to
#: keep the hasher's working set out of the way
_HASH_CHUNK = 1 << 24


def sidecar_dir_name(name: str, snapshot) -> str:
    """``roads.v3.1f2a9c0d4e5b.arrays`` — version + digest prefix, the
    checkpoint-bin naming contract applied to the directory."""
    return f"{name}.v{snapshot.version}.{snapshot.digest[:12]}.arrays"


def _hash_bytes(buf) -> str:
    h = hashlib.blake2b(digest_size=16)
    if getattr(buf, "size", len(buf)) > 0:
        # empty arrays can't cast (zero in shape); their hash is of b""
        mv = memoryview(buf).cast("B")
        for off in range(0, len(mv), _HASH_CHUNK):
            h.update(mv[off:off + _HASH_CHUNK])
    return h.hexdigest()


def _write_array(dirpath: str, fname: str, arr: np.ndarray) -> dict:
    """One raw array file inside the (still-tmp) sidecar directory:
    little-endian C-order bytes, flushed and fsynced. Returns its
    manifest entry."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":  # raw files are little-endian
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    path = os.path.join(dirpath, fname)
    with open(path, "wb") as f:
        arr.tofile(f)
        f.flush()
        os.fsync(f.fileno())
    return {
        "file": fname,
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "blake2b": _hash_bytes(arr),
    }


def _csr_indptr(n: int, pairs: np.ndarray) -> np.ndarray:
    """Row pointers straight from the canonical pairs — deliberately
    NOT ``snapshot.csr()``: the writer must not memoize an O(E) int64
    ``col_ind`` copy into the parent process just to checkpoint it."""
    deg = np.bincount(pairs[:, 0], minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    return row_ptr


def write_sidecar(root, name: str, snapshot, *, oracle_index=None,
                  fire=None) -> str:
    """Write (or keep) the snapshot's arrays sidecar under ``root``.
    Returns the committed directory name (relative to ``root``).
    Idempotent: an already-committed sidecar for this (version, digest)
    is kept as-is — the digest-suffixed name makes it byte-equivalent.

    ``oracle_index`` (a ``LandmarkIndex``) adds the ``oracle.*`` group;
    ``fire`` is the store's fault-injection hook (site
    ``sidecar_rename`` guards the commit point).
    """
    root = os.fspath(root)
    dirname = sidecar_dir_name(name, snapshot)
    final = os.path.join(root, dirname)
    if os.path.isdir(final):
        return dirname
    tmp = f"{final}.tmp.{os.getpid()}"
    try:
        if os.path.isdir(tmp):  # a dead writer's orphan
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        pairs = np.ascontiguousarray(snapshot.pairs, dtype=np.int64)
        arrays = {
            "pairs": _write_array(tmp, "pairs.bin", pairs),
            "csr.indptr": _write_array(
                tmp, "csr_indptr.bin", _csr_indptr(snapshot.n, pairs)
            ),
            # transient int32 copy, dropped as soon as it is on disk
            "csr32.indices": _write_array(
                tmp, "csr32_indices.bin",
                pairs[:, 1].astype(np.int32),
            ),
        }
        meta: dict = {}
        # optional groups: ONLY what the snapshot already materialized
        # (peek the private memos — a checkpoint must never force an
        # O(E) layout build onto the commit path)
        ell = snapshot._ell
        if ell is not None:
            arrays["ell.nbr"] = _write_array(tmp, "ell_nbr.bin", ell.nbr)
            arrays["ell.deg"] = _write_array(tmp, "ell_deg.bin", ell.deg)
            arrays["ell.overflow"] = _write_array(
                tmp, "ell_overflow.bin", ell.overflow
            )
            meta["ell"] = {
                "n": ell.n, "n_pad": ell.n_pad, "width": ell.width,
                "num_edges": ell.num_edges,
            }
        blocked = snapshot._blocked
        if blocked is not None:
            arrays["blocked.tab"] = _write_array(
                tmp, "blocked_tab.bin", blocked.tab
            )
            arrays["blocked.bcol"] = _write_array(
                tmp, "blocked_bcol.bin", blocked.bcol
            )
            arrays["blocked.deg"] = _write_array(
                tmp, "blocked_deg.bin", blocked.deg
            )
            meta["blocked"] = {
                "n": blocked.n, "n_pad": blocked.n_pad,
                "tile": blocked.tile, "nblocks": blocked.nblocks,
                "bwidth": blocked.bwidth,
                "num_edges": blocked.num_edges,
                "nnz_blocks": blocked.nnz_blocks,
            }
        if oracle_index is not None:
            arrays["oracle.dist"] = _write_array(
                tmp, "oracle_dist.bin", oracle_index.dist
            )
            arrays["oracle.landmarks"] = _write_array(
                tmp, "oracle_landmarks.bin", oracle_index.landmarks
            )
            meta["oracle"] = {
                "gen": oracle_index.gen,
                "built_at": oracle_index.built_at,
                "repaired_edges": oracle_index.repaired_edges,
            }
        manifest = {
            "format": SIDECAR_FORMAT,
            "graph": name,
            "digest": snapshot.digest,
            "version": snapshot.version,
            "n": snapshot.n,
            "edges": snapshot.num_edges,
            "arrays": arrays,
            "meta": meta,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(tmp)
        if fire is not None:
            fire("sidecar_rename")
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    fsync_dir(root)
    return dirname


class SidecarMap:
    """A loaded sidecar: the manifest plus read-only ``np.memmap``
    views of every array file. Holding a reference keeps the mappings
    alive; dropping the last reference lets the GC unmap (there is no
    explicit close — in-flight readers of a view must never see their
    buffer yanked, the snapshot-retire contract)."""

    def __init__(self, path: str, manifest: dict,
                 arrays: dict[str, np.ndarray]):
        self.path = path
        self.manifest = manifest
        self.arrays = arrays

    @property
    def digest(self) -> str:
        return str(self.manifest["digest"])

    @property
    def version(self) -> int:
        return int(self.manifest["version"])

    @property
    def n(self) -> int:
        return int(self.manifest["n"])

    def meta(self, group: str) -> dict:
        return self.manifest.get("meta", {}).get(group, {})

    def has(self, *keys: str) -> bool:
        return all(k in self.arrays for k in keys)

    @property
    def mapped_bytes(self) -> int:
        return sum(int(a.nbytes) for a in self.arrays.values())

    def stats(self) -> dict:
        return {
            "path": self.path,
            "digest": self.digest,
            "version": self.version,
            "mapped_bytes": self.mapped_bytes,
            "arrays": sorted(self.arrays),
        }


def load_sidecar(path, *, verify: str = "full") -> SidecarMap:
    """Map a committed sidecar directory read-only.

    ``verify="full"`` (default) re-hashes every file against its
    manifest BLAKE2b — one sequential pass that also pre-faults the
    pages serving will read. ``verify="size"`` checks only byte sizes
    (shape x itemsize vs the file) — the property a torn write cannot
    fake past the rename-last commit, for callers that will content-
    verify another way (recovery re-derives the graph digest from the
    mapped pairs). Any mismatch raises ``ValueError``.
    """
    if verify not in ("full", "size"):
        raise ValueError(f"unknown verify mode {verify!r}")
    path = os.fspath(path)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    fmt = int(manifest.get("format", 0))
    if fmt != SIDECAR_FORMAT:
        raise ValueError(
            f"{path}: sidecar format {fmt} != supported {SIDECAR_FORMAT}"
        )
    arrays: dict[str, np.ndarray] = {}
    for key, spec in manifest["arrays"].items():
        fpath = os.path.join(path, str(spec["file"]))
        dtype = np.dtype(str(spec["dtype"]))
        shape = tuple(int(s) for s in spec["shape"])
        expected = dtype.itemsize * int(np.prod(shape)) if shape else \
            dtype.itemsize
        actual = os.path.getsize(fpath)
        if actual != expected:
            raise ValueError(
                f"{fpath}: {actual} bytes on disk, manifest claims "
                f"{expected} ({dtype.str}{list(shape)})"
            )
        if expected == 0:
            arr = np.zeros(shape, dtype=dtype)
        else:
            arr = np.memmap(fpath, dtype=dtype, mode="r", shape=shape)
        if verify == "full" and expected:
            got = _hash_bytes(arr)
            if got != spec["blake2b"]:
                raise ValueError(
                    f"{fpath}: content hash {got} != manifest "
                    f"{spec['blake2b']} — refusing to map a torn or "
                    "foreign array"
                )
        arrays[key] = arr
    return SidecarMap(path, manifest, arrays)


def remove_sidecar_quiet(path) -> None:
    """Best-effort removal (gc of superseded sidecars + their orphaned
    ``*.tmp.*`` siblings)."""
    try:
        shutil.rmtree(path)
    except OSError:
        pass
