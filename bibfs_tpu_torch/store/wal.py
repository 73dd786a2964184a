"""Per-graph write-ahead log, the durability floor under live updates:
the counterpart of ``bibfs_tpu/store/wal.py``, whose record bytes it
writes and reads exactly, so either package replays the other's log.

:meth:`GraphStore.update <bibfs_tpu_torch.store.GraphStore.update>`
appends a batch here before it commits to the overlay, and acks only
once the record is durable under the fsync policy: an acked update
survives a crash.

**Record format** (little-endian, length-prefixed, CRC-checked)::

    file   := header record*
    header := b"BWAL1\\n"                     (6 bytes)
    record := u32 payload_len | u32 crc32(payload) | payload
    payload:= u64 snapshot_version | u32 n_adds | u32 n_dels
              | n_adds x (u32 u, u32 v) | n_dels x (u32 u, u32 v)

A batch is one record: replay applies it whole or not at all.
:func:`read_wal` stops at the first torn or bad-CRC record; a crash
mid-append leaves a tail that the next open truncates
(:func:`repair_wal`).

**Fsync policy**, what "durable" means for the ack:

- ``always`` — ``os.fsync`` after every append: an acked record survives
  OS or power loss.
- ``batch`` (default) — the record is flushed to the OS on every append
  (it survives process death, SIGKILL included) and fsynced every
  ``batch_records`` appends and at every checkpoint and close.
- ``off`` — flushed to the OS only; fsynced at checkpoint and close.

**Segments.** One graph's log is a sequence of files
``<graph>.wal.<seq>``. A checkpoint captures the overlay under the store
lock and switches to a fresh segment in the same locked section, so a
record is either folded into the checkpoint or replays on top of it.
The manifest names the first segment a recovery replays (``wal_seq``;
``wal_offset`` is always 0), superseded segments are deleted once the
manifest commits, and recovery replays every surviving segment
``>= wal_seq`` in order.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib

from bibfs_tpu_torch.utils.annotations import guarded_by

#: the durability metric families a durable store mints (the JAX
#: package's names, kinds and labels)
DURABLE_METRIC_FAMILIES = (
    "bibfs_wal_records_total",
    "bibfs_wal_fsyncs_total",
    "bibfs_checkpoints_total",
    "bibfs_recovery_replayed_records",
    "bibfs_recovery_seconds",
)

_MAGIC = b"BWAL1\n"
_REC_HEAD = struct.Struct("<II")        # payload_len, crc32
_PAYLOAD_HEAD = struct.Struct("<QII")   # version, n_adds, n_dels

#: fsync policies (module docstring); parse/ctor reject anything else —
#: a typo'd policy must fail loudly, not silently weaken durability
FSYNC_POLICIES = ("always", "batch", "off")


def _encode_record(version: int, adds, dels) -> bytes:
    parts = [_PAYLOAD_HEAD.pack(int(version), len(adds), len(dels))]
    for u, v in adds:
        parts.append(struct.pack("<II", int(u), int(v)))
    for u, v in dels:
        parts.append(struct.pack("<II", int(u), int(v)))
    payload = b"".join(parts)
    return _REC_HEAD.pack(len(payload), zlib.crc32(payload)) + payload


def _decode_payload(payload: bytes):
    version, n_adds, n_dels = _PAYLOAD_HEAD.unpack_from(payload, 0)
    need = _PAYLOAD_HEAD.size + 8 * (n_adds + n_dels)
    if len(payload) != need:
        raise ValueError(
            f"payload length {len(payload)} != declared {need}"
        )
    off = _PAYLOAD_HEAD.size
    adds = [
        struct.unpack_from("<II", payload, off + 8 * i)
        for i in range(n_adds)
    ]
    off += 8 * n_adds
    dels = [
        struct.unpack_from("<II", payload, off + 8 * i)
        for i in range(n_dels)
    ]
    return version, adds, dels


def read_wal(path) -> tuple[list, int, bool]:
    """Replay one segment file. Returns ``(records, good_bytes, torn)``
    where ``records`` is a list of ``(version, adds, dels)`` batches,
    ``good_bytes`` is the byte length of the valid prefix, and ``torn``
    flags a torn/bad-CRC tail after it (replay stops there — the
    records beyond a corrupt point cannot be trusted). A missing file
    reads as empty; a file with a bad magic header reads as torn at
    byte 0 (nothing salvageable)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], 0, False
    if not data.startswith(_MAGIC):
        return [], 0, bool(data)
    records = []
    off = len(_MAGIC)
    while off < len(data):
        if off + _REC_HEAD.size > len(data):
            return records, off, True  # torn record header
        length, crc = _REC_HEAD.unpack_from(data, off)
        end = off + _REC_HEAD.size + length
        if length > len(data) or end > len(data):
            return records, off, True  # torn payload
        payload = data[off + _REC_HEAD.size: end]
        if zlib.crc32(payload) != crc:
            return records, off, True  # bad CRC
        try:
            records.append(_decode_payload(payload))
        except (ValueError, struct.error):
            return records, off, True  # internally inconsistent
        off = end
    return records, off, False


def repair_wal(path) -> tuple[list, bool]:
    """Replay a segment and TRUNCATE any torn/bad-CRC tail in place, so
    subsequent appends extend a provably-valid prefix. Returns
    ``(records, truncated)``."""
    records, good, torn = read_wal(path)
    if torn:
        with open(path, "r+b") as f:
            f.truncate(good)
    return records, torn


@guarded_by("_lock", "records", "fsyncs", "_since_fsync", "_f")
class WalWriter:
    """Append side of one segment file (module docstring format).

    Thread-safe (the store appends under its own lock anyway, but a
    checkpoint's final ``sync()`` may race a closing writer). ``fire``
    is the store's fault-injection hook — called with ``"wal_write"``
    before each append and ``"wal_fsync"`` before each fsync, so a
    chaos plan can fail exactly the seams a dying disk would.
    ``on_record``/``on_fsync`` are metric callbacks (registry counter
    cells in the store)."""

    def __init__(self, path, *, fsync: str = "batch",
                 batch_records: int = 64, fire=None,
                 on_record=None, on_fsync=None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync policy {fsync!r} "
                f"(known: {', '.join(FSYNC_POLICIES)})"
            )
        self.path = os.fspath(path)
        self.fsync = fsync
        self.batch_records = max(int(batch_records), 1)
        self._fire = fire
        self._on_record = on_record
        self._on_fsync = on_fsync
        self._lock = threading.Lock()
        self.records = 0
        self.fsyncs = 0
        self._since_fsync = 0
        self._f = open(self.path, "ab")
        if self._f.tell() == 0:
            self._f.write(_MAGIC)
            self._f.flush()

    def append(self, version: int, adds=(), dels=()) -> None:
        """Append one update batch and make it durable under the active
        policy (module docstring). Raises on write/fsync failure — the
        caller must NOT ack (or commit in-memory state) if this does —
        and ROLLS THE FILE BACK to the pre-append offset first: a
        refused append may leave no bytes behind. Without the rollback
        a post-write fsync failure leaves a valid record the caller was
        told was refused (replayed on recovery, and a retried batch
        then replays as a duplicate the graph refuses wholesale), and a
        partial write leaves a mid-file tear every LATER acked record
        would vanish behind. If even the rollback fails the segment is
        POISONED (closed — subsequent appends raise, so the store
        refuses acks): no log beats a forked one."""
        rec = _encode_record(version, adds, dels)
        with self._lock:
            if self._f.closed:
                raise OSError(
                    f"WAL segment {self.path} poisoned by an earlier "
                    "failed append (or closed); refusing the ack"
                )
            if self._fire is not None:
                self._fire("wal_write")
            pos = self._f.tell()
            try:
                self._f.write(rec)
                self._f.flush()
                if self.fsync == "always" or (
                    self.fsync == "batch"
                    and self._since_fsync + 1 >= self.batch_records
                ):
                    self._fsync_locked()
                else:
                    self._since_fsync += 1
            except BaseException:
                try:
                    self._f.truncate(pos)
                    self._f.seek(pos)
                    self._f.flush()
                except OSError:
                    self._f.close()
                raise
            self.records += 1
            if self._on_record is not None:
                self._on_record()

    def _fsync_locked(self) -> None:
        if self._fire is not None:
            self._fire("wal_fsync")
        os.fsync(self._f.fileno())
        self.fsyncs += 1
        self._since_fsync = 0
        if self._on_fsync is not None:
            self._on_fsync()

    def sync(self) -> None:
        """Force an fsync now (checkpoint/close barrier) regardless of
        policy — except a closed writer, where it is a no-op."""
        with self._lock:
            if not self._f.closed and self._since_fsync:
                self._fsync_locked()

    def close(self) -> None:
        """Close the segment, fsyncing any pending records first under
        EVERY policy — close is the checkpoint/shutdown barrier the
        ``batch``/``off`` policies promise (module docstring): a
        checkpoint's segment switch closes the completed segment, so
        its records are on stable storage before the manifest that
        supersedes them can commit."""
        with self._lock:
            if self._f.closed:
                return
            if self._since_fsync:
                self._fsync_locked()
            self._f.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": os.path.basename(self.path),
                "fsync": self.fsync,
                "records": self.records,
                "fsyncs": self.fsyncs,
            }


def segment_path(wal_dir, name: str, seq: int) -> str:
    return os.path.join(os.fspath(wal_dir), f"{name}.wal.{int(seq)}")


def list_segments(wal_dir, name: str) -> list[tuple[int, str]]:
    """All of ``name``'s segment files, sorted by sequence number."""
    prefix = f"{name}.wal."
    out = []
    for fname in os.listdir(os.fspath(wal_dir)):
        if not fname.startswith(prefix):
            continue
        tail = fname[len(prefix):]
        if tail.isdigit():
            out.append((int(tail), os.path.join(os.fspath(wal_dir), fname)))
    out.sort()
    return out


def fsync_dir(path) -> None:
    """Best-effort directory fsync after an ``os.replace`` — makes the
    rename itself durable on POSIX; harmless where unsupported."""
    try:
        fd = os.open(os.fspath(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
