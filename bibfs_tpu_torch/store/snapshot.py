"""Immutable, versioned graph snapshots: the counterpart of
``bibfs_tpu/store/snapshot.py``.

A :class:`GraphSnapshot` gives a graph a content-addressed identity:

- **digest** — a BLAKE2b hash over ``(n, canonical pairs)``, byte for
  byte the JAX package's :func:`content_digest`, so a snapshot of one
  graph has the same digest in both packages. Two snapshots with the
  same digest are the same graph whatever order the edges arrived in;
  the serving engine namespaces its distance cache by it.
- **version** — a process-wide monotonic stamp.
- **memoized builds** — ``csr()``, ``ell()`` (serving-bucketed),
  ``tiered()`` and ``blocked()`` each build once under a lock and are
  shared by every consumer of the snapshot.
- **refcount retirement** — the creator holds one reference; every
  in-flight flush pins one more (``retain``/``release``). On the last
  release the retire hooks fire and the memoized tables are dropped.

**Memory tiers.** A snapshot lives in one of three:

- ``mapped`` — built by :meth:`GraphSnapshot.from_sidecar` over an arrays
  sidecar (``store/sidecar.py``): ``pairs``, the CSR, the native int32
  columns and any ELL or tile tables are read-only ``np.memmap`` views,
  so processes serving one store directory share one page-cache copy.
  Every consumer that writes copies first (the device uploads copy into
  private tensors). Retirement only drops references: a flush that
  pinned a view keeps a valid buffer until the last holder goes.
- ``hot`` — private in-memory arrays.
- ``cold`` — past the store's residency budget: the adjacency is held
  only as a varint+delta :class:`~bibfs_tpu_torch.graph.compress.
  CompressedCSR` (``demote()``); the next ``pairs`` or ``csr()`` access
  decodes it back, exactly (``promote``). A demote frees host memos only:
  the device tables an engine's runtime uploaded stay on the card, each
  a private copy that no demote can pull from under it.
"""

from __future__ import annotations

import hashlib
import itertools
import threading

import numpy as np

# process-wide monotonic version stamps; also the identity counter of
# snapshots built without a digest (never reused, unlike id())
_VERSIONS = itertools.count(1)
_ANON = itertools.count()

#: digest hash chunk: bounds the hasher's transient working set
_DIGEST_CHUNK = 1 << 24


def next_version() -> int:
    """The next process-wide monotonic snapshot version."""
    return next(_VERSIONS)


def content_digest(n: int, pairs: np.ndarray) -> str:
    """BLAKE2b over ``(n, canonical pairs)`` — the content identity.

    ``pairs`` must already be canonical (mirrored, deduped, sorted —
    :func:`bibfs_tpu_torch.graph.csr.canonical_pairs`), which makes the
    hash insensitive to edge order, duplication and orientation."""
    h = hashlib.blake2b(digest_size=16)
    h.update(str(int(n)).encode())
    h.update(b"|")
    arr = np.ascontiguousarray(pairs, dtype=np.int64)
    mv = memoryview(arr).cast("B") if arr.size else memoryview(b"")
    for off in range(0, len(mv), _DIGEST_CHUNK):
        h.update(mv[off:off + _DIGEST_CHUNK])
    return h.hexdigest()


class GraphSnapshot:
    """One immutable version of one graph (module docstring). Build with
    :meth:`build`; ``digest=None`` at direct construction falls back to a
    process-wide monotonic ``anon-N`` label."""

    def __init__(self, n: int, pairs: np.ndarray, *, digest: str | None = None,
                 version: int | None = None):
        self.n = int(n)
        self._pairs = pairs
        self.digest = f"anon-{next(_ANON)}" if digest is None else str(digest)
        self.version = next_version() if version is None else int(version)
        self.num_edges = int(pairs.shape[0]) // 2
        # re-entrant: a memoized builder holding the lock reads self.pairs,
        # which on a cold snapshot takes it again to promote
        self._lock = threading.RLock()
        self._refs = 1  # the creator's reference
        self._retired = False
        self._retire_hooks: list = []
        self._csr = None
        self._ell = None  # serving-bucketed ELL
        self._tiered = None
        self._blocked = None  # the tile layout (graph/blocked.py)
        # memory tiers (module docstring)
        self._sidecar = None  # the SidecarMap pinning the mapped views
        self._native32 = None  # (row_ptr int64, col_ind int32), mapped
        self._cold = None  # the CompressedCSR once demoted
        self._promotions = 0
        self._demotions = 0

    @property
    def pairs(self) -> np.ndarray:
        """The canonical directed pairs. On a cold snapshot the access is
        the promotion: decode back to hot, exactly. After retirement the
        decode answers without caching."""
        p = self._pairs
        if p is not None:
            return p
        with self._lock:
            if self._pairs is not None:
                return self._pairs
            if self._cold is None:
                raise RuntimeError(
                    f"snapshot {self.digest} has neither pairs nor a "
                    "cold-tier encoding"
                )
            pairs, csr = self._decode_cold()
            if not self._retired:
                self._pairs = pairs
                if self._csr is None:
                    self._csr = csr
                self._promotions += 1
            return pairs

    @pairs.setter
    def pairs(self, value: np.ndarray) -> None:
        self._pairs = value

    def _decode_cold(self):
        """The exact CSR from the cold encoding, and the canonical pairs
        rebuilt from it (canonical order is CSR expansion order)."""
        from bibfs_tpu_torch.graph.compress import decode_csr

        row_ptr, col = decode_csr(self._cold)
        pairs = np.empty((col.shape[0], 2), dtype=np.int64)
        pairs[:, 0] = np.repeat(
            np.arange(self.n, dtype=np.int64), np.diff(row_ptr)
        )
        pairs[:, 1] = col
        return pairs, (row_ptr, col)

    @classmethod
    def build(cls, n: int, edges: np.ndarray | None = None, *,
              pairs: np.ndarray | None = None,
              version: int | None = None) -> "GraphSnapshot":
        """Canonicalize ``edges`` (or adopt precomputed canonical
        ``pairs``) and stamp the content digest and a fresh version."""
        from bibfs_tpu_torch.graph.csr import canonical_pairs

        if pairs is None:
            pairs = canonical_pairs(n, edges)
        return cls(n, pairs, digest=content_digest(n, pairs), version=version)

    @classmethod
    def from_sidecar(cls, smap, *, version: int | None = None,
                     verify_digest: bool = True) -> "GraphSnapshot":
        """A ``mapped``-tier snapshot over a loaded arrays sidecar
        (:func:`bibfs_tpu_torch.store.sidecar.load_sidecar`): pairs, CSR,
        native int32 columns and the ELL and tile tables the sidecar holds
        are read-only memmap views.

        ``verify_digest=True`` recomputes :func:`content_digest` over the
        mapped pairs (a chunked stream, no copy) and raises ``ValueError``
        unless it equals the sidecar's; callers then rebuild."""
        n = smap.n
        pairs = smap.arrays["pairs"]
        if verify_digest:
            got = content_digest(n, pairs)
            if got != smap.digest:
                raise ValueError(
                    f"{smap.path}: mapped pairs digest {got} != sidecar "
                    f"manifest {smap.digest} — refusing to serve a "
                    "mapping that is not the checkpointed graph"
                )
        snap = cls(
            n, pairs, digest=smap.digest,
            version=smap.version if version is None else version,
        )
        snap._sidecar = smap
        indptr = smap.arrays.get("csr.indptr")
        if indptr is not None:
            # col_ind is a strided view of the mapped pairs (canonical order
            # is CSR expansion order); the native solver, which needs a
            # contiguous int32 column, gets the csr32 table
            snap._csr = (indptr, pairs[:, 1])
            c32 = smap.arrays.get("csr32.indices")
            if c32 is not None:
                snap._native32 = (indptr, c32)
        if smap.has("ell.nbr", "ell.deg", "ell.overflow"):
            from bibfs_tpu_torch.graph.csr import EllGraph

            m = smap.meta("ell")
            snap._ell = EllGraph(
                n=int(m["n"]), n_pad=int(m["n_pad"]),
                width=int(m["width"]), num_edges=int(m["num_edges"]),
                nbr=smap.arrays["ell.nbr"], deg=smap.arrays["ell.deg"],
                overflow=smap.arrays["ell.overflow"],
            )
        if smap.has("blocked.tab", "blocked.bcol", "blocked.deg"):
            from bibfs_tpu_torch.graph.blocked import BlockedGraph

            m = smap.meta("blocked")
            snap._blocked = BlockedGraph(
                n=int(m["n"]), n_pad=int(m["n_pad"]),
                tile=int(m["tile"]), nblocks=int(m["nblocks"]),
                bwidth=int(m["bwidth"]), num_edges=int(m["num_edges"]),
                nnz_blocks=int(m["nnz_blocks"]),
                tab=smap.arrays["blocked.tab"],
                bcol=smap.arrays["blocked.bcol"],
                deg=smap.arrays["blocked.deg"],
            )
        return snap

    def oracle_arrays(self):
        """``(landmarks, dist, meta)`` of the sidecar's ``oracle.*`` group
        when this snapshot is mapped from a sidecar that holds one, else
        None."""
        smap = self._sidecar
        if smap is None or not smap.has("oracle.dist", "oracle.landmarks"):
            return None
        return (smap.arrays["oracle.landmarks"], smap.arrays["oracle.dist"],
                smap.meta("oracle"))

    # ---- memoized builds --------------------------------------------
    # Each getter reads the memo into a local before testing it (the fast
    # path races release() dropping the field). A call after retirement
    # builds and returns without caching.
    def _memo(self, attr: str, build):
        t = getattr(self, attr)
        if t is None:
            with self._lock:
                t = getattr(self, attr)
                if t is None:
                    t = build()
                    if not self._retired:
                        setattr(self, attr, t)
        return t

    def csr(self):
        """The ``(row_ptr, col_ind)`` CSR adjacency, built once."""
        from bibfs_tpu_torch.graph.csr import build_csr

        return self._memo("_csr", lambda: build_csr(self.n, pairs=self.pairs))

    def ell(self):
        """The serving-bucketed ELL table
        (:func:`bibfs_tpu_torch.serve.buckets.bucketed_ell`), built once."""
        from bibfs_tpu_torch.serve.buckets import bucketed_ell

        return self._memo("_ell", lambda: bucketed_ell(self.n, pairs=self.pairs))

    def tiered(self):
        """The tiered-ELL layout (power-law graphs), built once."""
        from bibfs_tpu_torch.graph.csr import build_tiered

        return self._memo("_tiered",
                          lambda: build_tiered(self.n, pairs=self.pairs))

    def blocked(self):
        """The blocked tile adjacency
        (:func:`bibfs_tpu_torch.graph.blocked.build_blocked`), built once:
        the blocked route of every engine over this snapshot shares it."""
        from bibfs_tpu_torch.graph.blocked import build_blocked

        return self._memo("_blocked",
                          lambda: build_blocked(self.n, pairs=self.pairs))

    def undirected_edges(self) -> np.ndarray:
        """The ``u < v`` half of the canonical pairs (the native builder
        mirrors internally)."""
        p = self.pairs
        return p[p[:, 0] < p[:, 1]]

    # ---- memory tiers (module docstring) -----------------------------
    def native_csr(self):
        """``(row_ptr int64, col_ind int32)`` in the native solver's format
        when this snapshot is mapped (one page-cache copy per machine),
        else None: the host route then builds its own
        :class:`~bibfs_tpu_torch.solvers.native.NativeGraph`."""
        return self._native32

    @property
    def tier(self) -> str:
        """``mapped`` / ``hot`` / ``cold`` (module docstring)."""
        if self._sidecar is not None:
            return "mapped"
        if self._pairs is None and self._cold is not None:
            return "cold"
        return "hot"

    def demote(self) -> int:
        """Move a ``hot`` snapshot to the ``cold`` tier: encode its CSR and
        drop the resident arrays (the pairs too: they decode back
        exactly). Returns the resident bytes freed (0 when cold, mapped or
        retired already). The encode runs off the snapshot's lock."""
        with self._lock:
            if (self._retired or self._sidecar is not None
                    or self._pairs is None):
                return 0
            before = self.resident_bytes()
            cold = self._cold
        if cold is None:
            from bibfs_tpu_torch.graph.compress import encode_csr

            cold = encode_csr(*self.csr())
        with self._lock:
            if self._retired or self._pairs is None:
                return 0
            self._cold = cold
            self._pairs = None
            self._csr = self._ell = self._tiered = self._blocked = None
            self._native32 = None
            self._demotions += 1
            return max(before - self.resident_bytes(), 0)

    def promote(self) -> bool:
        """Decode a ``cold`` snapshot back to ``hot`` now (a ``pairs`` or
        ``csr()`` access does it too). True iff a decode happened."""
        with self._lock:
            if self._pairs is not None or self._cold is None:
                return False
            return self.pairs is not None  # the property decodes and caches

    @staticmethod
    def _owned_bytes(obj) -> int:
        """Private resident bytes of one memo; memmap views are page
        cache, counted by :meth:`mapped_bytes` instead."""
        if obj is None:
            return 0
        if isinstance(obj, np.ndarray):
            return 0 if isinstance(obj, np.memmap) else int(obj.nbytes)
        if isinstance(obj, tuple):
            return sum(GraphSnapshot._owned_bytes(o) for o in obj)
        total = 0
        for f in ("nbr", "deg", "overflow", "tab", "bcol",
                  "row_ptr", "data"):
            a = getattr(obj, f, None)
            if isinstance(a, np.ndarray) and not isinstance(a, np.memmap):
                total += int(a.nbytes)
        return total

    def resident_bytes(self) -> int:
        """Process-private bytes this snapshot pins: pairs, memoized tables
        and the cold encoding (mapped views excluded)."""
        return sum(self._owned_bytes(o) for o in (
            self._pairs, self._csr, self._ell, self._tiered,
            self._blocked, self._native32, self._cold,
        ))

    def mapped_bytes(self) -> int:
        """Bytes of sidecar arrays this snapshot keeps mapped (shared and
        page-cache-backed)."""
        return 0 if self._sidecar is None else self._sidecar.mapped_bytes

    def memory(self) -> dict:
        return {
            "tier": self.tier,
            "resident_bytes": self.resident_bytes(),
            "mapped_bytes": self.mapped_bytes(),
            "cold_bytes": self._owned_bytes(self._cold),
            "promotions": self._promotions,
            "demotions": self._demotions,
        }

    # ---- refcount retirement ----------------------------------------
    def retain(self) -> "GraphSnapshot":
        with self._lock:
            if self._retired:
                raise RuntimeError(
                    f"snapshot {self.digest} v{self.version} already retired"
                )
            self._refs += 1
        return self

    def release(self) -> bool:
        """Drop one reference; on the last one, retire: free the memoized
        tables and fire the hooks. True iff this call retired it."""
        with self._lock:
            self._refs -= 1
            if self._refs > 0 or self._retired:
                return False
            self._retired = True
            hooks, self._retire_hooks = self._retire_hooks, []
            # the canonical pairs (or the cold encoding) stay: the digest
            # and stats() read them; the built tables are the memory owners.
            # Mapped views are only dropped, never unmapped: a flush that
            # pinned one keeps a valid buffer until the last holder goes
            self._csr = self._ell = self._tiered = self._blocked = None
            self._native32 = None
            self._sidecar = None
        for hook in hooks:
            try:
                hook(self)
            except Exception:
                pass  # a broken hook must not break the releasing flush
        return True

    def on_retire(self, hook) -> None:
        """Run ``hook(snapshot)`` at retirement (now, if already retired)."""
        with self._lock:
            if not self._retired:
                self._retire_hooks.append(hook)
                return
        hook(self)

    @property
    def refs(self) -> int:
        with self._lock:
            return self._refs

    @property
    def retired(self) -> bool:
        with self._lock:
            return self._retired

    def stats(self) -> dict:
        return {
            "n": self.n,
            "edges": self.num_edges,
            "digest": self.digest,
            "version": self.version,
            "refs": self.refs,
            "tier": self.tier,
        }

    def __repr__(self) -> str:
        return (f"GraphSnapshot(n={self.n}, edges={self.num_edges}, "
                f"digest={self.digest[:12]}, version={self.version})")
