"""Immutable, versioned graph snapshots: the counterpart of
``bibfs_tpu/store/snapshot.py`` (its in-memory tier).

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

Memory tiers (``demote``/``promote``) and arrays sidecars come with the
durability slice of the port (ROADMAP Queue 1, item 6b): every snapshot
here is in the ``hot`` tier, and :meth:`GraphSnapshot.native_csr`
always returns None (the host route builds its own native CSR).
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
        self.pairs = pairs
        self.digest = f"anon-{next(_ANON)}" if digest is None else str(digest)
        self.version = next_version() if version is None else int(version)
        self.num_edges = int(pairs.shape[0]) // 2
        self._lock = threading.Lock()
        self._refs = 1  # the creator's reference
        self._retired = False
        self._retire_hooks: list = []
        self._csr = None
        self._ell = None  # serving-bucketed ELL
        self._tiered = None
        self._blocked = None  # the tile layout (graph/blocked.py)

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

    def native_csr(self):
        """The native solver's CSR from a mapped arrays sidecar; sidecars
        come with the durability slice, so this is always None and the
        host route builds its own :class:`~bibfs_tpu_torch.solvers.native.
        NativeGraph`."""
        return None

    @property
    def tier(self) -> str:
        """The memory tier: always ``hot`` (private in-memory arrays) until
        the durability slice brings the mapped and cold tiers."""
        return "hot"

    def mapped_bytes(self) -> int:
        """Sidecar bytes this snapshot keeps mapped: none in this tier."""
        return 0

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
            # the canonical pairs stay (the digest and stats() read them);
            # the built tables are the memory owners
            self._csr = self._ell = self._tiered = self._blocked = None
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
