"""Landmark distance vectors from one bitmask-packed multi-source BFS: the
counterpart of ``bibfs_tpu/oracle/trees.py``.

K landmark searches ride one level-synchronous pass, each vertex carrying
a packed reach mask, so all K BFS trees cost one traversal per distinct
level. The result is the ``K x n`` landmark distance matrix, stored
vertex-major as ``int16 [n, K]`` (a query's two lookups are row reads;
``-1`` is unreachable).

- :func:`multi_source_bfs` is the NumPy host sweep (``uint64`` words);
- :func:`multi_source_dist` runs the sweep on a device through
  :mod:`bibfs_tpu_torch.ops.msbfs_device` (by default ``cuda``: the
  hand-written CUDA level on the card), or the host sweep when asked for
  with ``device="host"``. A device sweep that fails raises: it never
  falls back to the host sweep.

A :class:`LandmarkIndex` is immutable once built and keyed by its base
snapshot's digest plus the store's live-graph generation (``gen``), so a
stale index is refused by one integer compare. :meth:`LandmarkIndex.
repair_adds` folds adds-only update batches in exactly (edge inserts only
decrease distances, so a decrease-only relaxation from the inserted
endpoints lands on the rebuild's distances); a delete invalidates the
index until the next compaction rebuild.
"""

from __future__ import annotations

import time

import numpy as np

# "unreachable" while relaxing in int32 (+1 cannot wrap; above any level)
_INF32 = np.int32(1 << 30)

#: the ``device`` value that asks for the NumPy host sweep
HOST = "host"


def _as_int16_dist(d32: np.ndarray) -> np.ndarray:
    out = np.where(d32 >= _INF32, np.int32(-1), d32)
    if d32.size and int(out.max(initial=0)) > np.iinfo(np.int16).max:
        raise ValueError("graph diameter exceeds int16 distance range")
    return out.astype(np.int16)


def multi_source_bfs(n: int, row_ptr: np.ndarray, col_ind: np.ndarray,
                     sources) -> np.ndarray:
    """All ``len(sources)`` BFS distance vectors in one host pass.

    Returns ``int16 [n, K]`` (``-1`` = unreachable). Each vertex carries a
    packed ``uint64`` reach mask; a level scatters every frontier vertex's
    newly gained bits to its neighbours with one ``bitwise_or.at``, so a
    level costs O(frontier edges) however many searches are live."""
    sources = np.asarray(sources, dtype=np.int64).ravel()
    k = int(sources.size)
    if k == 0:
        return np.zeros((n, 0), dtype=np.int16)
    if int(sources.min()) < 0 or int(sources.max()) >= n:
        raise ValueError(f"landmark out of range for n={n}")
    words = -(-k // 64)
    mask = np.zeros((n, words), dtype=np.uint64)
    dist = np.full((n, k), _INF32, dtype=np.int32)
    bit_word = (np.arange(k) // 64).astype(np.int64)
    bit_val = (np.uint64(1) << (np.arange(k, dtype=np.uint64) % np.uint64(64)))
    np.bitwise_or.at(mask, (sources, bit_word), bit_val)
    dist[sources, np.arange(k)] = 0
    # pending = bits each vertex gained last level (what it must push)
    pending = np.zeros_like(mask)
    pending[sources] = mask[sources]
    frontier = np.unique(sources)
    level = 0
    while frontier.size:
        level += 1
        starts = row_ptr[frontier]
        counts = row_ptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        offs = np.cumsum(counts) - counts
        src_pos = np.repeat(np.arange(frontier.size), counts)
        gather = (np.arange(total, dtype=np.int64) - offs[src_pos]
                  + starts[src_pos])
        neigh = col_ind[gather]
        # restricted to the rows this level can touch: a full-matrix
        # accumulate would cost O(n * words) per level
        touched = np.unique(neigh)
        pos = np.searchsorted(touched, neigh)
        acc = np.zeros((touched.size, words), dtype=np.uint64)
        np.bitwise_or.at(acc, pos, pending[frontier[src_pos]])
        new = acc & ~mask[touched]
        gained = new.any(axis=1)
        if not gained.any():
            break
        rows = touched[gained]
        newbits = new[gained]
        mask[rows] |= newbits
        # this level's arrivals into the distance matrix in one pass:
        # little-endian bit explosion of the gained words
        bits = np.unpackbits(
            newbits.view(np.uint8).reshape(rows.size, words * 8),
            axis=1, bitorder="little",
        )[:, :k]
        rr, jj = np.nonzero(bits)
        dist[rows[rr], jj] = level
        # pending is zero outside the live frontier: clear last level's
        # rows, stamp this level's
        pending[frontier] = 0
        pending[rows] = newbits
        frontier = rows
    return _as_int16_dist(dist)


def device_csr(row_ptr, col_ind, device=None):
    """The CSR where the sweeps on ``device`` read it: the host arrays for
    ``device="host"``, else the tensors on the device
    (:func:`bibfs_tpu_torch.ops.msbfs_device.upload_csr`), uploaded once
    for every sweep of a build."""
    if device == HOST:
        return row_ptr, col_ind
    from bibfs_tpu_torch.ops.msbfs_device import upload_csr

    return upload_csr(row_ptr, col_ind, device)


def multi_source_dist(n: int, row_ptr, col_ind, sources, *, device=None,
                      stats: dict | None = None) -> np.ndarray:
    """One packed K-source sweep on ``device``
    (:func:`bibfs_tpu_torch.ops.msbfs_device.msbfs_plane_csr`: default
    ``cuda``, the CUDA kernel on the card; ``"cpu"`` its plain torch
    twin), or the NumPy host sweep for ``device="host"``. The CSR is host
    arrays or, for a device sweep, :func:`device_csr`'s tensors. The
    output is the same ``int16 [n, K]`` either way. A device sweep that
    fails raises; there is no host fallback. ``stats`` receives a device
    sweep's levels, launches and host reads."""
    if device == HOST:
        return multi_source_bfs(n, row_ptr, col_ind, sources)
    from bibfs_tpu_torch.ops.msbfs_device import msbfs_plane_csr

    return msbfs_plane_csr(n, row_ptr, col_ind, sources, device=device,
                           stats=stats)


class LandmarkIndex:
    """The K landmark distance vectors of one graph state (module
    docstring). Immutable once built: repair returns a new index.

    - ``landmarks``: ``int64 [K]`` vertex ids, selection order;
    - ``dist``: ``int16 [n, K]``, vertex-major; ``-1`` = unreachable;
    - ``digest``/``version``: the base snapshot's identity;
    - ``gen``: the store's live-graph generation this index describes;
    - ``repaired_edges``: adds folded in since the last full build.
    """

    __slots__ = ("n", "landmarks", "dist", "digest", "version", "gen",
                 "built_at", "repaired_edges", "lm_col", "dist32")

    #: "unreachable" in the consult path's ``dist32``: far above any int16
    #: distance, and twice it still fits int32
    CONSULT_INF = np.int32(1 << 20)

    def __init__(self, n: int, landmarks: np.ndarray, dist: np.ndarray, *,
                 digest: str = "anon", version: int = 0, gen: int = 0,
                 built_at: float | None = None, repaired_edges: int = 0):
        self.n = int(n)
        self.landmarks = np.asarray(landmarks, dtype=np.int64)
        self.dist = dist
        # the consult reads this: int32 with unreachable as CONSULT_INF, so
        # a row sum needs no reachability mask before the min
        self.dist32 = np.where(
            dist < 0, self.CONSULT_INF, dist.astype(np.int32)
        )
        self.digest = str(digest)
        self.version = int(version)
        self.gen = int(gen)
        self.built_at = time.time() if built_at is None else float(built_at)
        self.repaired_edges = int(repaired_edges)
        # landmark vertex -> its column: an endpoint that is a landmark is
        # answered by one cell
        self.lm_col = {int(v): i for i, v in enumerate(self.landmarks)}

    @classmethod
    def from_arrays(cls, n: int, landmarks, dist, *, digest: str = "anon",
                    version: int = 0, gen: int = 0) -> "LandmarkIndex":
        """An index over given arrays (numpy): ``landmarks`` ``[K]`` and the
        ``int16 [n, K]`` plane, e.g. another builder's index of the same
        graph. Shapes and types are checked; the arrays are copied."""
        landmarks = np.array(landmarks, dtype=np.int64).ravel()
        dist = np.array(dist)
        if dist.dtype != np.int16 or dist.shape != (int(n), landmarks.size):
            raise ValueError(
                f"dist must be int16 [{int(n)}, {landmarks.size}], got "
                f"{dist.dtype} {list(dist.shape)}"
            )
        if landmarks.size and (int(landmarks.min()) < 0
                               or int(landmarks.max()) >= int(n)):
            raise ValueError(f"landmark out of range for n={int(n)}")
        return cls(n, landmarks, dist, digest=digest, version=version, gen=gen)

    @property
    def k(self) -> int:
        return int(self.landmarks.size)

    def is_landmark(self, v: int) -> bool:
        return v in self.lm_col

    def repair_adds(self, row_ptr, col_ind, add_adj: dict, new_adds, *,
                    gen: int | None = None) -> "LandmarkIndex":
        """The index for this graph state plus ``new_adds``, exactly.

        ``row_ptr``/``col_ind`` is the base snapshot's CSR and ``add_adj``
        the overlay's full add adjacency (``new_adds`` included): the
        post-batch live graph. The overlay must hold no pending deletes.
        A decrease-only relaxation seeded at the inserted endpoints, run
        to its fixpoint, lands on the distances a fresh sweep from the
        same landmarks computes."""
        d = np.where(self.dist < 0, _INF32, self.dist.astype(np.int32))
        frontier: set[int] = set()
        for u, v in new_adds:
            for a, b in ((int(u), int(v)), (int(v), int(u))):
                cand = d[a] + 1
                if (cand < d[b]).any():
                    np.minimum(d[b], cand, out=d[b])
                    frontier.add(b)
        while frontier:
            nxt: set[int] = set()
            for w in frontier:
                nbrs = col_ind[row_ptr[w]: row_ptr[w + 1]]
                extra = add_adj.get(w)
                if extra:
                    nbrs = np.concatenate(
                        [nbrs, np.asarray(extra, dtype=nbrs.dtype)]
                    )
                if nbrs.size == 0:
                    continue
                cand = d[w] + 1
                sub = d[nbrs]
                newsub = np.minimum(sub, cand[None, :])
                chg = (newsub < sub).any(axis=1)
                if chg.any():
                    # duplicate neighbour rows scatter identical values
                    d[nbrs[chg]] = newsub[chg]
                    nxt.update(int(x) for x in nbrs[chg])
            frontier = nxt
        return LandmarkIndex(
            self.n, self.landmarks, _as_int16_dist(d),
            digest=self.digest, version=self.version,
            gen=self.gen + 1 if gen is None else gen,
            repaired_edges=self.repaired_edges + len(list(new_adds)),
        )

    def stats(self) -> dict:
        return {
            "k": self.k,
            "n": self.n,
            "digest": self.digest,
            "version": self.version,
            "gen": self.gen,
            "repaired_edges": self.repaired_edges,
            "age_s": round(time.time() - self.built_at, 3),
            "bytes": int(self.dist.nbytes),
        }

    def __repr__(self) -> str:
        return (f"LandmarkIndex(k={self.k}, n={self.n}, "
                f"digest={self.digest[:12]}, gen={self.gen})")


def build_index(n: int, row_ptr: np.ndarray, col_ind: np.ndarray,
                k: int, *, seed: int = 0,
                landmarks: np.ndarray | None = None,
                digest: str = "anon", version: int = 0,
                gen: int = 0, device=None) -> LandmarkIndex:
    """Select landmarks (unless given) and build their distance matrix,
    every sweep on ``device`` (:func:`multi_source_dist`: default
    ``cuda``; ``"host"`` the NumPy sweep). With ``landmarks=``
    this is one sweep; without, selection
    (:func:`bibfs_tpu_torch.oracle.landmarks.select_landmarks`) sweeps in
    batches and its rows are the index's columns."""
    from bibfs_tpu_torch.oracle.landmarks import select_landmarks

    if landmarks is None:
        landmarks, dist = select_landmarks(
            n, row_ptr, col_ind, k, seed=seed, return_dist=True,
            device=device,
        )
    else:
        landmarks = np.asarray(landmarks, dtype=np.int64)
        dist = multi_source_dist(n, row_ptr, col_ind, landmarks, device=device)
    return LandmarkIndex(n, landmarks, dist, digest=digest,
                         version=version, gen=gen)
