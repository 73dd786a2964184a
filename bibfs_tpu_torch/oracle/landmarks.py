"""Deterministic landmark selection, degree-seeded then farthest-point:
the counterpart of ``bibfs_tpu/oracle/landmarks.py``.

The first batch is the highest-degree vertices (shortest paths funnel
through the high-degree core, and hot traffic hammers exactly those
endpoints); every later batch takes the vertices farthest from all
landmarks chosen so far, which also lands landmarks in uncovered
components. Ties break by degree, then vertex id, so selection is
deterministic and equal to the reference's. Each batch is one packed
multi-source sweep, and its distance rows are the index's columns, so
selection and construction share every traversal. ``seed`` is accepted
for the reference's interface; selection ignores it.
"""

from __future__ import annotations

import numpy as np

from bibfs_tpu_torch.oracle.trees import device_csr, multi_source_dist

_UNREACHED = np.int64(1 << 40)  # farther than any real distance


def select_landmarks(n: int, row_ptr: np.ndarray, col_ind: np.ndarray,
                     k: int, *, seed: int = 0, chunk: int | None = None,
                     return_dist: bool = False, device=None):
    """Pick ``min(k, n)`` landmark vertices (module docstring), sweeping
    on ``device`` (:func:`~bibfs_tpu_torch.oracle.trees.multi_source_dist`:
    default ``cuda``; ``"host"`` the NumPy sweep).

    ``chunk`` is the sweep batch and the size of the first, purely
    degree-ranked batch (default ``max(8, k // 2)``). Returns the
    ``int64`` landmarks, or ``(landmarks, dist)`` with the ``int16 [n,
    K]`` plane when ``return_dist=True``."""
    k = int(min(int(k), n))
    if k < 1:
        raise ValueError(f"need at least 1 landmark, got {k}")
    if chunk is None:
        chunk = max(8, k // 2)
    del seed  # reserved (module docstring)
    deg = (row_ptr[1:] - row_ptr[:-1]).astype(np.int64)
    csr = device_csr(row_ptr, col_ind, device)  # one upload for every batch
    tie = np.arange(n)
    chosen: list[int] = []
    cols: list[np.ndarray] = []
    taken = np.zeros(n, dtype=bool)
    # min distance to any chosen landmark; unreached sorts farthest
    mindist = np.full(n, _UNREACHED, dtype=np.int64)
    while len(chosen) < k:
        want = min(int(chunk), k - len(chosen))
        # farthest first, then degree, then id (np.lexsort keys are
        # least-significant first)
        score = np.where(taken, np.int64(-1), mindist)
        order = np.lexsort((tie, -deg, -score))
        batch = order[:want]
        batch = batch[score[batch] >= 0]  # never re-pick a landmark
        if batch.size == 0:
            break  # fewer vertices than requested landmarks
        taken[batch] = True
        chosen.extend(int(v) for v in batch)
        d = multi_source_dist(n, *csr, batch, device=device)
        cols.append(d)
        d64 = np.where(d < 0, _UNREACHED, d.astype(np.int64))
        np.minimum(mindist, d64.min(axis=1), out=mindist)
    landmarks = np.asarray(chosen, dtype=np.int64)
    if not return_dist:
        return landmarks
    dist = (np.concatenate(cols, axis=1) if cols
            else np.zeros((n, 0), dtype=np.int16))
    return landmarks, dist
