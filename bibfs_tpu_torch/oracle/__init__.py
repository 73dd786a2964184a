"""Landmark distance-oracle tier: the counterpart of ``bibfs_tpu/oracle``.

A small precomputed structure (K landmark BFS trees per graph state)
answers most queries at lookup speed and hands the rest a proven upper
bound the host search uses as a cutoff:

- :mod:`bibfs_tpu_torch.oracle.landmarks` — deterministic landmark
  selection (degree-seeded, then farthest-point batches);
- :mod:`bibfs_tpu_torch.oracle.trees` — the K-source sweep (the NumPy
  host sweep, or :mod:`bibfs_tpu_torch.ops.msbfs_device` on a device),
  the immutable :class:`LandmarkIndex` and its exact adds-only repair;
- :mod:`bibfs_tpu_torch.oracle.oracle` — :class:`DistanceOracle`, the
  per-query consult (``landmark`` / ``tight`` / ``disconnected`` exact,
  ``bounds`` arms a cutoff, ``miss`` falls through).

The lifecycle (background builds, repair, follow-the-graph swaps) lives
in :class:`bibfs_tpu_torch.store.GraphStore`; routing in the engines.
"""

from bibfs_tpu_torch.oracle.landmarks import select_landmarks  # noqa: F401
from bibfs_tpu_torch.oracle.oracle import (  # noqa: F401
    ORACLE_SERVED_KINDS,
    DistanceOracle,
    OracleAnswer,
    oracle_cells,
)
from bibfs_tpu_torch.oracle.trees import (  # noqa: F401
    LandmarkIndex,
    build_index,
    multi_source_bfs,
    multi_source_dist,
)
