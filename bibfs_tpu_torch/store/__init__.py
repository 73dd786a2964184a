"""Versioned graph store: immutable snapshots, live edge updates with
exact overlay answering, and atomic multi-graph hot-swap
(:mod:`bibfs_tpu_torch.store.snapshot`, :mod:`~bibfs_tpu_torch.store.
delta`, :mod:`~bibfs_tpu_torch.store.registry`)."""

from bibfs_tpu_torch.store.delta import DeltaOverlay, canonical_edge  # noqa: F401
from bibfs_tpu_torch.store.registry import GraphStore  # noqa: F401
from bibfs_tpu_torch.store.snapshot import (  # noqa: F401
    GraphSnapshot,
    content_digest,
    next_version,
)
