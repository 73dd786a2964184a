"""Versioned graph store: immutable snapshots, live edge updates with
exact overlay answering, and atomic multi-graph hot-swap
(:mod:`bibfs_tpu_torch.store.snapshot`, :mod:`~bibfs_tpu_torch.store.
delta`, :mod:`~bibfs_tpu_torch.store.registry`). With ``wal_dir`` set, a
per-graph write-ahead log (:mod:`~bibfs_tpu_torch.store.wal`) makes every
acked update survive a crash, compactions are checkpoints with an arrays
sidecar (:mod:`~bibfs_tpu_torch.store.sidecar`) that recovery maps, and a
``residency_budget`` demotes idle graphs to the compressed cold tier
(:mod:`bibfs_tpu_torch.graph.compress`)."""

from bibfs_tpu_torch.store.delta import DeltaOverlay, canonical_edge  # noqa: F401
from bibfs_tpu_torch.store.registry import GraphStore  # noqa: F401
from bibfs_tpu_torch.store.sidecar import (  # noqa: F401
    SidecarMap,
    load_sidecar,
    sidecar_dir_name,
    write_sidecar,
)
from bibfs_tpu_torch.store.snapshot import (  # noqa: F401
    GraphSnapshot,
    content_digest,
    next_version,
)
from bibfs_tpu_torch.store.wal import (  # noqa: F401
    DURABLE_METRIC_FAMILIES,
    FSYNC_POLICIES,
    WalWriter,
    read_wal,
    repair_wal,
)
