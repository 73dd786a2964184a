"""Graph snapshots (:mod:`bibfs_tpu_torch.store.snapshot`)."""

from bibfs_tpu_torch.store.snapshot import GraphSnapshot, content_digest  # noqa: F401
