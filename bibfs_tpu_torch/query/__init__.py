"""Typed queries (:mod:`bibfs_tpu_torch.query.types`)."""
