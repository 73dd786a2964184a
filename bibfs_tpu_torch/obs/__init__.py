"""Observability: the metrics registry, tracing spans and the serving
stage histogram (:mod:`bibfs_tpu_torch.obs.metrics`,
:mod:`~bibfs_tpu_torch.obs.trace`, :mod:`~bibfs_tpu_torch.obs.dtrace`)."""
