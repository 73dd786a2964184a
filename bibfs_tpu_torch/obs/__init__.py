"""Observability: the metrics registry (:mod:`bibfs_tpu_torch.obs.metrics`)
and its canonical family names (:mod:`~bibfs_tpu_torch.obs.names`), the
``/metrics`` and ``/healthz`` endpoint (:mod:`~bibfs_tpu_torch.obs.http`),
in-process tracing spans (:mod:`~bibfs_tpu_torch.obs.trace`), distributed
trace contexts, the span spool, the flight recorder and the serving stage
histogram (:mod:`~bibfs_tpu_torch.obs.dtrace`), and per-level solver
telemetry (:mod:`~bibfs_tpu_torch.obs.telemetry`)."""
