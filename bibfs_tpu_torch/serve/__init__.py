"""The serving layer: the synchronous micro-batching engine
(:mod:`bibfs_tpu_torch.serve.engine`) and the pipelined one
(:mod:`bibfs_tpu_torch.serve.pipeline`) over the batched device search
and the native host runtime, with shape buckets, a distance/result
cache, fault injection and the resilience ladder, and the
``bibfs-torch-serve`` CLI (:mod:`bibfs_tpu_torch.serve.cli`). The
counterpart of ``bibfs_tpu/serve`` for one inline graph; the graph store
and the network surfaces come with later slices (ROADMAP Queue 1)."""

from bibfs_tpu_torch.serve.buckets import (  # noqa: F401
    DEFAULT_EXEC_CACHE,
    ExecutableCache,
    bucket_batch,
    bucket_rows,
    bucket_shape,
    bucket_width,
    bucketed_ell,
    ell_bucket_key,
)
from bibfs_tpu_torch.serve.cache import DistanceCache  # noqa: F401
from bibfs_tpu_torch.serve.engine import QueryEngine  # noqa: F401
from bibfs_tpu_torch.serve.faults import FaultPlan, InjectedFault  # noqa: F401
from bibfs_tpu_torch.serve.pipeline import (  # noqa: F401
    LatencyHistogram,
    PipelinedQueryEngine,
    QueryTicket,
)
from bibfs_tpu_torch.serve.resilience import (  # noqa: F401
    CircuitBreaker,
    HealthMonitor,
    QueryError,
    RetryPolicy,
)
from bibfs_tpu_torch.store.snapshot import GraphSnapshot  # noqa: F401
