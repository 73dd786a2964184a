"""The serving layer: the synchronous micro-batching engine
(:mod:`bibfs_tpu_torch.serve.engine`) and the pipelined one
(:mod:`bibfs_tpu_torch.serve.pipeline`) over the batched device search
and the native host runtime, with shape buckets, a distance/result
cache, fault injection and the resilience ladder, the network front door
(:mod:`bibfs_tpu_torch.serve.net`) and the ``bibfs-torch-serve`` CLI
(:mod:`bibfs_tpu_torch.serve.cli`): the counterpart of
``bibfs_tpu/serve``. The fleet of replicas behind a router is
:mod:`bibfs_tpu_torch.fleet` (``bibfs-torch-fleet``), and its soak is
:func:`bibfs_tpu_torch.serve.loadgen.run_fleet`."""

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
