"""The per-query serving-stage histogram of ``bibfs_tpu/obs/dtrace.py``.

Only :func:`stage_histogram` is ported: the engines mint it at
construction so ``bibfs_stage_seconds{stage}`` renders at zero from the
start. Distributed-trace contexts, the span spool and the flight
recorder come with the network surfaces (ROADMAP Queue 1).
"""

from __future__ import annotations

from bibfs_tpu_torch.obs.metrics import REGISTRY

#: the serving stages a query's time is attributed to
STAGES = ("ingress", "queue", "launch", "finish", "resolve", "wire")


def stage_histogram():
    """The per-query cost-attribution histogram, pre-labeled so serving
    never allocates a label cell per query."""
    fam = REGISTRY.histogram(
        "bibfs_stage_seconds",
        "Per-query time in each serving stage "
        "(ingress/queue/launch/finish/resolve/wire)",
        ("stage",),
    )
    return {stage: fam.labels(stage=stage) for stage in STAGES}
