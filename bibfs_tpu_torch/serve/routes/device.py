"""``route="device"`` — the single-device batched search as a Route: the
counterpart of ``bibfs_tpu/serve/routes/device.py``.

``solve`` is the engine's ``_device_solve``: pad the flush to a batch
rung, resolve the batch mode, note the program identity, run the batch
on the engine's device, then copy the real queries' outputs to the host
once, materialize the results and bank the forests.

Eligibility is the batch crossover plus the device check: batching
amortizes the per-dispatch cost of the card, so an engine on the CPU
(``device="cpu"``) routes every flush to the host unless
``device_batches=True`` forces this route.
"""

from __future__ import annotations

from bibfs_tpu_torch.serve.routes.base import Route


class DeviceRoute(Route):
    """The batched single-device dispatch rung of the ladder."""

    name = "device"
    is_dispatch = True

    def eligible(self, rt, pairs) -> bool:
        return (len(pairs) >= self.engine.flush_threshold
                and self.engine._use_device())

    def solve(self, rt, pairs):
        return self.engine._device_solve(pairs)
