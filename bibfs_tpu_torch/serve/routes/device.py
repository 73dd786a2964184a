"""``route="device"`` — the single-device batched search as a Route: the
counterpart of ``bibfs_tpu/serve/routes/device.py``.

``launch`` is the engine's ``_device_launch``: pad the flush to a batch
rung, resolve the batch mode, note the program identity, run the batch
on the engine's device with its finish hook (the minor8 slot decode and
capped-query refill), and copy the real queries' outputs to the host
once. ``finish`` is ``_device_finish``: materialize the results and
bank the forests from those host copies, touching no tensor on the
card. ``solve`` is the engine's ``_device_solve``, the two in turn (the
synchronous engine's seam).

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

    def launch(self, rt, pairs):
        return self.engine._device_launch(pairs)

    def finish(self, out, fin, t0, pairs):
        return self.engine._device_finish(out, fin, t0, pairs)

    def solve(self, rt, pairs):
        return self.engine._device_solve(pairs)
