"""Shared search-timing protocol: build once, warm up once (kernel build
and first touch excluded), then time ``repeats`` searches with execution
forced inside every timed interval, and report the median.

On a CUDA device each interval is a pair of CUDA events around the
dispatch plus ``torch.cuda.synchronize()``: PyTorch returns before the
device finishes, so a host clock without a synchronize measures the
enqueue. On the CPU the interval is ``time.perf_counter``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from bibfs_tpu_torch.solvers.api import BFSResult


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def force_scalar(out) -> None:
    """Wait until the device work behind ``out`` has finished: synchronize
    the CUDA device of its first tensor (nothing to wait for on the CPU or
    for plain Python values)."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def timed_repeats(
    dispatch: Callable[[], object],
    materialize: Callable[[], BFSResult] | None,
    repeats: int,
    force: Callable[[object], None] | None = force_scalar,
    device=None,
) -> tuple[list[float], BFSResult | None]:
    """Warm up, then time ``repeats`` calls of ``dispatch`` with ``force``
    applied inside each interval, then call ``materialize`` once (skipped
    when None). ``device`` selects CUDA-event timing when it is a CUDA
    device. Returns ``(times_s, result)`` with ``result.time_s`` = median.
    """
    times, _ = timed_batch_repeats(dispatch, repeats, force, device)
    if materialize is None:
        return times, None
    result = materialize()
    return times, dataclasses.replace(result, time_s=float(np.median(times)))


def timed_batch_repeats(
    dispatch: Callable[[], object],
    repeats: int,
    force: Callable[[object], None] | None = force_scalar,
    device=None,
) -> tuple[list[float], object]:
    """The batch form of :func:`timed_repeats`: warm up once, then time
    ``repeats`` whole-batch dispatches with execution forced inside every
    interval, and return ``(times_s, last_out)`` so the caller materializes
    the last output once."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    cuda = device is not None and torch.device(device).type == "cuda"
    out = dispatch()
    if force is not None:
        force(out)
    times = []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = dispatch()
            if force is not None:
                force(out)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = dispatch()
            if force is not None:
                force(out)
            times.append(time.perf_counter() - t0)
    return times, out
