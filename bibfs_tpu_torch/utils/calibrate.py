"""The reading half of the hardware calibration: ``calibration.json``'s
block for the platform a search runs on.

The file, its place (the working directory, then the repository root) and
the ``BIBFS_CALIBRATION`` override are those of
``bibfs_tpu/utils/calibrate.py``, so both packages read the same numbers.
Blocks are keyed by platform: ``cpu`` for tensors on the host, ``cuda``
for tensors on the card. A block measured by a degraded probe (a cached
dispatch slower than :data:`DEGRADED_DISPATCH_US`) is refused, as the
reference refuses it: its consumers fall back to their uncalibrated
rules. This module measures nothing.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

CAL_ENV = "BIBFS_CALIBRATION"
CAL_FILENAME = "calibration.json"
DEGRADED_DISPATCH_US = 1000.0
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


@lru_cache(maxsize=None)
def _read_file(override: str | None, cwd: str) -> dict:
    """The first readable calibration file: the override when set, else
    ``calibration.json`` in ``cwd`` and then at the repository root."""
    candidates = [override] if override else [
        os.path.join(cwd, CAL_FILENAME),
        os.path.join(_REPO_ROOT, CAL_FILENAME),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            try:
                with open(cand) as f:
                    return json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
    return {}


def clear_cache() -> None:
    """Forget the files read so far (after one was rewritten)."""
    _read_file.cache_clear()


def degraded(entry: dict) -> bool:
    """Whether the block was measured by a degraded probe."""
    try:
        return float(entry.get("dispatch_cached_us", 0.0)) > DEGRADED_DISPATCH_US
    except (TypeError, ValueError):
        return False


def load_calibration(platform: str) -> dict | None:
    """The calibration block of ``platform`` (``"cpu"`` or ``"cuda"``), or
    None when there is none or it is degraded."""
    entry = _read_file(os.environ.get(CAL_ENV), os.getcwd()).get(platform)
    if not isinstance(entry, dict) or degraded(entry):
        return None
    return entry
