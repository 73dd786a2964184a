"""Device selection: every entry point runs on ``cuda`` unless the caller
asks for the CPU, and never falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a usable card raises
    ``RuntimeError``; only an explicit ``"cpu"`` runs on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch versions on the host"
        )
    return dev
