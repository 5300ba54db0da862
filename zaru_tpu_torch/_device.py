"""Device resolution for the port's entry points.

Every entry point (``FaceTracker``, ``Cnn``, the samplers' callers) takes an
explicit ``device``. Left out, it is ``cuda``; without a GPU that raises
instead of running on the CPU, so a run never drops to the CPU silently.
Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names a device; raises when CUDA is asked
    for (or defaulted to) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
