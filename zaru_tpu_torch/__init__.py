"""zaru_tpu_torch: the PyTorch/CUDA port of zaru_tpu for NVIDIA Hopper.

A second package beside ``zaru_tpu``, which stays the reference: this one
imports ``torch`` and numpy, never ``jax`` and nothing of ``zaru_tpu``. Its
module names mirror the JAX package's, and each module's docstring names
its counterpart there. Entry points run on ``cuda`` unless the caller
passes another ``device`` (the tests pass ``device="cpu"``); without a GPU
they raise rather than fall back to the CPU.

Ported so far: the batch-gated ``FaceTracker`` main path, with hand-written
CUDA kernels for the rotated-ROI and letterbox samplers
(``zaru_tpu_torch/csrc``).
"""

from ._device import resolve_device
from .pipeline import FaceTracker

__all__ = ["FaceTracker", "resolve_device"]
