"""zaru_tpu_torch: the PyTorch/CUDA port of zaru_tpu for NVIDIA Hopper.

A second package beside ``zaru_tpu``, which stays the reference: this one
imports ``torch`` and numpy, never ``jax`` and nothing of ``zaru_tpu``. Its
module names mirror the JAX package's, and each module's docstring names
its counterpart there. Entry points run on ``cuda`` unless the caller
passes another ``device`` (the tests pass ``device="cpu"``); without a GPU
they raise rather than fall back to the CPU.

Ported so far: the batch-gated ``FaceTracker`` (with iris and bounded
redetection), ``MultiFaceTracker`` and ``MultiHandTracker``, with
hand-written CUDA kernels for every TPU kernel of the JAX package
(``zaru_tpu_torch/csrc``).
"""

from ._device import resolve_device
from .pipeline import FaceTracker, MultiFaceTracker, MultiHandTracker

__all__ = ["FaceTracker", "MultiFaceTracker", "MultiHandTracker", "resolve_device"]
