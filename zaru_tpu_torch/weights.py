"""Parameters from the JAX package.

``params_from_jax`` turns ``zaru_tpu`` ``FaceTracker.params``
(``{"det": {...}, "lm": {...}}`` and, for an iris tracker, ``"eye"``: f32
arrays keyed by ONNX initializer name, zaru_tpu/pipeline/face_cascade.py:
125-130) or ``MultiObjectTracker.params`` (multi_object.py:87, the same
``{"det", "lm"}`` form) into the port's parameters, which the trackers'
``params=`` accepts, so that both packages compute with the same weights. Any array that converts with ``np.asarray`` is accepted; the
JAX package itself is not imported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(tracker_params: dict) -> dict:
    """``{"det": {name: array}, "lm": {name: array}[, "eye": ...]}`` → the
    same dicts of f32 CPU tensors; the trackers copy them to their
    device."""
    out = {}
    for net in ("det", "lm", "eye") if "eye" in tracker_params else ("det", "lm"):
        out[net] = {}
        for name, value in tracker_params[net].items():
            arr = np.asarray(value)
            if arr.dtype != np.float32:
                raise ValueError(f"{net}/{name}: expected float32, got {arr.dtype}")
            out[net][name] = torch.from_numpy(np.array(arr))
    return out
