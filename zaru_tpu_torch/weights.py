"""Parameters from the JAX package.

``params_from_jax`` turns ``zaru_tpu`` ``FaceTracker.params``
(``{"det": {...}, "lm": {...}}`` and, for an iris tracker, ``"eye"``: f32
arrays keyed by ONNX initializer name, zaru_tpu/pipeline/face_cascade.py:
125-130) or ``MultiObjectTracker.params`` (multi_object.py:87, the same
``{"det", "lm"}`` form) or ``StreamIdentifier.params``
(zaru_tpu/face/identify.py:148, the tracker's plus MobileFaceNet's under
``"emb"``) into the port's parameters, which the trackers' and
``StreamIdentifier``'s ``params=`` accept; ``network_params_from_jax``
does the same for one ``zaru_tpu`` ``NeuralNetwork.params``
(zaru_tpu/nn.py:88), which the port's
:meth:`~zaru_tpu_torch.nn.NeuralNetwork.load_params` takes. Both packages
then compute with the same weights. Any array that converts with
``np.asarray`` is accepted; the JAX package itself is not imported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["network_params_from_jax", "params_from_jax"]


def network_params_from_jax(params: dict, where: str = "") -> dict[str, torch.Tensor]:
    """``{onnx name: f32 array}`` → the same dict of f32 CPU tensors."""
    out = {}
    for name, value in params.items():
        arr = np.asarray(value)
        if arr.dtype != np.float32:
            raise ValueError(f"{where}{name}: expected float32, got {arr.dtype}")
        out[name] = torch.from_numpy(np.array(arr))
    return out


def params_from_jax(tracker_params: dict) -> dict:
    """``{"det": {name: array}, "lm": {name: array}[, "eye": ...][, "emb":
    ...]}`` → the same dicts of f32 CPU tensors; the trackers copy them to
    their device."""
    nets = ("det", "lm") + tuple(net for net in ("eye", "emb") if net in tracker_params)
    return {net: network_params_from_jax(tracker_params[net], f"{net}/") for net in nets}
