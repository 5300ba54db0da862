"""Face recognition embeddings (MobileFaceNet): the port of
zaru_tpu/face/recognition.py.

The reference exposes this only through an example
(examples/eval_face_recognition.rs:44-90: 112×112 crop → 128-d embedding,
L2-distance matching). MobileFaceNet holds no BlazeBlock chain, so its
graph runs op by op through the executor (cuDNN convolutions, TF32 off).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import resolve_device
from ..assets import model_path
from ..image import as_view
from ..nn import Cnn, CnnInputShape, ColorMapper, NeuralNetwork
from ..num import to_numpy

__all__ = ["Embedder", "embedding_distance"]


def _load(device: torch.device) -> Cnn:
    return Cnn(
        NeuralNetwork.load(model_path("mobilefacenet.onnx"), device=device),
        CnnInputShape.NCHW,
        # The eval example maps to [-1, 1] (eval_face_recognition.rs:50).
        ColorMapper.linear(-1.0, 1.0),
    )


@functools.lru_cache(maxsize=None)
def _cnn(device: torch.device) -> Cnn:
    """The network with the ONNX file's weights, one per device."""
    return _load(device)


def embedding_distance(a, b) -> float:
    """L2 distance between embeddings (eval_face_recognition.rs:82-88)."""
    return float(np.linalg.norm(np.asarray(to_numpy(a)) - np.asarray(to_numpy(b))))


class Embedder:
    """Computes 128-d face embeddings from (aligned) face crops on
    ``device`` (``cuda`` unless named). ``params``: ``{onnx name: array}``
    weights (for instance :func:`zaru_tpu_torch.weights.network_params_from_jax`
    of JAX's ``Embedder.params``) for a network of this embedder's own; left
    out, the ONNX file's weights in a network shared by the embedders of
    the device."""

    def __init__(self, device=None, params: dict | None = None):
        dev = resolve_device(device)
        if params is None:
            self._cnn = _cnn(dev)
        else:
            self._cnn = _load(dev)
            self._cnn.nn.load_params(params)

    def cnn(self) -> Cnn:
        return self._cnn

    def input_resolution(self):
        return self._cnn.input_resolution()

    def embed(self, image) -> np.ndarray:
        """Embeds a face crop (an image or view; the exact sampler at batch
        1, stretched to the network's aspect as in JAX); returns a [128]
        float32 vector."""
        view = as_view(image)
        rect = view.rect().grow_to_fit_aspect(self._cnn.input_resolution().aspect_ratio())
        out = self._cnn.estimate(view.view(rect))
        return out[0].cpu().numpy().reshape(128)

    def apply_on_view(self, image_u8, rrect):
        """``[H,W,4] u8`` + ``[5]`` rect on the embedder's device → ``[128]``
        embedding tensor (the exact sampler)."""
        with torch.inference_mode():
            return self._cnn.apply_on_view(image_u8[None], rrect[None])[0].reshape(128)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self._cnn.nn.params
