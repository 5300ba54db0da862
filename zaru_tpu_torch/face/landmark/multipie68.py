"""68-point facial landmarks in the Multi-PIE scheme
(zaru_tpu/face/landmark/multipie68.py): ``PeppaFacialLandmark``
(``slim_160_latest.onnx``, 160×160, colours [-1, 1]) and ``FaceOnnx``
(``landmarks_68_pfld.onnx``, 112×112, colours [0, 1]). Both output
normalised x, y pairs, which ``extract`` scales to network-input pixels on
the host; neither has a confidence output. Neither network has a BlazeBlock
chain for the stage kernel (their residual blocks are inverted)."""

from __future__ import annotations

import numpy as np

from ..._device import resolve_device
from ...landmark import LandmarkNetwork, Landmarks
from ...nn import Cnn, ColorMapper

__all__ = ["FaceOnnx", "LandmarkResult", "PeppaFacialLandmark", "reference_positions"]

NUM_LANDMARKS = 68


class LandmarkResult:
    """68 landmarks (z is 0)."""

    def __init__(self):
        self.landmarks = Landmarks(NUM_LANDMARKS)

    def landmarks_mut(self) -> Landmarks:
        return self.landmarks


class _Pfld68(LandmarkNetwork):
    FILE: str
    COLOR_RANGE: tuple[float, float]

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(*self.COLOR_RANGE), self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def init_estimate(self) -> LandmarkResult:
        return LandmarkResult()

    def extract(self, outputs, estimate: LandmarkResult) -> None:
        """The first 136 outputs as x, y pairs in [0, 1] of the input."""
        res = self._cnn.input_resolution()
        xy = outputs[0].reshape(-1)[: NUM_LANDMARKS * 2].reshape(NUM_LANDMARKS, 2)
        pos = np.zeros((NUM_LANDMARKS, 3), np.float32)
        pos[:, 0] = xy[:, 0] * res.width
        pos[:, 1] = xy[:, 1] * res.height
        estimate.landmarks.set_positions(pos)


class PeppaFacialLandmark(_Pfld68):
    """The Peppa-Facial-Landmark slim-160 network: fast, less accurate."""

    FILE = "slim_160_latest.onnx"
    COLOR_RANGE = (-1.0, 1.0)


class FaceOnnx(_Pfld68):
    """The FaceONNX 68-point landmarker: about twice the cost, more
    accurate."""

    FILE = "landmarks_68_pfld.onnx"
    COLOR_RANGE = (0.0, 1.0)


def reference_positions() -> np.ndarray:
    """The 68 reference landmark positions ``[68,3]``."""
    from .canonical_face import MULTIPIE68_POSITIONS

    return MULTIPIE68_POSITIONS
