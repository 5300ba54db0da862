"""MediaPipe iris landmarks (zaru_tpu/face/eye.py ``EyeNetwork``,
``EyeLandmarks``).

The iris network computes 5 iris and 71 eye-contour landmarks of a *left*
eye crop (64×64, colour range [-1, 1]); right eyes go through it mirrored,
and their landmarks are mirrored back (``FaceTracker._iris_decode``).
"""

from __future__ import annotations

from .._device import resolve_device
from ..nn import Cnn, ColorMapper

__all__ = ["EyeLandmarks", "EyeNetwork"]


class EyeLandmarks:
    """76 landmarks: 5 iris (index 0 the centre), then 71 eye contour."""

    NUM_LANDMARKS = 76
    NUM_IRIS = 5


class EyeNetwork:
    """The iris network: 64×64 eye crop → eye contour ``[1,213]`` (71×3) and
    iris ``[1,15]`` (5×3)."""

    FILE = "iris_landmark.onnx"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(-1.0, 1.0), self.device)

    def cnn(self) -> Cnn:
        return self._cnn
