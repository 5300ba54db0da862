"""MediaPipe iris landmarks (zaru_tpu/face/eye.py ``EyeNetwork``,
``EyeLandmarks``).

The iris network computes 5 iris and 71 eye-contour landmarks of a *left*
eye crop (64×64, colour range [-1, 1]); right eyes go through it mirrored,
and their landmarks are mirrored back (``FaceTracker._iris_decode``, or on
the host :meth:`EyeLandmarks.flip_horizontal_in_place`).
"""

from __future__ import annotations

import numpy as np

from .._device import resolve_device
from ..landmark import LandmarkNetwork, Landmarks
from ..nn import Cnn, ColorMapper
from ..resolution import Resolution

__all__ = ["EyeLandmarks", "EyeNetwork"]


class EyeLandmarks:
    """76 landmarks: 5 iris (index 0 the centre), then 71 eye contour."""

    NUM_LANDMARKS = 76
    NUM_IRIS = 5

    def __init__(self):
        self.landmarks = Landmarks(self.NUM_LANDMARKS)

    def landmarks_mut(self) -> Landmarks:
        return self.landmarks

    def iris_center(self) -> np.ndarray:
        return self.landmarks.positions()[0]

    def iris_contour(self) -> np.ndarray:
        """[4,3] outer iris landmarks."""
        return self.landmarks.positions()[1:5]

    def iris_diameter(self) -> float:
        """The mean iris diameter from its contour."""
        radii = np.linalg.norm(self.iris_contour() - self.iris_center(), axis=-1)
        return float(radii.mean() * 2.0)

    def eye_contour(self) -> np.ndarray:
        """[71,3] eye contour and brows."""
        return self.landmarks.positions()[5:]

    def flip_horizontal_in_place(self, full_res: Resolution) -> None:
        """Mirrors every landmark along X, undoing a mirrored input."""
        half = np.float32(full_res.width) / 2.0
        pos = self.landmarks.positions().copy()
        pos[:, 0] = -(pos[:, 0] - half) + half
        self.landmarks.set_positions(pos)


class EyeNetwork(LandmarkNetwork):
    """The iris network: 64×64 eye crop → eye contour ``[1,213]`` (71×3) and
    iris ``[1,15]`` (5×3)."""

    FILE = "iris_landmark.onnx"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(-1.0, 1.0), self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def init_estimate(self) -> EyeLandmarks:
        return EyeLandmarks()

    def extract(self, outputs, estimate: EyeLandmarks) -> None:
        """Host decode: the iris points, then the contour."""
        pos = np.concatenate([outputs[1].reshape(-1, 3), outputs[0].reshape(-1, 3)], axis=0)
        estimate.landmarks.set_positions(pos.astype(np.float32))
