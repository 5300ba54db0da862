"""MediaPipe Face Mesh (zaru_tpu/face/landmark/mediapipe.py): V1 (:166
``FaceMeshV1``), 192×192 → 468 points, and V2 (:194 ``FaceMeshV2``),
256×256 → 478 points (the mesh and 2×5 iris points) and a tongue-out
score. Both take the colour range [-1, 1].

``decode_device`` decodes on tensors for the trackers; ``extract`` decodes
on the host for :class:`~zaru_tpu_torch.landmark.Estimator` into a
:class:`LandmarkResultV1` or :class:`LandmarkResultV2` (:67-160: the face
flag, the rotation from the outer eye corners and the eye rects)."""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..._device import resolve_device
from ...landmark import LandmarkNetwork, Landmarks
from ...nn import Cnn, ColorMapper
from ...num import sigmoid_np
from ...rect import RotatedRect

__all__ = [
    "FaceMeshV1",
    "FaceMeshV2",
    "LandmarkIdx",
    "LandmarkResultV1",
    "LandmarkResultV2",
    "reference_positions",
]


class LandmarkIdx(enum.IntEnum):
    """Landmark indices of the canonical 468-point face mesh."""

    MOUTH_LEFT = 78
    MOUTH_RIGHT = 308
    MOUTH_TOP = 13
    MOUTH_BOTTOM = 14
    LEFT_EYE_OUTER_CORNER = 33
    LEFT_EYE_INNER_CORNER = 133
    LEFT_EYE_TOP = 159
    LEFT_EYE_BOTTOM = 145
    RIGHT_EYE_INNER_CORNER = 362
    RIGHT_EYE_OUTER_CORNER = 263
    RIGHT_EYE_TOP = 386
    RIGHT_EYE_BOTTOM = 374
    RIGHT_EYEBROW_INNER_CORNER = 295
    LEFT_EYEBROW_INNER_CORNER = 65


LEFT_EYE_CONTOUR = [33, 246, 161, 160, 159, 158, 157, 173, 133, 155, 154, 153, 145, 144, 163, 7]
RIGHT_EYE_CONTOUR = [362, 398, 384, 385, 386, 387, 388, 466, 263, 249, 390, 373, 374, 380, 381, 382]


class _ResultBase:
    NUM_LANDMARKS = 468

    def __init__(self):
        self.landmarks = Landmarks(self.NUM_LANDMARKS)
        self.face_flag = 0.0

    def landmarks_mut(self) -> Landmarks:
        return self.landmarks

    def confidence(self) -> float:
        """Face-present confidence (sigmoid of the model's face flag)."""
        return self.face_flag

    def rotation_radians(self) -> float:
        """Clockwise face rotation from the outer eye corners."""
        pos = self.landmarks.positions()
        v = pos[LandmarkIdx.RIGHT_EYE_OUTER_CORNER, :2] - pos[LandmarkIdx.LEFT_EYE_OUTER_CORNER, :2]
        return float(np.arctan2(v[1], v[0]))

    def angle_radians(self) -> float:
        return self.rotation_radians()

    def _eye_rect(self, indices) -> RotatedRect:
        return RotatedRect.bounding(self.rotation_radians(), self.landmarks.positions()[list(indices), :2])

    def left_eye(self) -> RotatedRect:
        """The rotated rect around the left eye."""
        return self._eye_rect([LandmarkIdx.LEFT_EYE_BOTTOM, LandmarkIdx.LEFT_EYE_OUTER_CORNER,
                               LandmarkIdx.LEFT_EYE_INNER_CORNER, LandmarkIdx.LEFT_EYE_TOP])

    def right_eye(self) -> RotatedRect:
        return self._eye_rect([LandmarkIdx.RIGHT_EYE_BOTTOM, LandmarkIdx.RIGHT_EYE_INNER_CORNER,
                               LandmarkIdx.RIGHT_EYE_OUTER_CORNER, LandmarkIdx.RIGHT_EYE_TOP])


class LandmarkResultV1(_ResultBase):
    """468 landmarks and the face flag."""


class LandmarkResultV2(_ResultBase):
    """478 landmarks (468 mesh + 2×5 iris), the face flag and the tongue-out
    blendshape."""

    NUM_LANDMARKS = 478

    def __init__(self):
        super().__init__()
        self.tongue_out = 0.0

    def mesh_landmarks(self) -> np.ndarray:
        return self.landmarks.positions()[: LandmarkResultV1.NUM_LANDMARKS]

    def left_iris(self) -> np.ndarray:
        """[5,3]: the centre, then left/right/top/bottom."""
        s = LandmarkResultV1.NUM_LANDMARKS
        return self.landmarks.positions()[s : s + 5]

    def right_iris(self) -> np.ndarray:
        s = LandmarkResultV1.NUM_LANDMARKS + 5
        return self.landmarks.positions()[s : s + 5]

    def left_eye_contour(self) -> np.ndarray:
        return self.landmarks.positions()[LEFT_EYE_CONTOUR]

    def right_eye_contour(self) -> np.ndarray:
        return self.landmarks.positions()[RIGHT_EYE_CONTOUR]


class FaceMeshV1(LandmarkNetwork):
    """Face Mesh: 192×192 upright face crop → 468×3 landmarks + face flag."""

    FILE = "face_landmark.onnx"
    NUM_LANDMARKS = 468
    Result = LandmarkResultV1

    def __init__(self, compute_dtype=None, device=None):
        """``compute_dtype=torch.bfloat16`` runs the network body in bf16."""
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(-1.0, 1.0), self.device, compute_dtype=compute_dtype)

    def cnn(self) -> Cnn:
        return self._cnn

    def init_estimate(self):
        return self.Result()

    def extract(self, outputs, estimate) -> None:
        """Host decode: the face flag's sigmoid and the landmarks in
        network-input pixels."""
        estimate.face_flag = float(sigmoid_np(outputs[1].reshape(())))
        estimate.landmarks.set_positions(outputs[0].reshape(-1, 3)[: estimate.NUM_LANDMARKS])

    def decode_device(self, outputs):
        """``(coords [B,1,1,1404], flag [B,1,1,1])`` → ``(positions [B,468,3]
        in network-input pixels, confidence [B])``."""
        b = outputs[0].shape[0]
        return outputs[0].reshape(b, -1, 3), torch.sigmoid(outputs[1].reshape(b))


class FaceMeshV2(FaceMeshV1):
    """Face Mesh V2: 256×256 upright face crop → 478×3 landmarks, face flag
    and tongue-out score."""

    FILE = "face_landmarks_detector.onnx"
    NUM_LANDMARKS = 478
    Result = LandmarkResultV2

    def extract(self, outputs, estimate) -> None:
        """As V1, and the tongue-out score (the model applies its
        sigmoid)."""
        super().extract(outputs, estimate)
        estimate.tongue_out = float(outputs[2].reshape(()))

    def decode_device(self, outputs):
        """``(coords [B,1,1,1434], flag [B,1,1,1], tongue [B,1])`` →
        ``(positions [B,478,3], confidence [B], tongue [B])``; the model
        applies the tongue score's sigmoid itself."""
        b = outputs[0].shape[0]
        return (*super().decode_device(outputs), outputs[2].reshape(b))


def reference_positions() -> np.ndarray:
    """The canonical face mesh's reference positions ``[468,3]``."""
    from .canonical_face import REFERENCE_POSITIONS

    return REFERENCE_POSITIONS
