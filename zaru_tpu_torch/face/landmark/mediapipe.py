"""MediaPipe Face Mesh (zaru_tpu/face/landmark/mediapipe.py): V1 (:166
``FaceMeshV1``, decode :185), 192×192 → 468 points, and V2 (:194
``FaceMeshV2``, decode :214), 256×256 → 478 points (the mesh and 2×5 iris
points) and a tongue-out score. Both take the colour range [-1, 1]."""

from __future__ import annotations

import enum

import torch

from ..._device import resolve_device
from ...nn import Cnn, ColorMapper

__all__ = ["FaceMeshV1", "FaceMeshV2", "LandmarkIdx"]


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


class FaceMeshV1:
    """Face Mesh: 192×192 upright face crop → 468×3 landmarks + face flag."""

    FILE = "face_landmark.onnx"
    NUM_LANDMARKS = 468

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(-1.0, 1.0), self.device)

    def cnn(self) -> Cnn:
        return self._cnn

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

    def decode_device(self, outputs):
        """``(coords [B,1,1,1434], flag [B,1,1,1], tongue [B,1])`` →
        ``(positions [B,478,3], confidence [B], tongue [B])``; the model
        applies the tongue score's sigmoid itself."""
        b = outputs[0].shape[0]
        return (*super().decode_device(outputs), outputs[2].reshape(b))
