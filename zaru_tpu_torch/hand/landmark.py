"""21-point hand landmarks (zaru_tpu/hand/landmark.py).

``LiteNetwork`` decodes on tensors for the trackers (``decode_device``,
:168-173) and on the host for :class:`~zaru_tpu_torch.landmark.Estimator`
(``extract`` :160) into a :class:`LandmarkResult` (:96: presence,
handedness, the palm helpers and the rotation). ``LiteNetwork`` and
``FullNetwork`` (:183) share ``_HandLandmark``; ``FullNetwork``'s blob
(``hand_landmark_full.onnx``) is missing upstream: constructing it raises
``ModelMissingError`` until the blob is provided (JAX's raises at
``.cnn()``, where it loads lazily).
"""

from __future__ import annotations

import enum

import numpy as np

from .._device import resolve_device
from ..landmark import LandmarkNetwork, Landmarks
from ..nn import Cnn, ColorMapper

__all__ = ["CONNECTIVITY", "FullNetwork", "Handedness", "LandmarkIdx", "LandmarkResult", "LiteNetwork",
           "PALM_LANDMARKS"]


class Handedness(enum.Enum):
    LEFT = "left"
    RIGHT = "right"


class LandmarkIdx(enum.IntEnum):
    """The 21 hand landmarks."""

    WRIST = 0
    THUMB_CMC = 1
    THUMB_MCP = 2
    THUMB_IP = 3
    THUMB_TIP = 4
    INDEX_FINGER_MCP = 5
    INDEX_FINGER_PIP = 6
    INDEX_FINGER_DIP = 7
    INDEX_FINGER_TIP = 8
    MIDDLE_FINGER_MCP = 9
    MIDDLE_FINGER_PIP = 10
    MIDDLE_FINGER_DIP = 11
    MIDDLE_FINGER_TIP = 12
    RING_FINGER_MCP = 13
    RING_FINGER_PIP = 14
    RING_FINGER_DIP = 15
    RING_FINGER_TIP = 16
    PINKY_MCP = 17
    PINKY_PIP = 18
    PINKY_DIP = 19
    PINKY_TIP = 20


PALM_LANDMARKS = [
    LandmarkIdx.WRIST,
    LandmarkIdx.THUMB_CMC,
    LandmarkIdx.INDEX_FINGER_MCP,
    LandmarkIdx.MIDDLE_FINGER_MCP,
    LandmarkIdx.RING_FINGER_MCP,
    LandmarkIdx.PINKY_MCP,
]

_I = LandmarkIdx
CONNECTIVITY = [
    # Palm outline:
    (_I.WRIST, _I.THUMB_CMC),
    (_I.THUMB_CMC, _I.INDEX_FINGER_MCP),
    (_I.INDEX_FINGER_MCP, _I.MIDDLE_FINGER_MCP),
    (_I.MIDDLE_FINGER_MCP, _I.RING_FINGER_MCP),
    (_I.RING_FINGER_MCP, _I.PINKY_MCP),
    (_I.PINKY_MCP, _I.WRIST),
    # Fingers:
    (_I.THUMB_CMC, _I.THUMB_MCP),
    (_I.THUMB_MCP, _I.THUMB_IP),
    (_I.THUMB_IP, _I.THUMB_TIP),
    (_I.INDEX_FINGER_MCP, _I.INDEX_FINGER_PIP),
    (_I.INDEX_FINGER_PIP, _I.INDEX_FINGER_DIP),
    (_I.INDEX_FINGER_DIP, _I.INDEX_FINGER_TIP),
    (_I.MIDDLE_FINGER_MCP, _I.MIDDLE_FINGER_PIP),
    (_I.MIDDLE_FINGER_PIP, _I.MIDDLE_FINGER_DIP),
    (_I.MIDDLE_FINGER_DIP, _I.MIDDLE_FINGER_TIP),
    (_I.RING_FINGER_MCP, _I.RING_FINGER_PIP),
    (_I.RING_FINGER_PIP, _I.RING_FINGER_DIP),
    (_I.RING_FINGER_DIP, _I.RING_FINGER_TIP),
    (_I.PINKY_MCP, _I.PINKY_PIP),
    (_I.PINKY_PIP, _I.PINKY_DIP),
    (_I.PINKY_DIP, _I.PINKY_TIP),
]


class LandmarkResult:
    """21 3-D landmarks, presence and handedness."""

    NUM_LANDMARKS = 21

    def __init__(self):
        self.landmarks = Landmarks(self.NUM_LANDMARKS)
        self.presence = 0.0
        self.raw_handedness = 0.0

    def landmarks_mut(self) -> Landmarks:
        return self.landmarks

    def confidence(self) -> float:
        """The presence score (the model applies its sigmoid), which the
        tracker reads."""
        return self.presence

    def landmark_position(self, index: int) -> np.ndarray:
        return self.landmarks.positions()[index]

    def palm_landmarks(self) -> np.ndarray:
        return self.landmarks.positions()[[int(i) for i in PALM_LANDMARKS]]

    def palm_center(self) -> np.ndarray:
        return self.palm_landmarks().mean(axis=0)

    def rotation_radians(self) -> float:
        """Clockwise palm rotation against fingers-up."""
        finger = self.landmark_position(LandmarkIdx.MIDDLE_FINGER_MCP)[:2]
        wrist = self.landmark_position(LandmarkIdx.WRIST)[:2]
        rel = wrist - finger
        return float(np.arctan2(-rel[0], rel[1]))

    def angle_radians(self) -> float:
        return self.rotation_radians()

    def handedness(self) -> Handedness:
        return Handedness.RIGHT if self.raw_handedness > 0.5 else Handedness.LEFT


class _HandLandmark(LandmarkNetwork):
    """A hand landmarker: 224×224 crop, colour range [0, 1] → 21×3
    landmarks, presence and handedness (both sigmoids inside the model)."""

    FILE: str
    NUM_LANDMARKS = 21

    def __init__(self, compute_dtype=None, device=None):
        """``compute_dtype=torch.bfloat16`` runs the network body in bf16;
        JAX measured it to move landmarks by up to ~21 px on crops unlike
        the training data (zaru_tpu/hand/landmark.py:147-151)."""
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(0.0, 1.0), self.device, compute_dtype=compute_dtype)

    def cnn(self) -> Cnn:
        return self._cnn

    def init_estimate(self) -> LandmarkResult:
        return LandmarkResult()

    def extract(self, outputs, estimate: LandmarkResult) -> None:
        """Host decode of (landmarks [1,63], presence [1,1], handedness
        [1,1], world landmarks [1,63])."""
        estimate.presence = float(outputs[1].reshape(()))
        estimate.raw_handedness = float(outputs[2].reshape(()))
        estimate.landmarks.set_positions(outputs[0].reshape(self.NUM_LANDMARKS, 3))

    def decode_device(self, outputs):
        """``(landmarks [B,63], presence [B,1], handedness [B,1], world
        [B,63])`` → ``(positions [B,21,3] in network-input pixels, presence
        [B], handedness [B])``."""
        b = outputs[0].shape[0]
        return outputs[0].reshape(b, self.NUM_LANDMARKS, 3), outputs[1].reshape(b), outputs[2].reshape(b)


class LiteNetwork(_HandLandmark):
    """The lite hand landmarker."""

    FILE = "hand_landmark_lite.onnx"


class FullNetwork(_HandLandmark):
    """The full hand landmarker, more accurate at 25-30% more inference
    time. Its blob is missing upstream; constructing it raises
    ``ModelMissingError`` until the blob is provided."""

    FILE = "hand_landmark_full.onnx"
