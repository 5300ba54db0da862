"""21-point hand landmarks (zaru_tpu/hand/landmark.py ``LiteNetwork``,
decode :168-173).

The host-side ``LandmarkResult`` (handedness enum, palm helpers) is not
ported yet.
"""

from __future__ import annotations

import enum

from .._device import resolve_device
from ..nn import Cnn, ColorMapper

__all__ = ["LandmarkIdx", "LiteNetwork"]


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


class LiteNetwork:
    """The lite hand landmarker: 224×224 crop, colour range [0, 1] → 21×3
    landmarks, presence and handedness (both sigmoids inside the model)."""

    FILE = "hand_landmark_lite.onnx"
    NUM_LANDMARKS = 21

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(0.0, 1.0), self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def decode_device(self, outputs):
        """``(landmarks [B,63], presence [B,1], handedness [B,1], world
        [B,63])`` → ``(positions [B,21,3] in network-input pixels, presence
        [B], handedness [B])``."""
        b = outputs[0].shape[0]
        return outputs[0].reshape(b, self.NUM_LANDMARKS, 3), outputs[1].reshape(b), outputs[2].reshape(b)
