"""Palm detection (zaru_tpu/hand/detection.py ``LiteNetwork``, decode
:100-113).

The detection angle orients the hand fingers-up: the wrist → middle-finger
MCP vector against the Y axis. ``FullNetwork`` is a missing blob in the JAX
package too and is not ported.
"""

from __future__ import annotations

import enum

import torch

from .._device import resolve_device
from ..detection import Anchors, LayerInfo, decode_ssd_device
from ..nn import Cnn, ColorMapper

__all__ = ["Keypoint", "LiteNetwork"]


class Keypoint(enum.IntEnum):
    """Palm detection keypoint indices."""

    WRIST = 0
    INDEX_FINGER_MCP = 1
    MIDDLE_FINGER_MCP = 2
    RING_FINGER_MCP = 3
    PINKY_MCP = 4
    THUMB_CMC = 5
    THUMB_MCP = 6


class LiteNetwork:
    """The lite palm detector: 192×192 input, colour range [0, 1], 2016
    anchors, 7 keypoints."""

    FILE = "palm_detection_lite.onnx"
    LAYERS = [LayerInfo(2, 24, 24), LayerInfo(6, 12, 12)]
    NUM_KEYPOINTS = 7

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(0.0, 1.0), self.device)
        self.anchors = torch.from_numpy(Anchors.calculate(self.LAYERS).centers).to(self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def decode_device(self, outputs, thresh: float = 0.5):
        """``(regressors [B,2016,18], classificators [B,2016,1])`` →
        ``(boxes [B,2016,4], conf [B,2016], keypoints [B,2016,7,2], angles
        [B,2016])`` in network-input pixels; the angle is ``atan2(-rel.x,
        rel.y)`` of ``rel = wrist - middle-finger MCP``."""
        res = self._cnn.input_resolution()
        boxes, conf, kps = decode_ssd_device(
            res.width, res.height, self.anchors, outputs[0], outputs[1], thresh,
            self.NUM_KEYPOINTS,
        )
        rel = kps[..., Keypoint.WRIST, :] - kps[..., Keypoint.MIDDLE_FINGER_MCP, :]
        return boxes, conf, kps, torch.atan2(-rel[..., 0], rel[..., 1])
