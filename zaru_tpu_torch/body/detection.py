"""Pose detection (zaru_tpu/body/detection.py:46 ``PoseNetwork``, decode
:83).

The detection angle aligns the hips → scale-point vector with +Y, the
hand and face convention. The host-side ``extract`` waits for the port's
``detection.Detections``.
"""

from __future__ import annotations

import enum

import torch

from .._device import resolve_device
from ..detection import Anchors, LayerInfo, decode_ssd_device
from ..nn import Cnn, ColorMapper

__all__ = ["Keypoint", "PoseNetwork"]


class Keypoint(enum.IntEnum):
    """Keypoints of the pose detector: the hips, and the full-body
    scale/rotation alignment point above the head."""

    HIPS = 0
    SCALE_POINT = 1


class PoseNetwork:
    """The pose detector: 224×224 input, colour range [-1, 1], 2254 anchors,
    12 box parameters (the box and 4 keypoints)."""

    FILE = "pose_detection.onnx"
    LAYERS = [LayerInfo(2, 28, 28), LayerInfo(2, 14, 14), LayerInfo(6, 7, 7)]
    NUM_KEYPOINTS = 4

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(-1.0, 1.0), self.device)
        self.anchors = Anchors.calculate(self.LAYERS)
        self._anchor_centers = torch.from_numpy(self.anchors.centers).to(self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def decode_device(self, outputs, thresh: float = 0.5):
        """``(regressors [B,2254,12], classificators [B,2254,1])`` →
        ``(boxes [B,2254,4], conf [B,2254], keypoints [B,2254,4,2], angles
        [B,2254])`` in network-input pixels; the angle is ``atan2(-rel.x,
        rel.y)`` of ``rel = hips - scale point``."""
        res = self._cnn.input_resolution()
        boxes, conf, kps = decode_ssd_device(
            res.width, res.height, self._anchor_centers, outputs[0], outputs[1], thresh,
            self.NUM_KEYPOINTS,
        )
        rel = kps[..., Keypoint.HIPS, :] - kps[..., Keypoint.SCALE_POINT, :]
        return boxes, conf, kps, torch.atan2(-rel[..., 0], rel[..., 1])
