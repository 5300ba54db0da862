"""Palm detection (zaru_tpu/hand/detection.py ``_Palm`` :63, ``LiteNetwork``
:115, ``FullNetwork`` :124).

The detection angle orients the hand fingers-up: the wrist → middle-finger
MCP vector against the Y axis (:48 ``_palm_angle``). ``decode_device``
(:100) decodes on tensors for the trackers, ``extract`` (:83) on the host
for :class:`~zaru_tpu_torch.detection.Detector`. Both networks share the
anchor layout. ``FullNetwork``'s blob (``palm_detection_full.onnx``) is
missing upstream: constructing it raises ``ModelMissingError`` until the
blob is provided (JAX's raises at ``.cnn()``, where it loads lazily).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .._device import resolve_device
from ..detection import Anchors, DetectionNetwork, Detections, LayerInfo, decode_ssd, decode_ssd_device
from ..nn import Cnn, ColorMapper

__all__ = ["ALL_KEYPOINTS", "FullNetwork", "Keypoint", "LiteNetwork"]


class Keypoint(enum.IntEnum):
    """Palm detection keypoint indices."""

    WRIST = 0
    INDEX_FINGER_MCP = 1
    MIDDLE_FINGER_MCP = 2
    RING_FINGER_MCP = 3
    PINKY_MCP = 4
    THUMB_CMC = 5
    THUMB_MCP = 6


ALL_KEYPOINTS = list(Keypoint)


def _palm_angle(det) -> float:
    """Clockwise rotation of the wrist → middle-finger MCP vector against
    +Y, Y-up convention: ``atan2(-rel.x, rel.y)`` of ``rel = wrist -
    middle MCP``."""
    rel = det.keypoint(Keypoint.WRIST) - det.keypoint(Keypoint.MIDDLE_FINGER_MCP)
    return float(np.arctan2(-rel[0], rel[1]))


class _Palm(DetectionNetwork):
    """A palm detector: 192×192 input, colour range [0, 1], 2016 anchors,
    7 keypoints."""

    FILE: str
    LAYERS = [LayerInfo(2, 24, 24), LayerInfo(6, 12, 12)]
    NUM_KEYPOINTS = 7

    def __init__(self, compute_dtype=None, device=None):
        """``compute_dtype=torch.bfloat16`` runs the network body in bf16."""
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(0.0, 1.0), self.device, compute_dtype=compute_dtype)
        self.anchors = Anchors.calculate(self.LAYERS)
        self._anchor_centers = torch.from_numpy(self.anchors.centers).to(self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def extract(self, outputs, threshold: float, detections: Detections) -> None:
        """Host decode of ``(boxes [1,2016,18], confidences [1,2016,1])``
        into ``detections``, in network-input pixels."""
        res = self._cnn.input_resolution()
        n = len(self.anchors)
        if outputs[0].shape != (1, n, 18) or outputs[1].shape != (1, n, 1):
            raise ValueError(f"palm outputs {outputs[0].shape}, {outputs[1].shape} for {n} anchors")
        decode_ssd(res.width, res.height, self.anchors, outputs[0], outputs[1], threshold, detections,
                   num_keypoints=self.NUM_KEYPOINTS, angle_fn=_palm_angle)

    def decode_device(self, outputs, thresh: float = 0.5):
        """``(regressors [B,2016,18], classificators [B,2016,1])`` →
        ``(boxes [B,2016,4], conf [B,2016], keypoints [B,2016,7,2], angles
        [B,2016])`` in network-input pixels; the angle is ``atan2(-rel.x,
        rel.y)`` of ``rel = wrist - middle-finger MCP``."""
        res = self._cnn.input_resolution()
        boxes, conf, kps = decode_ssd_device(
            res.width, res.height, self._anchor_centers, outputs[0], outputs[1], thresh,
            self.NUM_KEYPOINTS,
        )
        rel = kps[..., Keypoint.WRIST, :] - kps[..., Keypoint.MIDDLE_FINGER_MCP, :]
        return boxes, conf, kps, torch.atan2(-rel[..., 0], rel[..., 1])


class LiteNetwork(_Palm):
    """The lite palm detector."""

    FILE = "palm_detection_lite.onnx"


class FullNetwork(_Palm):
    """The full palm detector, about 15% slower than the lite one. Its blob
    is missing upstream; constructing it raises ``ModelMissingError`` until
    the blob is provided."""

    FILE = "palm_detection_full.onnx"
