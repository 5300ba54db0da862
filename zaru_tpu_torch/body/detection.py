"""Pose detection (zaru_tpu/body/detection.py:46 ``PoseNetwork``, host
decode :67, device decode :83).

``PoseNetwork`` is a ``DetectionNetwork``: ``Detector(PoseNetwork())`` runs
it on the host as the face and palm detectors run (``extract``, no angle,
as in JAX), and the trackers decode on tensors (``decode_device``), where
the detection angle aligns the hips → scale-point vector with +Y, the hand
and face convention.
"""

from __future__ import annotations

import enum

import torch

from .._device import resolve_device
from ..detection import Anchors, DetectionNetwork, Detections, LayerInfo, decode_ssd, decode_ssd_device
from ..nn import Cnn, ColorMapper

__all__ = ["Keypoint", "PoseNetwork"]


class Keypoint(enum.IntEnum):
    """Keypoints of the pose detector: the hips, and the full-body
    scale/rotation alignment point above the head."""

    HIPS = 0
    SCALE_POINT = 1


class PoseNetwork(DetectionNetwork):
    """The pose detector: 224×224 input, colour range [-1, 1], 2254 anchors,
    12 box parameters (the box and 4 keypoints)."""

    FILE = "pose_detection.onnx"
    LAYERS = [LayerInfo(2, 28, 28), LayerInfo(2, 14, 14), LayerInfo(6, 7, 7)]
    NUM_KEYPOINTS = 4

    def __init__(self, compute_dtype=None, device=None):
        """``compute_dtype=torch.bfloat16`` runs the network body in bf16."""
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(-1.0, 1.0), self.device, compute_dtype=compute_dtype)
        self.anchors = Anchors.calculate(self.LAYERS)
        self._anchor_centers = torch.from_numpy(self.anchors.centers).to(self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def extract(self, outputs, threshold: float, detections: Detections) -> None:
        """Host decode of ``(boxes [1,2254,12], confidences [1,2254,1])``
        into ``detections``, in network-input pixels."""
        res = self._cnn.input_resolution()
        n = len(self.anchors)
        if outputs[0].shape != (1, n, 12) or outputs[1].shape != (1, n, 1):
            raise ValueError(f"pose outputs {outputs[0].shape}, {outputs[1].shape} for {n} anchors")
        decode_ssd(res.width, res.height, self.anchors, outputs[0], outputs[1], threshold, detections,
                   num_keypoints=self.NUM_KEYPOINTS)

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
