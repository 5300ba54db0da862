"""BlazeFace face detection (zaru_tpu/face/detection.py:61 ``_BlazeFace``):
the short-range network (:113 ``ShortRangeNetwork``, 128×128, 896
anchors) and the full-range one (:121 ``FullRangeNetwork``, 192×192, 2304
anchors). ``decode_device`` (:96) decodes on tensors for the trackers,
``extract`` (:77) on the host for :class:`~zaru_tpu_torch.detection.Detector`;
the angle of a detection is that of its eyes (:44 ``_face_angle``)."""

from __future__ import annotations

import enum

import numpy as np
import torch

from .._device import resolve_device
from ..detection import Anchors, DetectionNetwork, Detections, LayerInfo, decode_ssd, decode_ssd_device
from ..geometry import signed_angle_to_x
from ..nn import Cnn, ColorMapper

__all__ = ["FullRangeNetwork", "Keypoint", "ShortRangeNetwork"]


class Keypoint(enum.IntEnum):
    """Keypoint indices of the BlazeFace detections."""

    LEFT_EYE = 0
    RIGHT_EYE = 1
    NOSE_TIP = 2
    MOUTH = 3
    LEFT_EAR = 4
    RIGHT_EAR = 5


def _face_angle(det) -> float:
    """Clockwise rotation of the left → right eye vector, ``atan2(y, x)`` in
    image coordinates (Y down)."""
    ltr = det.keypoint(Keypoint.RIGHT_EYE) - det.keypoint(Keypoint.LEFT_EYE)
    return float(np.arctan2(ltr[1], ltr[0]))


class _BlazeFace(DetectionNetwork):
    """A BlazeFace network: ``FILE`` (the ONNX blob) and ``LAYERS`` (its
    anchor layers); colour range [-1, 1], six keypoints."""

    FILE: str
    LAYERS: list[LayerInfo]
    NUM_KEYPOINTS = 6

    def __init__(self, compute_dtype=None, device=None):
        """``compute_dtype=torch.bfloat16`` runs the network body in bf16."""
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(-1.0, 1.0), self.device, compute_dtype=compute_dtype)
        self.anchors = Anchors.calculate(self.LAYERS)
        self._anchor_centers = torch.from_numpy(self.anchors.centers).to(self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def extract(self, outputs, threshold: float, detections: Detections) -> None:
        """Host decode of ``(boxes [1,N,16], confidences [1,N,1])`` into
        ``detections``, in network-input pixels."""
        res = self._cnn.input_resolution()
        n = len(self.anchors)
        if outputs[0].shape != (1, n, 16) or outputs[1].shape != (1, n, 1):
            raise ValueError(f"BlazeFace outputs {outputs[0].shape}, {outputs[1].shape} for {n} anchors")
        decode_ssd(res.width, res.height, self.anchors, outputs[0], outputs[1], threshold, detections,
                   num_keypoints=self.NUM_KEYPOINTS, angle_fn=_face_angle)

    def decode_device(self, outputs, thresh: float = 0.5):
        """``(regressors [B,N,16], classificators [B,N,1])`` for ``N``
        anchors → ``(boxes [B,N,4], conf [B,N], keypoints [B,N,6,2], angles
        [B,N])`` in network-input pixels."""
        res = self._cnn.input_resolution()
        boxes, conf, kps = decode_ssd_device(
            res.width, res.height, self._anchor_centers, outputs[0], outputs[1], thresh,
            self.NUM_KEYPOINTS,
        )
        ltr = kps[..., Keypoint.RIGHT_EYE, :] - kps[..., Keypoint.LEFT_EYE, :]
        return boxes, conf, kps, signed_angle_to_x(ltr)


class ShortRangeNetwork(_BlazeFace):
    """BlazeFace for faces within ~3 m of the camera: 128×128 input, 896
    anchors."""

    FILE = "face_detection_short_range.onnx"
    LAYERS = [LayerInfo(2, 16, 16), LayerInfo(6, 8, 8)]


class FullRangeNetwork(_BlazeFace):
    """BlazeFace with the longer detection range: 192×192 input, 2304
    anchors."""

    FILE = "face_detection_full_range.onnx"
    LAYERS = [LayerInfo(1, 48, 48)]
