"""BlazeFace short-range face detection (zaru_tpu/face/detection.py:113
``ShortRangeNetwork``, decode :96)."""

from __future__ import annotations

import enum

import torch

from .._device import resolve_device
from ..detection import Anchors, LayerInfo, decode_ssd_device
from ..geometry import signed_angle_to_x
from ..nn import Cnn, ColorMapper

__all__ = ["Keypoint", "ShortRangeNetwork"]


class Keypoint(enum.IntEnum):
    """Keypoint indices of the BlazeFace detections."""

    LEFT_EYE = 0
    RIGHT_EYE = 1
    NOSE_TIP = 2
    MOUTH = 3
    LEFT_EAR = 4
    RIGHT_EAR = 5


class ShortRangeNetwork:
    """BlazeFace for faces within ~3 m of the camera: 128×128 input, 896
    anchors."""

    FILE = "face_detection_short_range.onnx"
    LAYERS = [LayerInfo(2, 16, 16), LayerInfo(6, 8, 8)]
    NUM_KEYPOINTS = 6

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(-1.0, 1.0), self.device)
        self.anchors = torch.from_numpy(Anchors.calculate(self.LAYERS).centers).to(self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def decode_device(self, outputs, thresh: float = 0.5):
        """``(regressors [B,896,16], classificators [B,896,1])`` →
        ``(boxes [B,896,4], conf [B,896], keypoints [B,896,6,2], angles
        [B,896])`` in network-input pixels."""
        res = self._cnn.input_resolution()
        boxes, conf, kps = decode_ssd_device(
            res.width, res.height, self.anchors, outputs[0], outputs[1], thresh,
            self.NUM_KEYPOINTS,
        )
        ltr = kps[..., Keypoint.RIGHT_EYE, :] - kps[..., Keypoint.LEFT_EYE, :]
        return boxes, conf, kps, signed_angle_to_x(ltr)
