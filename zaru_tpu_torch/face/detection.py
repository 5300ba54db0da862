"""BlazeFace face detection (zaru_tpu/face/detection.py:61 ``_BlazeFace``,
decode :96): the short-range network (:113 ``ShortRangeNetwork``, 128×128,
896 anchors) and the full-range one (:121 ``FullRangeNetwork``, 192×192,
2304 anchors)."""

from __future__ import annotations

import enum

import torch

from .._device import resolve_device
from ..detection import Anchors, LayerInfo, decode_ssd_device
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


class _BlazeFace:
    """A BlazeFace network: ``FILE`` (the ONNX blob) and ``LAYERS`` (its
    anchor layers); colour range [-1, 1], six keypoints."""

    FILE: str
    LAYERS: list[LayerInfo]
    NUM_KEYPOINTS = 6

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(-1.0, 1.0), self.device)
        self.anchors = torch.from_numpy(Anchors.calculate(self.LAYERS).centers).to(self.device)

    def cnn(self) -> Cnn:
        return self._cnn

    def decode_device(self, outputs, thresh: float = 0.5):
        """``(regressors [B,N,16], classificators [B,N,1])`` for ``N``
        anchors → ``(boxes [B,N,4], conf [B,N], keypoints [B,N,6,2], angles
        [B,N])`` in network-input pixels."""
        res = self._cnn.input_resolution()
        boxes, conf, kps = decode_ssd_device(
            res.width, res.height, self.anchors, outputs[0], outputs[1], thresh,
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
