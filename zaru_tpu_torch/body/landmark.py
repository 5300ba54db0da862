"""33-point body pose landmarks (zaru_tpu/body/landmark.py:162
``LiteNetwork``, :169 ``FullNetwork``, decode :147).

The networks output 39 landmarks (33 pose + 6 auxiliary), each with (x, y,
z, visibility, presence); visibility and presence pass through a sigmoid.
The segmentation, heatmap and world-landmark heads are not run: the
networks load with outputs 0 and 1 selected (body/landmark.rs:149,175).
The trackers decode on tensors (``decode_device``);
:class:`~zaru_tpu_torch.landmark.Estimator` decodes on the host
(``extract`` :138) into a :class:`LandmarkResult` (:91).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .._device import resolve_device
from ..landmark import LandmarkNetwork, Landmarks
from ..nn import Cnn, ColorMapper
from ..num import sigmoid_np

__all__ = [
    "COARSE_CONNECTIVITY",
    "FullNetwork",
    "LandmarkIdx",
    "LandmarkResult",
    "LiteNetwork",
    "NUM_POSE",
    "NUM_TOTAL",
]

NUM_POSE = 33
NUM_AUX = 6
NUM_TOTAL = NUM_POSE + NUM_AUX


class LandmarkIdx(enum.IntEnum):
    """(body/landmark.rs:83-117)"""

    NOSE = 0
    LEFT_EYE_INNER = 1
    LEFT_EYE = 2
    LEFT_EYE_OUTER = 3
    RIGHT_EYE_INNER = 4
    RIGHT_EYE = 5
    RIGHT_EYE_OUTER = 6
    LEFT_EAR = 7
    RIGHT_EAR = 8
    MOUTH_LEFT = 9
    MOUTH_RIGHT = 10
    LEFT_SHOULDER = 11
    RIGHT_SHOULDER = 12
    LEFT_ELBOW = 13
    RIGHT_ELBOW = 14
    LEFT_WRIST = 15
    RIGHT_WRIST = 16
    LEFT_PINKY = 17
    RIGHT_PINKY = 18
    LEFT_INDEX = 19
    RIGHT_INDEX = 20
    LEFT_THUMB = 21
    RIGHT_THUMB = 22
    LEFT_HIP = 23
    RIGHT_HIP = 24
    LEFT_KNEE = 25
    RIGHT_KNEE = 26
    LEFT_ANKLE = 27
    RIGHT_ANKLE = 28
    LEFT_HEEL = 29
    RIGHT_HEEL = 30
    LEFT_FOOT_INDEX = 31
    RIGHT_FOOT_INDEX = 32


_I = LandmarkIdx
COARSE_CONNECTIVITY = [
    (_I.LEFT_SHOULDER, _I.RIGHT_SHOULDER),
    (_I.LEFT_SHOULDER, _I.LEFT_ELBOW),
    (_I.LEFT_ELBOW, _I.LEFT_WRIST),
    (_I.RIGHT_SHOULDER, _I.RIGHT_ELBOW),
    (_I.RIGHT_ELBOW, _I.RIGHT_WRIST),
    (_I.LEFT_SHOULDER, _I.LEFT_HIP),
    (_I.LEFT_HIP, _I.LEFT_ANKLE),
    (_I.LEFT_ANKLE, _I.LEFT_HEEL),
    (_I.LEFT_ANKLE, _I.LEFT_FOOT_INDEX),
    (_I.RIGHT_SHOULDER, _I.RIGHT_HIP),
    (_I.RIGHT_HIP, _I.RIGHT_ANKLE),
    (_I.RIGHT_ANKLE, _I.RIGHT_HEEL),
    (_I.RIGHT_ANKLE, _I.RIGHT_FOOT_INDEX),
]


class LandmarkResult:
    """39 landmarks (33 pose + 6 auxiliary) and the pose presence."""

    def __init__(self):
        self.landmarks = Landmarks(NUM_TOTAL)
        self.pose_presence = 0.0

    def landmarks_mut(self) -> Landmarks:
        return self.landmarks

    def confidence(self) -> float:
        return self.pose_presence

    def presence(self) -> float:
        return self.pose_presence

    def pose_landmarks(self) -> np.ndarray:
        return self.landmarks.positions()[:NUM_POSE]

    def aux_landmarks(self) -> np.ndarray:
        return self.landmarks.positions()[NUM_POSE:]

    def get(self, idx: LandmarkIdx):
        return self.landmarks.get(int(idx))


class _PoseLandmark(LandmarkNetwork):
    """A pose landmarker: ``FILE`` (the ONNX blob), 256×256 input, colour
    range [0, 1]."""

    FILE: str

    def __init__(self, compute_dtype=None, device=None):
        """``compute_dtype=torch.bfloat16`` runs the network body in bf16."""
        self.device = resolve_device(device)
        self._cnn = Cnn.load(self.FILE, ColorMapper.linear(0.0, 1.0), self.device, output_subset=[0, 1],
                             compute_dtype=compute_dtype)

    def cnn(self) -> Cnn:
        return self._cnn

    def init_estimate(self) -> LandmarkResult:
        return LandmarkResult()

    def extract(self, outputs, estimate: LandmarkResult) -> None:
        """Host decode of ``(landmarks [1,195], pose flag [1,1])``: positions
        in network-input pixels, the sigmoids of visibility and presence."""
        screen = outputs[0].reshape(NUM_TOTAL, 5)
        estimate.pose_presence = float(outputs[1].reshape(()))
        estimate.landmarks.set_positions(screen[:, 0:3].astype(np.float32))
        estimate.landmarks.set_visibility(sigmoid_np(screen[:, 3]))
        estimate.landmarks.set_presence(sigmoid_np(screen[:, 4]))

    def decode_device(self, outputs):
        """``(landmarks [B,195], pose flag [B,1])`` → ``(positions [B,39,3]
        in network-input pixels, pose flag [B], visibility [B,39], presence
        [B,39])``."""
        b = outputs[0].shape[0]
        screen = outputs[0].reshape(b, NUM_TOTAL, 5)
        return (
            screen[..., 0:3],
            outputs[1].reshape(b),
            torch.sigmoid(screen[..., 3]),
            torch.sigmoid(screen[..., 4]),
        )


class LiteNetwork(_PoseLandmark):
    """``pose_landmark_lite.onnx`` (missing upstream; raises
    ``ModelMissingError`` until provided)."""

    FILE = "pose_landmark_lite.onnx"


class FullNetwork(_PoseLandmark):
    """``pose_landmark_full.onnx`` (missing upstream)."""

    FILE = "pose_landmark_full.onnx"
