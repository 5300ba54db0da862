"""Object detection (zaru_tpu/detection/__init__.py).

The host engine (:class:`Detector`, detection/__init__.py:148) drives a
:class:`DetectionNetwork` as the reference's detection loop does: the
image's aspect-fit view → the network on it at batch 1 (``Cnn.estimate``,
the exact sampler) → one host read of the outputs → the network's
``extract`` (the host SSD decode :func:`decode_ssd`, numpy) → host NMS →
coordinates back in the image. The trackers keep detection on the device
with :func:`decode_ssd_device` and :func:`nms_average_device`
(:func:`nms_remove_device` is its classic, fixed-shape form).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..image import as_view
from ..num import sigmoid_np
from ..rect import Rect
from ..timer import Timer
from .nms import NonMaxSuppression, SuppressionMode, nms_average_device, nms_remove_device
from .ssd import Anchors, LayerInfo

__all__ = [
    "Anchors",
    "Detection",
    "DetectionNetwork",
    "Detections",
    "Detector",
    "LayerInfo",
    "NonMaxSuppression",
    "SuppressionMode",
    "decode_ssd",
    "decode_ssd_device",
    "nms_average_device",
    "nms_remove_device",
]


class Detection:
    """A detected object: confidence, clockwise angle, bounding rect and
    keypoints (detection/__init__.py:44)."""

    def __init__(self, confidence: float, rect: Rect, keypoints=None, angle: float = 0.0):
        self._confidence = float(confidence)
        self._rect = rect
        self._keypoints = [np.asarray(k, np.float32) for k in (keypoints or [])]
        self._angle = float(angle)

    def confidence(self) -> float:
        return self._confidence

    def set_confidence(self, c: float) -> None:
        self._confidence = float(c)

    def angle(self) -> float:
        """Clockwise angle in radians; 0.0 if the network does not estimate
        one."""
        return self._angle

    def set_angle(self, a: float) -> None:
        self._angle = float(a)

    def bounding_rect(self) -> Rect:
        return self._rect

    def set_bounding_rect(self, rect: Rect) -> None:
        self._rect = rect

    def keypoints(self) -> list:
        return self._keypoints

    def keypoint(self, i: int) -> np.ndarray:
        return self._keypoints[i]

    def push_keypoint(self, kp) -> None:
        self._keypoints.append(np.asarray(kp, np.float32))

    def __repr__(self):
        return (
            f"Detection(conf={self._confidence:.3f}, rect={self._rect!r}, "
            f"angle={np.degrees(self._angle):.1f}deg, {len(self._keypoints)} kps)"
        )


class Detections:
    """Detections by class (detection/__init__.py:97)."""

    def __init__(self):
        self._by_class: dict[int, list[Detection]] = {}

    def __len__(self) -> int:
        return sum(len(v) for v in self._by_class.values())

    def is_empty(self) -> bool:
        return len(self) == 0

    def clear(self) -> None:
        self._by_class.clear()

    def push(self, class_id: int, detection: Detection) -> None:
        self._by_class.setdefault(class_id, []).append(detection)

    def iter(self):
        for dets in self._by_class.values():
            yield from dets

    def __iter__(self):
        return self.iter()

    def all_detections(self):
        for cls, dets in self._by_class.items():
            for d in dets:
                yield cls, d

    def for_class(self, class_id: int):
        return iter(self._by_class.get(class_id, []))

    def classes(self):
        return list(self._by_class)


class DetectionNetwork:
    """Base of the detection networks (detection/__init__.py:127): ``cnn()``,
    ``extract(outputs, threshold, detections)`` on the host outputs with
    positions in network-input pixels, and ``decode_device`` for the
    trackers."""

    def cnn(self):
        raise NotImplementedError

    def extract(self, outputs, threshold: float, detections: Detections) -> None:
        raise NotImplementedError

    def decode_device(self, outputs, thresh: float = 0.5):
        raise NotImplementedError


DEFAULT_THRESHOLD = 0.5


class Detector:
    """The host detector driving a :class:`DetectionNetwork`
    (detection/__init__.py:148) on the network's device."""

    def __init__(self, network: DetectionNetwork):
        self._network = network
        self._detections = Detections()
        self._t_infer = Timer("infer")
        self._t_extract = Timer("extract")
        self._t_nms = Timer("nms")
        self._thresh = DEFAULT_THRESHOLD
        self._nms = NonMaxSuppression()

    def input_resolution(self):
        return self._network.cnn().input_resolution()

    def set_threshold(self, thresh: float) -> None:
        self._thresh = thresh

    @property
    def nms(self) -> NonMaxSuppression:
        return self._nms

    def detect(self, image) -> Detections:
        """Detects objects in an image or view; coordinates are in its
        space."""
        view = as_view(image)
        self._detections.clear()
        cnn = self._network.cnn()
        input_res = cnn.input_resolution()
        rect = view.rect().grow_to_fit_aspect(input_res.aspect_ratio())
        fit_view = view.view(rect)

        with self._t_infer.measure():
            # The host read is the completion fence: it stays in the span.
            outputs = [o.cpu().numpy() for o in cnn.estimate(fit_view)]

        with self._t_extract.measure():
            self._network.extract(outputs, self._thresh, self._detections)

        with self._t_nms.measure():
            for cls in self._detections.classes():
                self._detections._by_class[cls] = self._nms.process(self._detections._by_class[cls])

        # Back to the input image's coordinates.
        scale = np.float32(rect.width()) / np.float32(input_res.width)
        off = rect.top_left()
        for _, det in self._detections.all_detections():
            r = det.bounding_rect()
            det.set_bounding_rect(
                Rect.from_center(
                    r.center()[0] * scale, r.center()[1] * scale, r.width() * scale, r.height() * scale,
                ).move_by(off)
            )
            det._keypoints = [kp * scale + off for kp in det._keypoints]
        return self._detections

    def timers(self):
        return [self._t_infer, self._t_extract, self._t_nms]


def decode_ssd(
    input_w: int,
    input_h: int,
    anchors: Anchors,
    boxes_raw: np.ndarray,
    conf_raw: np.ndarray,
    thresh: float,
    detections: Detections,
    num_keypoints: int,
    angle_fn: Callable | None = None,
    class_id: int = 0,
) -> None:
    """Host SSD extraction (detection/__init__.py:220), numpy.

    ``boxes_raw [1,N,D]``: per anchor (dx, dy, w, h, kp0x, kp0y, ...) in
    input pixels, offset by the anchor centre; ``conf_raw [1,N,1]`` raw
    logits. Keypoints decode as ``raw + anchor·input_size`` (the MediaPipe
    convention, as in the JAX package).
    """
    n = len(anchors)
    if boxes_raw.shape[:2] != (1, n):
        raise ValueError(f"SSD boxes must be [1,{n},D], got {boxes_raw.shape}")
    conf = sigmoid_np(conf_raw.reshape(n).astype(np.float32))
    size = np.array([input_w, input_h], np.float32)
    for i in np.nonzero(conf >= thresh)[0]:
        bp = boxes_raw[0, i]
        anchor_px = anchors.centers[i] * size
        center = bp[0:2] + anchor_px
        det = Detection(
            float(conf[i]),
            Rect.from_center(center[0], center[1], bp[2], bp[3]),
            keypoints=[bp[4 + 2 * k : 6 + 2 * k] + anchor_px for k in range(num_keypoints)],
        )
        if angle_fn is not None:
            det.set_angle(angle_fn(det))
        detections.push(class_id, det)


def decode_ssd_device(
    input_w: int, input_h: int, anchor_centers, boxes_raw, conf_raw, thresh: float,
    num_keypoints: int,
):
    """SSD decode on tensors (detection/__init__.py:266), batched over
    leading dims.

    ``anchor_centers [N,2]``, ``boxes_raw [...,N,D]``, ``conf_raw [...,N,1]``
    → ``(boxes [...,N,4] cxcywh, conf [...,N] zeroed below thresh,
    keypoints [...,N,K,2])``, in network-input pixels.
    """
    n = anchor_centers.shape[0]
    lead = conf_raw.shape[:-2]
    conf = torch.sigmoid(conf_raw.reshape(*lead, n))
    conf = torch.where(conf >= thresh, conf, 0.0)
    anchor_px = torch.stack(
        [anchor_centers[:, 0] * float(input_w), anchor_centers[:, 1] * float(input_h)], dim=-1
    )  # [N,2]
    bp = boxes_raw.reshape(*lead, n, -1)
    center = bp[..., 0:2] + anchor_px
    boxes = torch.cat([center, bp[..., 2:4]], dim=-1)
    kps = bp[..., 4 : 4 + 2 * num_keypoints].reshape(*lead, n, num_keypoints, 2)
    return boxes, conf, kps + anchor_px[:, None, :]
