"""Non-maximum suppression (zaru_tpu/detection/nms.py).

- :class:`NonMaxSuppression` (nms.py:33): the host algorithm on lists of
  :class:`~zaru_tpu_torch.detection.Detection` (numpy), for the host
  ``Detector``: sort by confidence in totalOrder, pop seeds from the top,
  remove or confidence-weight-average the detections that overlap them;
- :func:`nms_average_device` (:108): the fixed-shape weighted average on
  tensors, for the trackers;
- :func:`nms_remove_device` (:149): the fixed-shape classic form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import rect_iou
from ..num import total_f32_key
from ..rect import Rect

__all__ = ["SuppressionMode", "NonMaxSuppression", "nms_average_device", "nms_remove_device", "DEFAULT_IOU_THRESH"]

DEFAULT_IOU_THRESH = 0.3


class SuppressionMode:
    """How overlapping detections are handled (nms.py:25)."""

    Remove = "remove"
    Average = "average"


class NonMaxSuppression:
    """Host NMS with the reference's semantics (nms.py:33-106)."""

    def __init__(self):
        self.iou_thresh = DEFAULT_IOU_THRESH
        self.mode = SuppressionMode.Average

    def set_iou_thresh(self, iou_thresh: float) -> None:
        self.iou_thresh = iou_thresh

    def set_mode(self, mode: str) -> None:
        self.mode = mode

    def process(self, detections: list) -> list:
        from . import Detection

        out = []
        # Ascending by confidence (totalOrder), seeds popped from the back.
        pending = sorted(detections, key=lambda d: total_f32_key(d.confidence()))
        while pending:
            seed = pending.pop()
            seed_rect = seed.bounding_rect()
            overlapping, kept = [seed], []
            for other in pending:
                (overlapping if seed_rect.iou(other.bounding_rect()) >= self.iou_thresh else kept).append(other)
            pending = kept
            if self.mode == SuppressionMode.Remove:
                out.append(seed)
                continue
            # Confidence-weighted average of box, keypoints and angle; the
            # seed's confidence.
            divisor = np.float32(0.0)
            acc_rect = np.zeros(4, np.float32)
            acc_angle = np.float32(0.0)
            nkp = max((len(d.keypoints()) for d in overlapping), default=0)
            acc_kp = np.zeros((nkp, 2), np.float32)
            for det in overlapping:
                kps = det.keypoints()
                if len(kps) not in (0, nkp):
                    raise ValueError("detections to average have different keypoint counts")
                factor = np.float32(det.confidence())
                divisor += factor
                r = det.bounding_rect()
                acc_rect += np.concatenate([r.center(), [r.width(), r.height()]]) * factor
                acc_angle += np.float32(det.angle()) * factor
                for i, kp in enumerate(kps):
                    acc_kp[i] += kp * factor
            acc_rect /= divisor
            acc_kp /= divisor
            acc_angle /= divisor
            out.append(Detection(seed.confidence(), Rect.from_center(*acc_rect),
                                 keypoints=[acc_kp[i] for i in range(nkp)], angle=float(acc_angle)))
        return out


def nms_average_device(
    boxes, conf, keypoints, angles, iou_thresh: float = DEFAULT_IOU_THRESH, max_out: int = 16
):
    """Confidence-weighted NMS (SuppressionMode::Average) as a fixed-length
    loop of ``max_out`` slots, batched over leading dims.

    ``boxes [...,N,4]`` (cx,cy,w,h), ``conf [...,N]`` (0 below threshold),
    ``keypoints [...,N,K,2]``, ``angles [...,N]`` → ``(valid [...,max_out]
    bool, conf [...,max_out], boxes [...,max_out,4], keypoints
    [...,max_out,K,2], angles [...,max_out])``, slots in descending seed
    confidence, invalid slots zeroed. ``torch.argmax`` takes the first
    maximal index, like ``jnp.argmax``.
    """
    remaining = conf
    outs = []
    for _ in range(max_out):
        seed = torch.argmax(remaining, dim=-1, keepdim=True)  # [...,1]
        seed_conf = torch.gather(remaining, -1, seed)[..., 0]
        valid = seed_conf > 0.0
        seed_box = torch.gather(boxes, -2, seed[..., None].expand(*seed.shape, 4))  # [...,1,4]
        iou = rect_iou(seed_box, boxes)
        over = (iou >= iou_thresh) & (remaining > 0.0)
        w = torch.where(over, conf, 0.0)
        divisor = torch.clamp_min(torch.sum(w, dim=-1), 1e-20)
        avg_box = torch.sum(w[..., None] * boxes, dim=-2) / divisor[..., None]
        avg_kp = torch.sum(w[..., None, None] * keypoints, dim=-3) / divisor[..., None, None]
        avg_angle = torch.sum(w * angles, dim=-1) / divisor
        remaining = torch.where(over, 0.0, remaining)
        z = valid.to(conf.dtype)
        outs.append((valid, seed_conf * z, avg_box * z[..., None],
                     avg_kp * z[..., None, None], avg_angle * z))
    return tuple(torch.stack(parts, dim=valid.ndim) for parts in zip(*outs))


def nms_remove_device(
    boxes, conf, keypoints, angles, iou_thresh: float = DEFAULT_IOU_THRESH, max_out: int = 16
):
    """Classic NMS (SuppressionMode::Remove, zaru_tpu/detection/nms.py:149)
    as a fixed-length loop of ``max_out`` slots, batched over leading dims:
    each slot keeps its seed as it is and drops every remaining detection
    that overlaps it. Shapes as :func:`nms_average_device`."""
    remaining = conf
    outs = []
    for _ in range(max_out):
        seed = torch.argmax(remaining, dim=-1, keepdim=True)  # [...,1]
        seed_conf = torch.gather(remaining, -1, seed)[..., 0]
        valid = seed_conf > 0.0
        seed_box = torch.gather(boxes, -2, seed[..., None].expand(*seed.shape, 4))  # [...,1,4]
        seed_kp = torch.gather(keypoints, -3, seed[..., None, None].expand(*seed.shape, *keypoints.shape[-2:]))
        iou = rect_iou(seed_box, boxes)
        over = (iou >= iou_thresh) & (remaining > 0.0)
        remaining = torch.where(over, 0.0, remaining)
        z = valid.to(conf.dtype)
        outs.append((valid, seed_conf * z, seed_box[..., 0, :] * z[..., None],
                     seed_kp[..., 0, :, :] * z[..., None, None],
                     torch.gather(angles, -1, seed)[..., 0] * z))
    return tuple(torch.stack(parts, dim=valid.ndim) for parts in zip(*outs))
