"""Fixed-shape weighted-average NMS on tensors
(zaru_tpu/detection/nms.py:108 ``nms_average_device``)."""

from __future__ import annotations

import torch

from ..geometry import rect_iou

__all__ = ["nms_average_device", "DEFAULT_IOU_THRESH"]

DEFAULT_IOU_THRESH = 0.3


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
