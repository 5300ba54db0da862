"""SSD decode on tensors (zaru_tpu/detection/__init__.py:266
``decode_ssd_device``)."""

from __future__ import annotations

import torch

from .nms import nms_average_device
from .ssd import Anchors, LayerInfo

__all__ = ["Anchors", "LayerInfo", "decode_ssd_device", "nms_average_device"]


def decode_ssd_device(
    input_w: int, input_h: int, anchor_centers, boxes_raw, conf_raw, thresh: float,
    num_keypoints: int,
):
    """SSD decode, batched over leading dims.

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
