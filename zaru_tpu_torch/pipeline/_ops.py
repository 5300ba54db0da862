"""Coordinate helpers of the cascade (zaru_tpu/pipeline/_ops.py:33-83).

Each function broadcasts over leading (stream) dims and keeps the JAX f32
operation order: full-frame letterbox fitting, network → image unmapping,
and the view → image landmark and ROI update.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import (
    rect_grow_rel,
    rect_grow_to_fit_aspect,
    rrect_bounding,
    rrect_transform_out,
)
from .. import profiling
from ..num import div
from ..resolution import Resolution

__all__ = [
    "choose",
    "full_frame_fit",
    "unmap_center_size",
    "unmap_points",
    "aspect_view_rect",
    "landmarks_to_image",
    "padded_roi",
]


def _aspect(res: Resolution) -> float:
    return float(np.float32(res.width) / np.float32(res.height))


def full_frame_fit(frame, res: Resolution):
    """Letterbox rect covering a whole ``[..., H, W, 4]`` frame at the
    network's aspect (_ops.py:33). Returns (fit rect [4], fit rrect [5]).
    The rect's copy to the device is a host sync on a CUDA device."""
    h, w = frame.shape[-3], frame.shape[-2]
    with profiling.sync("zaru.sync.frame_fit"):
        full = torch.tensor([w / 2.0, h / 2.0, float(w), float(h)], dtype=torch.float32, device=frame.device)
    fit = rect_grow_to_fit_aspect(full, _aspect(res))
    return fit, torch.cat([fit, torch.zeros(1, dtype=torch.float32, device=frame.device)])


def unmap_center_size(box, fit, res: Resolution):
    """Network-input coords → image coords for ``(cx,cy,w,h)`` boxes
    (_ops.py:44)."""
    scale = div(fit[..., 2:3], float(res.width))
    top_left = fit[..., 0:2] - fit[..., 2:4] * 0.5
    center = box[..., 0:2] * scale + top_left
    size = box[..., 2:4] * scale
    return torch.cat([center, size], dim=-1)


def unmap_points(xy, fit, res: Resolution):
    """Network-input coords → image coords for points ``[..., 2]``
    (_ops.py:54)."""
    scale = div(fit[..., 2:3], float(res.width))
    top_left = fit[..., 0:2] - fit[..., 2:4] * 0.5
    return xy * scale + top_left


def aspect_view_rect(roi, res: Resolution):
    """ROI grown to the landmark network's aspect, rotation kept
    (_ops.py:62)."""
    return torch.cat([rect_grow_to_fit_aspect(roi[..., 0:4], _aspect(res)), roi[..., 4:5]], dim=-1)


def landmarks_to_image(coords, view_rect, res: Resolution):
    """Network coords ``[..., N, 3]`` → (xy in view coords, positions
    ``[..., N, 3]`` in image coords) for view rects ``[..., 5]``
    (_ops.py:69)."""
    scale = div(view_rect[..., 2:3], float(res.width))[..., None, :]
    xy_view = coords[..., 0:2] * scale
    z = coords[..., 2:3] * scale
    xy = rrect_transform_out(view_rect[..., None, :], xy_view)
    return xy_view, torch.cat([xy, z], dim=-1)


def padded_roi(xy, angle, padding: float):
    """Next ROI: the rotated bounding box of ``xy [..., N, 2]`` at ``angle
    [...]`` plus relative padding (_ops.py:79)."""
    roi = rrect_bounding(angle, xy)
    return torch.cat([rect_grow_rel(roi[..., 0:4], padding), roi[..., 4:5]], dim=-1)


def choose(pred, true_fn, false_fn, operands: tuple):
    """``torch.cond(pred, true_fn, false_fn, operands)``, JAX's ``lax.cond``
    over the ROI sources. Eagerly the predicate is read on the host (one
    read, where it is a tensor) and ``torch.cond`` runs that branch as it
    is; under ``torch.export`` a tensor predicate stays in the graph and
    both branches are captured. A Python bool picks its branch either way.
    The host read is the span ``zaru.sync.gate``, counted in
    ``profiling.counters["host_syncs"]``."""
    if isinstance(pred, torch.Tensor) and torch.compiler.is_exporting():
        # The operator itself: torch.cond would hand the branches to
        # TorchDynamo, which cannot trace the executor's host-side numpy;
        # export's own tracing runs them as Python, as it runs the step.
        return torch.ops.higher_order.cond(pred, true_fn, false_fn, operands)
    if isinstance(pred, torch.Tensor):
        with profiling.sync("zaru.sync.gate"):
            pred = bool(pred)
    return torch.cond(pred, true_fn, false_fn, operands)
