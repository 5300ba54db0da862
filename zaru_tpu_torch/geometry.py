"""Rectangles and rotated rectangles as f32 tensors
(zaru_tpu/geometry.py:66-189).

Axis-aligned rects are ``[..., 4]`` ``(cx, cy, w, h)``; rotated rects are
``[..., 5]`` ``(cx, cy, w, h, radians)``, radians clockwise with Y down. The
functions broadcast over leading dims exactly like the JAX functional core
and keep its f32 operation order, so elementwise results match it bit for
bit wherever the arithmetic is IEEE (``cos``, ``sin`` and ``atan2`` come
from each library's own math and may differ in the last ulp).
"""

from __future__ import annotations

import torch

from .num import div

__all__ = [
    "rect_grow_rel",
    "rect_grow_to_fit_aspect",
    "rect_iou",
    "rotate_cw",
    "rotate_ccw",
    "rrect_transform_in",
    "rrect_transform_out",
    "rrect_bounding",
    "signed_angle_to_x",
]


def rect_grow_rel(rect, amount: float):
    """Adds ``amount``×size to each side (geometry.py:66)."""
    grow = rect[..., 2:4] * (2.0 * amount)
    return torch.cat([rect[..., 0:2], rect[..., 2:4] + grow], dim=-1)


def rect_grow_to_fit_aspect(rect, aspect_f32: float):
    """Extends one dimension symmetrically to the aspect ``width/height``
    (geometry.py:73). ``aspect_f32`` must be an f32-representable number."""
    w, h = rect[..., 2], rect[..., 3]
    target_w = h * aspect_f32
    wide = target_w >= w
    new_w = torch.where(wide, target_w, w)
    new_h = torch.where(wide, h, div(w, aspect_f32))
    return torch.stack([rect[..., 0], rect[..., 1], new_w, new_h], dim=-1)


def rect_iou(a, b):
    """Intersection over union of axis-aligned rects (geometry.py:85)."""
    a_tl = a[..., 0:2] - a[..., 2:4] * 0.5
    b_tl = b[..., 0:2] - b[..., 2:4] * 0.5
    a_br, b_br = a_tl + a[..., 2:4], b_tl + b[..., 2:4]
    lo = torch.maximum(a_tl, b_tl)
    hi = torch.minimum(a_br, b_br)
    wh = hi - lo
    empty = (wh[..., 0] < 0) | (wh[..., 1] < 0)
    inter = torch.where(empty, torch.zeros_like(wh[..., 0]), wh[..., 0] * wh[..., 1])
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    union = area_a + area_b - inter
    return inter / union


def rotate_cw(pt, radians):
    """Clockwise 2-D rotation, Y-up convention (geometry.py:112)."""
    c, s = torch.cos(radians), torch.sin(radians)
    x, y = pt[..., 0], pt[..., 1]
    return torch.stack([c * x + s * y, -s * x + c * y], dim=-1)


def rotate_ccw(pt, radians):
    """Counterclockwise 2-D rotation (geometry.py:123)."""
    c, s = torch.cos(radians), torch.sin(radians)
    x, y = pt[..., 0], pt[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def rrect_transform_in(rrect, pt):
    """Parent coords → rotated-rect local coords, the local origin at the
    rect's top-left corner (geometry.py:131)."""
    center = rrect[..., 2:4] * 0.5
    top_left = rrect[..., 0:2] - center
    return rotate_cw(pt - top_left - center, rrect[..., 4]) + center


def rrect_transform_out(rrect, pt):
    """Rotated-rect local coords → parent coords (geometry.py:140)."""
    center = rrect[..., 2:4] * 0.5
    top_left = rrect[..., 0:2] - center
    return rotate_ccw(pt - center, rrect[..., 4]) + center + top_left


def rrect_bounding(radians, points):
    """Rotated bounding rect at angle ``radians [...]`` of ``points
    [..., N, 2]`` (geometry.py:147)."""
    rot = rotate_cw(points, radians[..., None] if radians.ndim > 0 else radians)
    mn = torch.amin(rot, dim=-2)
    mx = torch.amax(rot, dim=-2)
    center_rot = (mn + mx) * 0.5
    center = rotate_ccw(center_rot, radians)
    size = mx - mn
    rad_b = torch.broadcast_to(radians, center[..., 0].shape)
    return torch.stack(
        [center[..., 0], center[..., 1], size[..., 0], size[..., 1], rad_b], dim=-1
    )


def signed_angle_to_x(v):
    """Signed clockwise rotation aligning ``v [..., 2]`` with +X
    (geometry.py:180)."""
    return torch.atan2(v[..., 1], v[..., 0])
