"""Host-side rectangles: ``Rect`` and ``RotatedRect`` (the port's own copy
of zaru_tpu/geometry.py:197-394) with the numpy functional core they call
(geometry.py:54-193, on numpy arrays only).

The port's :mod:`zaru_tpu_torch.geometry` holds the same functional core on
tensors for the trackers; this module serves the host API: image views
(:mod:`zaru_tpu_torch.image`) and debug drawing
(:mod:`zaru_tpu_torch.image.draw`). Float32 scalar math, X right, Y down,
rotations clockwise in radians.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from .resolution import AspectRatio


def _xp(_x):
    return np


__all__ = [
    "Rect",
    "RotatedRect",
    # functional core
    "rect_from_top_left",
    "rect_top_left",
    "rect_grow_rel",
    "rect_grow_to_fit_aspect",
    "rect_iou",
    "rect_bounding",
    "rotate_cw",
    "rotate_ccw",
    "rrect_transform_in",
    "rrect_transform_out",
    "rrect_bounding",
    "rrect_compose",
    "signed_angle_to_x",
]


# ---------------------------------------------------------------------------
# Functional core (numpy arrays, any batch shape)
# ---------------------------------------------------------------------------


def rect_from_top_left(x, y, w, h):
    """(cx,cy,w,h) rect from top-left corner (rect.rs:31-39)."""
    xp = _xp(x)
    return xp.stack(
        [x + w * 0.5, y + h * 0.5, w * xp.ones_like(x), h * xp.ones_like(x)], axis=-1
    )


def rect_top_left(rect):
    return rect[..., 0:2] - rect[..., 2:4] * 0.5


def rect_grow_rel(rect, amount):
    """Add ``amount``×size margin to each side (rect.rs:85-96)."""
    xp = _xp(rect)
    grow = rect[..., 2:4] * (2.0 * amount)
    return xp.concatenate([rect[..., 0:2], rect[..., 2:4] + grow], axis=-1)


def rect_grow_to_fit_aspect(rect, aspect_f32):
    """Symmetrically extend one dimension to reach the target aspect ratio
    (rect.rs:104-117). ``aspect_f32`` is width/height as a float."""
    xp = _xp(rect)
    w, h = rect[..., 2], rect[..., 3]
    target_w = h * aspect_f32
    wide = target_w >= w
    new_w = xp.where(wide, target_w, w)
    new_h = xp.where(wide, h, w / aspect_f32)
    return xp.stack([rect[..., 0], rect[..., 1], new_w, new_h], axis=-1)


def rect_iou(a, b):
    """Intersection-over-union of axis-aligned rects (rect.rs:190-214).

    Broadcasts over batch dims; empty intersections produce 0 area.
    """
    xp = _xp(a)
    a_tl, b_tl = rect_top_left(a), rect_top_left(b)
    a_br, b_br = a_tl + a[..., 2:4], b_tl + b[..., 2:4]
    lo = xp.maximum(a_tl, b_tl)
    hi = xp.minimum(a_br, b_br)
    wh = hi - lo
    empty = (wh[..., 0] < 0) | (wh[..., 1] < 0)
    inter = xp.where(empty, xp.zeros_like(wh[..., 0]), wh[..., 0] * wh[..., 1])
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    union = area_a + area_b - inter
    return inter / union


def rect_bounding(points):
    """Axis-aligned bounding rect of ``points [..., N, 2]`` (rect.rs:49-63)."""
    xp = _xp(points)
    mn = xp.min(points, axis=-2)
    mx = xp.max(points, axis=-2)
    return rect_from_top_left(mn[..., 0], mn[..., 1], mx[..., 0] - mn[..., 0], mx[..., 1] - mn[..., 1])


def rotate_cw(pt, radians):
    """Clockwise 2D rotation, Y-up convention (zaru-linalg matrix.rs:563-567).

    ``pt[..., 2]``; ``radians`` broadcastable against ``pt[..., 0]``.
    """
    xp = _xp(pt)
    c, s = xp.cos(radians), xp.sin(radians)
    x, y = pt[..., 0], pt[..., 1]
    return xp.stack([c * x + s * y, -s * x + c * y], axis=-1)


def rotate_ccw(pt, radians):
    """Counterclockwise 2D rotation (zaru-linalg matrix.rs:571-579)."""
    xp = _xp(pt)
    c, s = xp.cos(radians), xp.sin(radians)
    x, y = pt[..., 0], pt[..., 1]
    return xp.stack([c * x - s * y, s * x + c * y], axis=-1)


def rrect_transform_in(rrect, pt):
    """Parent coords → rotated-rect local coords; local origin is the rect's
    top-left corner (rect.rs:402-412)."""
    center = rrect[..., 2:4] * 0.5
    top_left = rrect[..., 0:2] - center
    pos = pt - top_left - center
    return rotate_cw(pos, rrect[..., 4:5][..., 0]) + center


def rrect_transform_out(rrect, pt):
    """Rotated-rect local coords → parent coords (rect.rs:414-423)."""
    center = rrect[..., 2:4] * 0.5
    top_left = rrect[..., 0:2] - center
    return rotate_ccw(pt - center, rrect[..., 4:5][..., 0]) + center + top_left


def rrect_bounding(radians, points):
    """Rotated bounding rect (angle ``radians``) of ``points [..., N, 2]``
    (rect.rs:287-325): rotate points clockwise, take the axis-aligned box,
    rotate the box center back."""
    xp = _xp(points)
    rad = xp.asarray(radians, dtype=points.dtype)
    # Broadcast radians over the points axis: [...,] -> [..., 1].
    rot = rotate_cw(points, rad[..., None] if rad.ndim > 0 else rad)
    mn = xp.min(rot, axis=-2)
    mx = xp.max(rot, axis=-2)
    center_rot = (mn + mx) * 0.5
    center = rotate_ccw(center_rot, rad)
    size = mx - mn
    rad_b = xp.broadcast_to(rad, center[..., 0].shape)
    return xp.stack([center[..., 0], center[..., 1], size[..., 0], size[..., 1], rad_b], axis=-1)


def rrect_compose(base, sub):
    """Compose a sub-view ``sub`` (a [...,5] rotated rect in ``base``'s local
    coordinates) with ``base`` (a [...,5] rotated rect in root coordinates),
    yielding the sub-view's rotated rect in root coordinates.

    Mirrors the reference's view composition (image/mod.rs:201-210): rotations
    add; the sub rect's center maps through ``base``'s transform_out.
    """
    xp = _xp(base)
    radians = base[..., 4] + sub[..., 4]
    center = rrect_transform_out(base, sub[..., 0:2])
    return xp.concatenate(
        [center, sub[..., 2:4], radians[..., None]], axis=-1
    )


def signed_angle_to_x(v):
    """Signed clockwise rotation aligning ``v [..., 2]`` with the +X axis,
    Y-up convention (zaru-linalg vector.rs:542-574):
    ``-perp_dot(v, X).atan2(dot(v, X)) = -(-v.y).atan2(v.x) = atan2(v.y, v.x)``.

    In image coordinates (Y down) the callers pass vectors measured in image
    space, matching the reference's usage for face/palm angles.
    """
    xp = _xp(v)
    return xp.arctan2(v[..., 1], v[..., 0])


# ---------------------------------------------------------------------------
# Ergonomic host-side wrappers (float32 scalar math for reference parity)
# ---------------------------------------------------------------------------


def _f32(x) -> np.float32:
    return np.float32(x)


class Rect:
    """An axis-aligned rectangle, stored as float32 center+size
    (reference: rect.rs:15-18)."""

    __slots__ = ("_a",)

    def __init__(self, arr):
        self._a = np.asarray(arr, dtype=np.float32).reshape(4)

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_center(x_center, y_center, width, height) -> "Rect":
        return Rect(np.array([x_center, y_center, width, height], dtype=np.float32))

    @staticmethod
    def from_top_left(x, y, width, height) -> "Rect":
        return Rect(
            rect_from_top_left(_f32(x), _f32(y), _f32(width), _f32(height))
        )

    @staticmethod
    def from_ranges(x_range, y_range) -> "Rect":
        (x0, x1), (y0, y1) = x_range, y_range
        assert x0 <= x1 and y0 <= y1
        return Rect.from_top_left(x0, y0, x1 - x0, y1 - y0)

    @staticmethod
    def bounding(points: Iterable) -> "Rect | None":
        pts = np.asarray(list(points), dtype=np.float32)
        if pts.size == 0:
            return None
        return Rect(rect_bounding(pts.reshape(-1, 2)))

    # --- accessors ---------------------------------------------------------
    @property
    def array(self) -> np.ndarray:
        return self._a

    def center(self) -> np.ndarray:
        return self._a[0:2].copy()

    def size(self) -> np.ndarray:
        return self._a[2:4].copy()

    def top_left(self) -> np.ndarray:
        return rect_top_left(self._a)

    def x(self) -> float:
        return float(self.top_left()[0])

    def y(self) -> float:
        return float(self.top_left()[1])

    def width(self) -> float:
        return float(self._a[2])

    def height(self) -> float:
        return float(self._a[3])

    def area(self) -> float:
        return float(self._a[2] * self._a[3])

    def aspect_ratio_f32(self) -> np.float32:
        return _f32(self._a[2] / self._a[3])

    # --- transforms ---------------------------------------------------------
    def scale(self, s) -> "Rect":
        return Rect(np.concatenate([self._a[0:2], self._a[2:4] * _f32(s)]))

    def grow_rel(self, amount) -> "Rect":
        return Rect(rect_grow_rel(self._a, _f32(amount)))

    def grow_to_fit_aspect(self, target_aspect: "AspectRatio | float") -> "Rect":
        assert self.width() > 0 and self.height() > 0
        f = target_aspect.as_f32() if isinstance(target_aspect, AspectRatio) else _f32(target_aspect)
        return Rect(rect_grow_to_fit_aspect(self._a, f))

    def grow_move_center(self, x_center, y_center) -> "Rect":
        """Move center, keeping all original points contained (rect.rs:119-133)."""
        x_center, y_center = _f32(x_center), _f32(y_center)
        w = max(abs(x_center - self.x()), abs(x_center - (self.x() + self.width()))) * 2.0
        h = max(abs(y_center - self.y()), abs(y_center - (self.y() + self.height()))) * 2.0
        return Rect.from_center(x_center, y_center, w, h)

    def move_by(self, offset) -> "Rect":
        off = np.asarray(offset, dtype=np.float32)
        return Rect(np.concatenate([self._a[0:2] + off, self._a[2:4]]))

    def move_to(self, x, y) -> "Rect":
        return Rect.from_top_left(x, y, self.width(), self.height())

    def intersection(self, other: "Rect") -> "Rect | None":
        mn = np.maximum(self.top_left(), other.top_left())
        mx = np.minimum(self.top_left() + self.size(), other.top_left() + other.size())
        if mn[0] > mx[0] or mn[1] > mx[1]:
            return None
        return Rect.bounding([mn, mx])

    def iou(self, other: "Rect") -> float:
        return float(rect_iou(self._a, other._a))

    def contains_point(self, point) -> bool:
        p = np.asarray(point, dtype=np.float32)
        return bool(
            self.x() <= p[0]
            and self.y() <= p[1]
            and self.x() + self.width() >= p[0]
            and self.y() + self.height() >= p[1]
        )

    def corners(self) -> np.ndarray:
        x, y, w, h = self.x(), self.y(), self.width(), self.height()
        return np.array(
            [[x, y], [x + w, y], [x + w, y + h], [x, y + h]], dtype=np.float32
        )

    def __eq__(self, other):
        return isinstance(other, Rect) and bool(np.all(self._a == other._a))

    def __repr__(self):
        return f"Rect @ ({self._a[0]},{self._a[1]})/{self._a[2]}x{self._a[3]}"


class RotatedRect:
    """A :class:`Rect` rotated clockwise around its center
    (reference: rect.rs:269-273)."""

    __slots__ = ("_a",)

    def __init__(self, arr):
        self._a = np.asarray(arr, dtype=np.float32).reshape(5)

    @staticmethod
    def new(rect: Rect, radians) -> "RotatedRect":
        return RotatedRect(np.concatenate([rect.array, [np.float32(radians)]]))

    @staticmethod
    def from_rect(rect: Rect) -> "RotatedRect":
        return RotatedRect.new(rect, 0.0)

    @staticmethod
    def bounding(radians, points: Iterable) -> "RotatedRect | None":
        pts = np.asarray(list(points), dtype=np.float32)
        if pts.size == 0:
            return None
        return RotatedRect(rrect_bounding(_f32(radians), pts.reshape(-1, 2)))

    @property
    def array(self) -> np.ndarray:
        return self._a

    def rotation_radians(self) -> float:
        return float(self._a[4])

    def rotation_degrees(self) -> float:
        return float(np.degrees(self._a[4]))

    def rect(self) -> Rect:
        return Rect(self._a[0:4])

    def set_rect(self, rect: Rect) -> None:
        self._a = np.concatenate([rect.array, self._a[4:5]])

    def map(self, f) -> "RotatedRect":
        return RotatedRect.new(f(self.rect()), self._a[4])

    def center(self) -> np.ndarray:
        return self._a[0:2].copy()

    def grow_rel(self, amount) -> "RotatedRect":
        return self.map(lambda r: r.grow_rel(amount))

    def grow_to_fit_aspect(self, aspect) -> "RotatedRect":
        return self.map(lambda r: r.grow_to_fit_aspect(aspect))

    def rotated_corners(self) -> np.ndarray:
        corners = self.rect().corners()
        rel = corners - self._a[None, 0:2]
        return rotate_ccw(rel, self._a[4]) + self._a[None, 0:2]

    def contains_point(self, point) -> bool:
        pt = self.transform_in(point)
        return self.rect().move_to(0.0, 0.0).contains_point(pt)

    def transform_in(self, pt) -> np.ndarray:
        return rrect_transform_in(self._a, np.asarray(pt, dtype=np.float32))

    def transform_out(self, pt) -> np.ndarray:
        return rrect_transform_out(self._a, np.asarray(pt, dtype=np.float32))

    def __eq__(self, other):
        return isinstance(other, RotatedRect) and bool(np.all(self._a == other._a))

    def __repr__(self):
        return (
            f"RotatedRect({self.rect()!r}, {np.degrees(self._a[4]):.1f}deg)"
        )
