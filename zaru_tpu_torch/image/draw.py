"""Debug drawing onto images: the port's own copy of
zaru_tpu/image/draw.py (reference: crates/zaru/src/image/draw.rs and
crates/zaru-image/src/draw/).

Drawing is a host-side debug facility — it never sits on the perception hot
path — so it renders on a NumPy copy and re-uploads. ``rect`` and
``marker`` are drawn with NumPy (their lines are axis-aligned: the pixels
``cv2.rectangle`` and ``cv2.drawMarker`` set, so they need no OpenCV, which
a GPU machine may lack); the slanted lines and text use OpenCV. The API
mirrors the reference's chained calls (``draw.rect(img, r).color(c)``),
with drawing executed when the chain is dropped/flushed or immediately via
keyword arguments.
"""

from __future__ import annotations

import numpy as np

from ..color import Color
from ..rect import Rect, RotatedRect

__all__ = ["rect", "rotated_rect", "marker", "line", "text", "quaternion", "Canvas"]


class Canvas:
    """A mutable host-side drawing surface over an :class:`Image`.

    Batches all draw calls on a NumPy array and uploads once on ``flush()``
    (the reference's GPU draw executes on guard drop; here the canvas
    amortizes the host↔device roundtrip instead).
    """

    def __init__(self, image):
        from . import Image

        self._image = image
        # Device readback gives a read-only view; cv2 needs a writable copy.
        self._arr = np.array(image.to_numpy(), copy=True)

    @property
    def array(self) -> np.ndarray:
        return self._arr

    def flush(self):
        """Uploads the drawn result back into a new Image on the source
        image's device."""
        from . import Image

        return Image(self._arr, self._image.device)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _canvas_of(target) -> tuple[Canvas, bool]:
    if isinstance(target, Canvas):
        return target, False
    return Canvas(target), True


def _bgr(color: Color):
    # cv2 draws on RGBA arrays with the channel order given; pass RGBA.
    return (int(color.r), int(color.g), int(color.b), int(color.a))


def _span(arr: np.ndarray, x0: int, y0: int, x1: int, y1: int, color: Color) -> None:
    """A one-pixel horizontal or vertical line from ``(x0, y0)`` to
    ``(x1, y1)``, both ends included, clipped to the image: the pixels
    ``cv2.line`` sets for it (thickness 1, 8-connected)."""
    h, w = arr.shape[:2]
    value = np.array(_bgr(color)[: arr.shape[2]], arr.dtype)
    if y0 == y1:
        a, b = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
        if 0 <= y0 < h and a <= b:
            arr[y0, a:b + 1] = value
    elif x0 == x1:
        a, b = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
        if 0 <= x0 < w and a <= b:
            arr[a:b + 1, x0] = value
    else:
        raise ValueError(f"({x0}, {y0}) → ({x1}, {y1}) is not axis-aligned")


def rect(target, r: Rect, color: Color = Color.RED):
    """Axis-aligned rectangle outline (draw.rs:254-261): the four edges
    ``cv2.rectangle`` draws at thickness 1."""
    canvas, own = _canvas_of(target)
    x0, y0 = (int(v) for v in r.top_left().astype(int))
    x1, y1 = (int(v) for v in (r.top_left() + r.size()).astype(int))
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)), ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
        _span(canvas.array, *a, *b, color)
    return canvas.flush() if own else None


def rotated_rect(target, rr: RotatedRect, color: Color = Color.RED):
    """Rotated rectangle outline (draw.rs:263-272)."""
    import cv2

    canvas, own = _canvas_of(target)
    corners = rr.rotated_corners().astype(np.int32)
    cv2.polylines(canvas.array, [corners.reshape(-1, 1, 2)], True, _bgr(color), 1)
    return canvas.flush() if own else None


def marker(target, pos, size: int = 5, color: Color = Color.GREEN):
    """Cross marker at a position (draw.rs:274-282): the two lines of
    ``cv2.drawMarker``'s ``MARKER_CROSS`` at thickness 1, ``size // 2``
    pixels each side."""
    canvas, own = _canvas_of(target)
    x, y = int(round(float(pos[0]))), int(round(float(pos[1])))
    half = max(1, size) // 2
    _span(canvas.array, x - half, y, x + half, y, color)
    _span(canvas.array, x, y - half, x, y + half, color)
    return canvas.flush() if own else None


def line(target, start, end, color: Color = Color.BLUE):
    """Line segment (draw.rs:284-298)."""
    import cv2

    canvas, own = _canvas_of(target)
    p0 = (int(round(float(start[0]))), int(round(float(start[1]))))
    p1 = (int(round(float(end[0]))), int(round(float(end[1]))))
    cv2.line(canvas.array, p0, p1, _bgr(color), 1)
    return canvas.flush() if own else None


def text(
    target,
    pos,
    s: str,
    color: Color = Color.WHITE,
    align: str = "center",
    scale: float = 0.35,
):
    """Text label; ``align`` in {center, top, bottom, left, right}
    (draw.rs:300-320)."""
    import cv2

    canvas, own = _canvas_of(target)
    (tw, th), _ = cv2.getTextSize(s, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)
    x, y = float(pos[0]), float(pos[1])
    if align in ("center", "top", "bottom"):
        x -= tw / 2
    if align == "right":
        x -= tw
    if align in ("center", "left", "right"):
        y += th / 2
    if align == "top":
        y += th  # anchor point above the text
    cv2.putText(
        canvas.array,
        s,
        (int(round(x)), int(round(y))),
        cv2.FONT_HERSHEY_SIMPLEX,
        scale,
        _bgr(color),
        1,
        cv2.LINE_AA,
    )
    return canvas.flush() if own else None


def quaternion(target, pos, quat_wxyz, axis_length: float = 10.0):
    """Draws a rotation as RGB XYZ axes (draw.rs:219-251). ``quat_wxyz`` is
    a unit quaternion (w, x, y, z)."""
    w, x, y, z = (float(v) for v in quat_wxyz)

    def rotate(v):
        # q v q* for a pure vector v.
        qv = np.array([x, y, z])
        t = 2.0 * np.cross(qv, v)
        return v + w * t + np.cross(qv, t)

    canvas, own = _canvas_of(target)
    origin = np.array([float(pos[0]), float(pos[1])])
    for axis, color in zip(np.eye(3), (Color.RED, Color.GREEN, Color.BLUE)):
        end3 = rotate(axis * axis_length)
        # Flip Y: 3D Y points up, image Y points down (draw.rs:242-245).
        end = origin + [end3[0], -end3[1]]
        line(canvas, origin, end, color=color)
    return canvas.flush() if own else None
