"""Images and rotated-rect views (zaru_tpu/image/__init__.py:42 ``Image``,
:136 ``ImageView``).

An :class:`Image` is an RGBA uint8 ``[H, W, 4]`` tensor on an explicit
device (``cuda`` unless the caller names another; without a GPU that
raises). Views are lazy: an :class:`ImageView` is the image plus a rotated
rect in root coordinates, composed like the reference (image/mod.rs:201-210)
and materialised by the exact sampler (``ops.sampling.sample_view``), bit
for bit as JAX's jitted ``sample_view``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Protocol, Union

import numpy as np
import torch

from .._device import resolve_device
from ..color import Color
from ..ops.sampling import sample_view, sample_view_rgba
from ..rect import Rect, RotatedRect, rrect_compose
from ..resolution import AspectRatio, Resolution
from . import decode as _decode

__all__ = ["Image", "ImageView", "AsImageView", "as_view"]

RectLike = Union[Rect, RotatedRect]


def _to_rrect(rect: RectLike) -> RotatedRect:
    if isinstance(rect, Rect):
        return RotatedRect.from_rect(rect)
    return rect


class Image:
    """An RGBA8 image stored as a ``[H, W, 4] uint8`` tensor on ``device``
    (``cuda`` unless named)."""

    def __init__(self, data, device=None):
        dev = resolve_device(device)
        if not isinstance(data, torch.Tensor):
            arr = np.asarray(data)
            data = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        if data.dtype != torch.uint8 or data.ndim != 3 or data.shape[2] != 4:
            raise ValueError(f"an Image is [H, W, 4] uint8, got {tuple(data.shape)} {data.dtype}")
        self._data = data.to(dev)

    # --- constructors -------------------------------------------------------
    @staticmethod
    def new(width: int, height: int, device=None) -> "Image":
        """A transparent black image (image.rs:78-88)."""
        return Image(np.zeros((height, width, 4), np.uint8), device)

    @staticmethod
    def filled(width: int, height: int, color: Color, device=None) -> "Image":
        return Image(np.broadcast_to(color.as_array(), (height, width, 4)).copy(), device)

    @staticmethod
    def from_rgba8(width: int, height: int, buf, device=None) -> "Image":
        arr = np.frombuffer(bytes(buf), np.uint8).reshape(height, width, 4)
        return Image(arr.copy(), device)

    @staticmethod
    def from_rgb8(width: int, height: int, buf, device=None) -> "Image":
        rgb = np.frombuffer(bytes(buf), np.uint8).reshape(height, width, 3)
        return Image(np.concatenate([rgb, np.full_like(rgb[..., :1], 255)], -1), device)

    @staticmethod
    def from_array(arr, device=None) -> "Image":
        """From an ``[H, W, 3|4] uint8`` array."""
        arr = np.asarray(arr)
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, np.full_like(arr[..., :1], 255)], -1)
        return Image(np.ascontiguousarray(arr), device)

    @staticmethod
    def load(path: str | Path, device=None) -> "Image":
        """Decodes a JPEG/PNG/GIF/... file (decode.rs:29-75)."""
        return Image.from_array(_decode.load_image(path), device)

    @staticmethod
    def decode_jpeg(data: bytes, device=None) -> "Image":
        return Image.from_array(_decode.decode_jpeg(data), device)

    # --- accessors ----------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """The underlying ``[H, W, 4] uint8`` tensor."""
        return self._data

    @property
    def device(self) -> torch.device:
        return self._data.device

    def width(self) -> int:
        return self._data.shape[1]

    def height(self) -> int:
        return self._data.shape[0]

    def resolution(self) -> Resolution:
        return Resolution(self.width(), self.height())

    def rect(self) -> Rect:
        return Rect.from_top_left(0.0, 0.0, float(self.width()), float(self.height()))

    def aspect_ratio(self) -> AspectRatio | None:
        return self.resolution().aspect_ratio()

    def to_numpy(self) -> np.ndarray:
        """Host copy (reference image.rs:185-230 ``with_data``)."""
        return self._data.cpu().numpy()

    def get(self, x: int, y: int) -> Color:
        r, g, b, a = (int(v) for v in self._data[y, x].tolist())
        return Color(r, g, b, a)

    def set(self, x: int, y: int, color: Color) -> None:
        """Sets one pixel (debug and drawing use)."""
        self._data[y, x] = torch.from_numpy(color.as_array()).to(self._data.device)

    # --- views --------------------------------------------------------------
    def as_view(self) -> "ImageView":
        return ImageView(self, RotatedRect.from_rect(self.rect()))

    def view(self, rect: RectLike) -> "ImageView":
        return self.as_view().view(rect)

    def __repr__(self) -> str:
        return f"{self.width()}x{self.height()} Image"


class ImageView:
    """An immutable rotated-rect view of an :class:`Image`
    (reference image/mod.rs:252-331, zaru-image/src/view.rs:44-123).

    ``rect`` is stored in *root image* coordinates; nested views compose by
    adding rotations and mapping centres through the parent's transform.
    """

    def __init__(self, image: Image, data_rect: RotatedRect):
        self._image = image
        self._rect = data_rect  # root-image coordinates

    @property
    def image(self) -> Image:
        return self._image

    @property
    def view_rect(self) -> RotatedRect:
        """The view's rotated rect in root-image coordinates."""
        return self._rect

    def rect(self) -> Rect:
        """A rect of this view's size positioned at (0,0)
        (image/mod.rs:211-214)."""
        r = self._rect.rect()
        return Rect.from_top_left(0.0, 0.0, r.width(), r.height())

    def width(self) -> float:
        return self._rect.rect().width()

    def height(self) -> float:
        return self._rect.rect().height()

    def as_view(self) -> "ImageView":
        return self

    def view(self, rect: RectLike) -> "ImageView":
        """Creates a sub-view; composition per image/mod.rs:201-210."""
        sub = _to_rrect(rect)
        composed = rrect_compose(
            self._rect.array.astype(np.float32), sub.array.astype(np.float32)
        )
        return ImageView(self._image, RotatedRect(np.asarray(composed)))

    def _rrect(self, rr: RotatedRect) -> torch.Tensor:
        return torch.from_numpy(rr.array.copy()).to(self._image.device)

    def to_image(self) -> Image:
        """Materialises the view (size rounded up; image/mod.rs:318-331) on
        the image's device."""
        w = int(np.ceil(self.width()))
        h = int(np.ceil(self.height()))
        return Image(sample_view(self._image.data, self._rrect(self._rect), w, h), self._image.device)

    def get(self, x: int, y: int) -> Color:
        """Single-pixel view read (image/mod.rs:296-303): a 1×1 sub-view,
        so the pixel is the one :meth:`to_image` would give."""
        sub = self.view(Rect.from_top_left(float(x), float(y), 1.0, 1.0))
        one = sample_view_rgba(self._image.data, self._rrect(sub._rect), 1, 1, scale_to_view=False)
        r, g, b, a = (int(v) for v in one[0, 0].tolist())
        return Color(r, g, b, a)

    def __repr__(self) -> str:
        return f"ImageView @ {self._rect!r}"


class AsImageView(Protocol):
    def as_view(self) -> ImageView: ...


def as_view(obj) -> ImageView:
    if isinstance(obj, ImageView):
        return obj
    return obj.as_view()
