"""Animated image decoding: GIF / APNG / WebP, the port's own copy of
zaru_tpu/video/anim.py (reference: crates/zaru/src/video/anim.rs).

Frames decode on the host with PIL (imported when an animation is read) into
:class:`~zaru_tpu_torch.image.Image` on the device the caller names.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..image import Image

__all__ = ["Animation", "AnimationFrame"]


class AnimationFrame:
    """One frame plus its display duration (anim.rs:114-140)."""

    def __init__(self, image: Image, duration_s: float):
        self._image = image
        self._duration = duration_s

    def image_view(self) -> Image:
        return self._image

    def duration(self) -> float:
        """Display duration in seconds."""
        return self._duration


class Animation:
    """A decoded animation (anim.rs:26-111)."""

    def __init__(self, frames: list[AnimationFrame]):
        if not frames:
            raise ValueError("animation needs at least one frame")
        self._frames = frames

    @staticmethod
    def _from_pil_source(source, device=None) -> "Animation":
        from PIL import Image as PILImage, ImageSequence

        with PILImage.open(source) as img:
            frames = []
            for frame in ImageSequence.Iterator(img):
                duration_ms = frame.info.get("duration", 100) or 100
                rgba = np.asarray(frame.convert("RGBA"))
                frames.append(
                    AnimationFrame(Image.from_array(rgba, device), duration_ms / 1000.0)
                )
        return Animation(frames)

    @staticmethod
    def from_path(path: str | Path, device=None) -> "Animation":
        return Animation._from_pil_source(path, device)

    @staticmethod
    def from_data(data: bytes, device=None) -> "Animation":
        import io

        return Animation._from_pil_source(io.BytesIO(data), device)

    def frames(self):
        """Iterates over the frames once (anim.rs:95-105)."""
        return iter(self._frames)

    def __len__(self) -> int:
        return len(self._frames)
