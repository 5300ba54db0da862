"""sRGB colours: the port's own copy of zaru_tpu/color.py (reference:
crates/zaru-image/src/color.rs)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Color:
    """An 8-bit sRGBA color (color.rs:6)."""

    r: int
    g: int
    b: int
    a: int = 255

    @staticmethod
    def from_rgb8(r: int, g: int, b: int) -> "Color":
        return Color(r, g, b, 255)

    @staticmethod
    def from_rgba8(r: int, g: int, b: int, a: int) -> "Color":
        return Color(r, g, b, a)

    def with_alpha(self, a: int) -> "Color":
        return Color(self.r, self.g, self.b, a)

    def to_linear(self) -> np.ndarray:
        """sRGB EOTF → linear float RGBA in [0,1] (color.rs:58-73)."""
        srgb = np.array([self.r, self.g, self.b], dtype=np.float32) / 255.0
        lin = np.where(
            srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4
        )
        return np.concatenate([lin, [np.float32(self.a) / 255.0]]).astype(np.float32)

    def as_array(self) -> np.ndarray:
        return np.array([self.r, self.g, self.b, self.a], dtype=np.uint8)


Color.NONE = Color(0, 0, 0, 0)
Color.BLACK = Color(0, 0, 0, 255)
Color.WHITE = Color(255, 255, 255, 255)
Color.RED = Color(255, 0, 0, 255)
Color.GREEN = Color(0, 255, 0, 255)
Color.BLUE = Color(0, 0, 255, 255)
Color.YELLOW = Color(255, 255, 0, 255)
Color.MAGENTA = Color(255, 0, 255, 255)
Color.CYAN = Color(0, 255, 255, 255)
