"""Image resolutions and aspect ratios: the port's own copy of
``AspectRatio`` and ``Resolution`` (zaru_tpu/resolution.py:23,46)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["AspectRatio", "Resolution"]


def _gcd(a: int, b: int) -> int:
    while b > 0:
        a, b = b, a % b
    return a


@dataclass(frozen=True)
class AspectRatio:
    """A ratio of width to height."""

    width: int
    height: int

    @staticmethod
    def new(width: int, height: int) -> "AspectRatio | None":
        if width == 0 or height == 0:
            return None
        g = _gcd(width, height)
        return AspectRatio(width // g, height // g)

    def as_f32(self) -> np.float32:
        return np.float32(np.float32(self.width) / np.float32(self.height))

    def __str__(self) -> str:
        return f"{self.width}:{self.height}"


AspectRatio.SQUARE = AspectRatio(1, 1)


@dataclass(frozen=True)
class Resolution:
    """A width×height pixel resolution."""

    width: int
    height: int

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"invalid resolution {self.width}x{self.height}")

    def num_pixels(self) -> int:
        return self.width * self.height

    def aspect_ratio(self) -> AspectRatio | None:
        return AspectRatio.new(self.width, self.height)
