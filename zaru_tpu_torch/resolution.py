"""Image resolutions: the port's own copy of ``Resolution``
(zaru_tpu/resolution.py:46)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Resolution"]


@dataclass(frozen=True)
class Resolution:
    """A width×height pixel resolution."""

    width: int
    height: int

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"invalid resolution {self.width}x{self.height}")
