"""SSD anchor generation: the port's own copy of zaru_tpu/detection/ssd.py
(``Anchors`` :31).

Anchors are ``[N, 2] float32`` (x, y) centers in 0..1, ``boxes_per_cell``
duplicates per feature cell, x fastest then y, layers in order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["LayerInfo", "Anchors"]


@dataclass(frozen=True)
class LayerInfo:
    """One SSD output layer: boxes per cell + feature-map size."""

    boxes_per_cell: int
    width: int
    height: int


class Anchors:
    """A list of SSD anchor centers."""

    def __init__(self, centers: np.ndarray):
        if centers.ndim != 2 or centers.shape[1] != 2:
            raise ValueError(f"anchor centers must be [N, 2], got {centers.shape}")
        self.centers = centers.astype(np.float32)

    @staticmethod
    def calculate(layers: list[LayerInfo]) -> "Anchors":
        rows = []
        for layer in layers:
            ys, xs = np.mgrid[0 : layer.height, 0 : layer.width]
            cx = (xs.ravel() + 0.5) / layer.width
            cy = (ys.ravel() + 0.5) / layer.height
            cell = np.stack([cx, cy], axis=-1)
            rows.append(np.repeat(cell, layer.boxes_per_cell, axis=0))
        return Anchors(np.concatenate(rows, axis=0))

    def __len__(self) -> int:
        return len(self.centers)
