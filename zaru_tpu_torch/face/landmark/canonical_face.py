"""Reference 3-D landmark positions, parsed from the meshes in
``assets/3d`` (the port's own copy of
zaru_tpu/face/landmark/canonical_face.py): ``REFERENCE_POSITIONS`` (the
468-point canonical face mesh) and ``MULTIPIE68_POSITIONS`` (the 68-point
Multi-PIE scheme), each ``[N,3] f32``, read once."""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

_ASSETS_3D = Path(__file__).resolve().parents[3] / "assets" / "3d"


@lru_cache(maxsize=None)
def _load_obj_vertices(name: str) -> np.ndarray:
    verts = []
    with open(_ASSETS_3D / name) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
    return np.asarray(verts, np.float32)


def __getattr__(name):
    if name == "REFERENCE_POSITIONS":
        return _load_obj_vertices("canonical_face_model.obj")
    if name == "MULTIPIE68_POSITIONS":
        return _load_obj_vertices("multipie68.obj")
    raise AttributeError(name)
