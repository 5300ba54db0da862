"""Procrustes analysis: rigid + uniform-scale alignment via the Kabsch
algorithm, the port of zaru_tpu/procrustes.py (reference:
crates/zaru/src/procrustes.rs).

The core, :func:`procrustes_align`, is a pure function over ``[...,N,3]``
arrays: numpy arrays run the JAX package's numpy branch op for op, tensors
run the same operations on their device (``num.xp``; the 3×3 SVD is
``torch.linalg.svd``). Its singular vectors may come out with other signs
than numpy's, and the ``sign(det)`` correction of the Kabsch rotation makes
the rotation the same either way. :class:`ProcrustesAnalyzer` and
:class:`AnalysisResult` are the host API on numpy, as in JAX; they take
tensors too (copied to the host).
"""

from __future__ import annotations

import numpy as np

from .num import to_numpy, xp as _xp

__all__ = ["ProcrustesAnalyzer", "AnalysisResult", "procrustes_align"]


def _remove_translation(points):
    xp = _xp(points)
    centroid = xp.mean(points, axis=-2)
    return points - centroid[..., None, :], centroid


def _remove_scale(points):
    """RMS-distance scale normalization (procrustes.rs:177-195).

    A zero scale (all points identical) divides by 1 instead so no NaNs
    reach the SVD; the caller replaces the rotation with identity in that
    case (procrustes.rs:107-112).
    """
    xp = _xp(points)
    scale = xp.sqrt(xp.mean(xp.sum(points * points, axis=-1), axis=-1))
    safe = xp.where(scale == 0.0, xp.ones_like(scale), scale)
    return points / safe[..., None, None], scale


def _kabsch_rotation(p, q):
    """Rotation matrix turning reference ``q [N,3]`` into data ``p [N,3]``
    (both centered+normalized), det=+1 (procrustes.rs:138-162)."""
    xp = _xp(p)
    cov = xp.swapaxes(p, -1, -2) @ q  # P^T · Q, 3x3
    u, _s, v_t = xp.linalg.svd(cov)
    d = xp.sign(xp.linalg.det(v_t @ u))
    # U · diag(1,1,d) · V^T
    u_adj = xp.concatenate([u[..., :, :2], u[..., :, 2:] * d[..., None, None]], axis=-1)
    return u_adj @ v_t


def procrustes_align(reference, points):
    """Pure functional core: returns (rotation [3,3], scale, translation [3],
    centroid [3]) mapping ``reference`` onto ``points`` (both [...,N,3])."""
    xp = _xp(points)
    ref_c, ref_centroid = _remove_translation(xp.asarray(reference, like=points))
    ref_n, ref_scale = _remove_scale(ref_c)

    pts_c, centroid = _remove_translation(xp.asarray(points))
    pts_n, scale = _remove_scale(pts_c)

    rotation = _kabsch_rotation(pts_n, ref_n)
    # Degenerate data (all points identical): rotation unrecoverable.
    eye = xp.eye(3, dtype=rotation.dtype, like=rotation)
    rotation = xp.where(
        xp.asarray(scale == 0.0)[..., None, None], eye, rotation
    )
    rel_scale = scale / ref_scale
    centroid_offset = (rotation @ ref_centroid[..., None])[..., 0] * rel_scale[..., None]
    translation = centroid - centroid_offset
    return rotation, rel_scale, translation, centroid


class AnalysisResult:
    """Recovered transform (procrustes.rs:197-263)."""

    def __init__(self, rotation, scale, translation, centroid, ref_centroid):
        self._rotation = np.asarray(to_numpy(rotation), np.float32)
        self._scale = float(scale)
        self._translation = np.asarray(to_numpy(translation), np.float32)
        self._centroid = np.asarray(to_numpy(centroid), np.float32)
        self._ref_centroid = np.asarray(to_numpy(ref_centroid), np.float32)

    def centroid(self) -> np.ndarray:
        return self._centroid

    def translation(self) -> np.ndarray:
        return self._translation

    def rotation_matrix(self) -> np.ndarray:
        """Rotation applied to the reference around its centroid."""
        return self._rotation

    def rotation_quaternion(self) -> np.ndarray:
        """Unit quaternion (w, x, y, z).

        Shepperd's method: the near-180° fallback must branch on the
        LARGEST diagonal element — always using the x-diagonal returns a
        180°-about-X quaternion for a 180° rotation about Y or Z (the
        x-branch radicand is 0 there and the division degenerates).
        Matches nalgebra's robust from_rotation_matrix (the reference's
        path, procrustes.rs:197-263).
        """
        m = self._rotation.astype(np.float64)
        t = m[0, 0] + m[1, 1] + m[2, 2]
        if t > max(m[0, 0], m[1, 1], m[2, 2]):
            s = np.sqrt(1.0 + t) * 2.0
            w = s / 4.0
            x = (m[2, 1] - m[1, 2]) / s
            y = (m[0, 2] - m[2, 0]) / s
            z = (m[1, 0] - m[0, 1]) / s
        elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
            s = np.sqrt(max(1e-18, 1.0 + m[0, 0] - m[1, 1] - m[2, 2])) * 2.0
            w = (m[2, 1] - m[1, 2]) / s
            x = s / 4.0
            y = (m[0, 1] + m[1, 0]) / s
            z = (m[0, 2] + m[2, 0]) / s
        elif m[1, 1] >= m[2, 2]:
            s = np.sqrt(max(1e-18, 1.0 - m[0, 0] + m[1, 1] - m[2, 2])) * 2.0
            w = (m[0, 2] - m[2, 0]) / s
            x = (m[0, 1] + m[1, 0]) / s
            y = s / 4.0
            z = (m[1, 2] + m[2, 1]) / s
        else:
            s = np.sqrt(max(1e-18, 1.0 - m[0, 0] - m[1, 1] + m[2, 2])) * 2.0
            w = (m[1, 0] - m[0, 1]) / s
            x = (m[0, 2] + m[2, 0]) / s
            y = (m[1, 2] + m[2, 1]) / s
            z = s / 4.0
        q = np.array([w, x, y, z], np.float32)
        return q / np.linalg.norm(q)

    def scale(self) -> float:
        return self._scale

    def transform(self) -> np.ndarray:
        """Homogeneous 4×4: move reference to origin, rotate+scale, move to
        the data centroid (procrustes.rs:85-91)."""
        t_ref = np.eye(4, dtype=np.float32)
        t_ref[:3, 3] = -self._ref_centroid
        rs = np.eye(4, dtype=np.float32)
        rs[:3, :3] = self._rotation * self._scale
        t_c = np.eye(4, dtype=np.float32)
        t_c[:3, 3] = self._centroid
        return t_c @ rs @ t_ref


class ProcrustesAnalyzer:
    """Fits data points to a fixed reference point set
    (procrustes.rs:16-162)."""

    def __init__(self, reference):
        reference = to_numpy(reference)
        ref = np.asarray(
            [list(p) for p in reference] if not isinstance(reference, np.ndarray) else reference,
            np.float32,
        ).reshape(-1, 3)
        assert len(ref) > 1, "need at least 2 points for procrustes analysis"
        self._reference = ref
        self._ref_centroid = ref.mean(axis=0)

    def reference_centroid(self) -> np.ndarray:
        return self._ref_centroid

    def analyze(self, points) -> AnalysisResult:
        points = to_numpy(points)
        pts = np.asarray(
            [list(p) for p in points] if not isinstance(points, np.ndarray) else points,
            np.float32,
        ).reshape(-1, 3)
        assert len(pts) == len(self._reference), (
            "`analyze` called on data of different length than the reference"
        )
        rotation, scale, translation, centroid = procrustes_align(
            self._reference, pts
        )
        return AnalysisResult(
            rotation, scale, translation, centroid, self._ref_centroid
        )
