"""Perspective-N-Point solving via Direct Linear Transform: the port's
own copy of zaru_tpu/pnp.py (reference: crates/zaru/src/pnp.rs).

Host numpy, as in JAX; points may come as tensors on any device (copied to
the host)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .num import to_numpy

__all__ = ["IntrinsicParams", "Dlt", "DltOutput"]


@dataclass
class IntrinsicParams:
    """Pinhole camera intrinsics (pnp.rs:12-58)."""

    focal_length: float
    pixel_size: tuple[float, float]
    principal_point: tuple[float, float] = (0.0, 0.0)

    def set_principal_point(self, principal_point) -> None:
        self.principal_point = tuple(principal_point)

    def to_matrix(self) -> np.ndarray:
        """3×4 projection matrix (pnp.rs:43-58)."""
        ax = self.focal_length / self.pixel_size[0]
        ay = self.focal_length / self.pixel_size[1]
        u0, v0 = self.principal_point
        return np.array(
            [[ax, 0.0, u0, 0.0], [0.0, ay, v0, 0.0], [0.0, 0.0, 1.0, 0.0]],
            np.float32,
        )


@dataclass
class DltOutput:
    """Recovered camera pose (pnp.rs:153-172)."""

    rotation_matrix: np.ndarray  # [3,3], det=+1
    translation: np.ndarray  # [3]

    def rotation(self) -> np.ndarray:
        return self.rotation_matrix


class Dlt:
    """DLT solver for PnP: recovers camera pose from ≥6 3D↔2D point
    correspondences (pnp.rs:60-151)."""

    def __init__(self, reference):
        ref = np.asarray(list(to_numpy(reference)), np.float32).reshape(-1, 3)
        assert len(ref) >= 6, "DLT needs at least 6 point correspondences"
        self._reference = ref

    def solve(self, projected) -> DltOutput:
        proj = np.asarray(list(to_numpy(projected)), np.float32).reshape(-1, 2)
        assert len(proj) == len(self._reference)
        n = len(proj)

        # Build the 2N×12 DLT matrix (pnp.rs:86-117).
        x, y, z = self._reference.T
        u, v = proj.T
        ones = np.ones(n, np.float32)
        zeros = np.zeros(n, np.float32)
        rows_u = np.stack(
            [x, y, z, ones, zeros, zeros, zeros, zeros, -u * x, -u * y, -u * z, -u],
            axis=-1,
        )
        rows_v = np.stack(
            [zeros, zeros, zeros, zeros, x, y, z, ones, -v * x, -v * y, -v * z, -v],
            axis=-1,
        )
        m = np.empty((2 * n, 12), np.float32)
        m[0::2] = rows_u
        m[1::2] = rows_v

        # Null-space vector = last right-singular vector (pnp.rs:119-125).
        # full_matrices=False: V stays 12x12 (2N >= 12) but skips the
        # unused 2Nx2N U — the reference also computes V only
        # (pnp.rs:119, svd(false, true)).
        _, s, v_t = np.linalg.svd(m, full_matrices=False)
        p = v_t[11].reshape(3, 4)

        # Orthogonalize the rotation part (pnp.rs:127-144).
        uu, ss, vt = np.linalg.svd(p[:, :3])
        rot = uu @ vt
        d = np.sign(np.linalg.det(rot))
        rot = d * rot

        t = d * p[:, 3] / ss[0]
        return DltOutput(rotation_matrix=rot.astype(np.float32), translation=t.astype(np.float32))
