"""Unit quaternions (w, x, y, z): the port of zaru_tpu/quat.py
(reference crates/zaru-linalg/src/quat.rs).

Pure functions over float32 arrays: a numpy array in gives numpy out, by
the same numpy operations as the JAX package's numpy branch; a tensor in
gives a tensor on its device (``num.xp`` picks the namespace).
:func:`identity` returns numpy, :func:`from_rotation_matrix` computes on the
host (data-dependent branches), as in JAX.
"""

from __future__ import annotations

import numpy as np

from .num import to_numpy, xp as _xp

__all__ = [
    "identity",
    "normalize",
    "multiply",
    "conjugate",
    "rotate_vec",
    "from_axis_angle",
    "from_rotation_x",
    "from_rotation_y",
    "from_rotation_z",
    "from_euler",
    "to_euler",
    "from_rotation_matrix",
    "to_rotation_matrix",
]


def identity(dtype=np.float32):
    return np.array([1.0, 0.0, 0.0, 0.0], dtype)


def normalize(q):
    xp = _xp(q)
    return q / xp.sqrt(xp.sum(q * q, axis=-1, keepdims=True))


def conjugate(q):
    xp = _xp(q)
    return xp.stack([q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]], axis=-1)


def multiply(a, b):
    """Hamilton product a·b (apply b's rotation, then a's)."""
    xp = _xp(a)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return xp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def rotate_vec(q, v):
    """Rotates 3-vector(s) ``v`` by unit quaternion ``q``."""
    xp = _xp(v)
    qv = q[..., 1:4]
    t = 2.0 * xp.cross(qv, v)
    return v + q[..., 0:1] * t + xp.cross(qv, t)


def from_axis_angle(axis, radians):
    """Unit quaternion rotating by ``radians`` around ``axis [3]``."""
    xp = _xp(axis)
    axis = axis / xp.sqrt(xp.sum(axis * axis, axis=-1, keepdims=True))
    half = xp.asarray(radians, like=axis) / 2.0
    return xp.concatenate(
        [xp.reshape(xp.cos(half), (1,)), axis * xp.sin(half)], axis=-1
    )


def _axis_quat(radians, axis_index: int):
    xp = _xp(radians)
    half = xp.asarray(radians) / 2.0
    c, s = xp.cos(half), xp.sin(half)
    zero = xp.zeros_like(s)
    parts = [c] + [zero, zero, zero]
    parts[1 + axis_index] = s
    return xp.stack(parts, axis=-1)


def from_rotation_x(radians):
    return _axis_quat(radians, 0)


def from_rotation_y(radians):
    return _axis_quat(radians, 1)


def from_rotation_z(radians):
    return _axis_quat(radians, 2)


def from_euler(roll, pitch, yaw):
    """Aerospace ZYX euler (roll about X, pitch about Y, yaw about Z,
    applied X-then-Y-then-Z extrinsically) → quaternion."""
    return multiply(from_rotation_z(yaw), multiply(from_rotation_y(pitch), from_rotation_x(roll)))


def to_euler(q):
    """Quaternion → (roll, pitch, yaw), inverse of :func:`from_euler`.
    Returns arrays of the input's namespace."""
    xp = _xp(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = xp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = xp.arcsin(xp.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = xp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def to_rotation_matrix(q):
    xp = _xp(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return xp.stack(
        [
            xp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
            xp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
            xp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def from_rotation_matrix(m):
    """Rotation matrix [3,3] → unit quaternion (numerically robust), float32
    numpy, computed on the host (data-dependent branching)."""
    m = np.asarray(to_numpy(m), np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z], np.float32)
    return q / np.linalg.norm(q)
