"""Small numeric helpers (zaru_tpu/num.py:23-60).

All of them keep the f32 results of the JAX package bit for bit where the
arithmetic is IEEE: ``torch.round`` rounds half to even and is never used
for pixel coordinates, and division by a Python number goes through
:func:`div`. :func:`sigmoid_np` and :func:`total_f32_key` serve the host
engines (numpy), as the JAX package's numpy branch of ``sigmoid`` and its
``total_f32_key`` do. :func:`xp` picks numpy or :data:`torch_np` for a
value, as the JAX package's ``_xp`` (num.py:14) picks numpy or
``jax.numpy``: ``quat.py`` and ``procrustes.py`` run one body on either.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "round_half_away", "sigmoid", "sigmoid_np", "div", "fma", "recip", "total_f32_key", "to_numpy", "torch_np",
    "xp",
]


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, Rust's ``f32::round``
    (zaru_tpu/num.py:32)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable logistic sigmoid (zaru_tpu/num.py:23)."""
    pos = torch.where(x >= 0, x, 0.0)
    neg = torch.where(x < 0, x, 0.0)
    return torch.where(
        x >= 0, 1.0 / (1.0 + torch.exp(-pos)), torch.exp(neg) / (1.0 + torch.exp(neg))
    )


def sigmoid_np(x: np.ndarray) -> np.ndarray:
    """:func:`sigmoid` on the host, in numpy (zaru_tpu/num.py:23 on a numpy
    array)."""
    pos = np.where(x >= 0, x, 0.0)
    neg = np.where(x < 0, x, 0.0)
    return np.where(x >= 0, 1.0 / (1.0 + np.exp(-pos)), np.exp(neg) / (1.0 + np.exp(neg)))


def total_f32_key(x: float) -> int:
    """Sort key of IEEE 754 totalOrder on f32, the reference's ``TotalF32``
    (zaru_tpu/num.py:43): -NaN < -inf < … < -0.0 < +0.0 < … < +inf < +NaN.
    The bits as an unsigned integer, all but the sign flipped for negatives
    and the sign set for the others."""
    bits = int(np.float32(x).view(np.uint32))
    if bits & 0x8000_0000:
        return 0xFFFF_FFFF - bits
    return bits | 0x1_0000_0000


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` for a Python number ``d``, correctly rounded on every device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can be one ulp off the quotient; JAX divides. A 0-dim
    tensor on ``x``'s device takes the true division.
    """
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def recip(n: float) -> float:
    """``f32(1) / f32(n)``: XLA compiles ``x / n`` for a constant ``n`` into
    ``x * f32(1/n)``, which can be one ulp off the quotient when ``n`` is
    not a power of two; the samplers' index maps and the blend follow it."""
    return float(np.float32(1.0) / np.float32(n))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors of one shape, rounded once, as CUDA's
    ``__fmaf_rn`` and XLA's contracted multiply-add round it.

    The product of two f32 numbers is exact in f64. The f64 sum is then
    rounded to odd (the TwoSum error picks the odd neighbour when the sum
    is inexact), and rounding that to f32 is the correctly rounded result:
    f64 keeps more than two bits beyond f32's.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    odd = torch.where((err != 0) & ((s.view(torch.int64) & 1) == 0), torch.nextafter(s, toward), s)
    return odd.float()


class _TorchLinalg:
    svd = staticmethod(torch.linalg.svd)
    det = staticmethod(torch.linalg.det)


class _TorchNumpy:
    """The numpy functions ``quat.py`` and ``procrustes.py`` call, with
    numpy's names and keywords, on torch tensors. Results stay on the
    inputs' device; a new array goes to the device of ``like``."""

    linalg = _TorchLinalg
    sqrt = staticmethod(torch.sqrt)
    cos = staticmethod(torch.cos)
    sin = staticmethod(torch.sin)
    arctan2 = staticmethod(torch.atan2)
    arcsin = staticmethod(torch.asin)
    sign = staticmethod(torch.sign)
    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)
    ones_like = staticmethod(torch.ones_like)
    swapaxes = staticmethod(torch.swapaxes)
    reshape = staticmethod(torch.reshape)

    @staticmethod
    def asarray(x, dtype=None, like=None):
        return torch.as_tensor(x, dtype=dtype, device=None if like is None else like.device)

    @staticmethod
    def eye(n, dtype=None, like=None):
        return torch.eye(n, dtype=dtype, device=None if like is None else like.device)

    @staticmethod
    def sum(x, axis=None, keepdims=False):
        return torch.sum(x, dim=axis, keepdim=keepdims)

    @staticmethod
    def mean(x, axis=None):
        return torch.mean(x, dim=axis)

    @staticmethod
    def stack(arrays, axis=0):
        return torch.stack(arrays, dim=axis)

    @staticmethod
    def concatenate(arrays, axis=0):
        return torch.cat(arrays, dim=axis)

    @staticmethod
    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)


torch_np = _TorchNumpy()


def xp(x):
    """The array namespace of ``x`` (zaru_tpu/num.py:14 ``_xp``):
    :data:`torch_np` for a tensor, numpy for anything else."""
    return torch_np if isinstance(x, torch.Tensor) else np


def to_numpy(x):
    """A host numpy copy of a tensor on any device; anything else as it
    is (for the numpy-only host classes, which take tensors too)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
