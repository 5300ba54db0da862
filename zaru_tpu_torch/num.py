"""Small numeric helpers (zaru_tpu/num.py:23-60).

All of them keep the f32 results of the JAX package bit for bit where the
arithmetic is IEEE: ``torch.round`` rounds half to even and is never used
for pixel coordinates, and division by a Python number goes through
:func:`div`. :func:`sigmoid_np` and :func:`total_f32_key` serve the host
engines (numpy), as the JAX package's numpy branch of ``sigmoid`` and its
``total_f32_key`` do.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["round_half_away", "sigmoid", "sigmoid_np", "div", "fma", "recip", "total_f32_key"]


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


def recip(n: int) -> float:
    """``f32(1/n)``: XLA compiles ``x / n`` for a constant ``n`` into
    ``x * f32(1/n)``, which can be one ulp off the quotient when ``n`` is
    not a power of two; the samplers' index maps follow it."""
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
