"""Plain PyTorch samplers (zaru_tpu/ops/sampling.py).

``letterbox_sample_core`` (sampling.py:120) is the plain version of the
letterbox kernel in :mod:`.letterbox`; ``view_to_tensor_core`` (:88) is the
exact rotated-view sampler the JAX package keeps beside its fast one. Both
run batched over streams here (the JAX functions are per view and
``vmap``-ed) and keep the JAX f32 operation order, so they are bit-exact to
it: nearest-neighbour source pixels chosen with round-half-away, reads
outside the frame are black (0, 0, 0, 0), and the colour map is
``c·(hi−lo)/255 + lo`` (see :func:`color_map`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import rrect_transform_out
from ..num import div, round_half_away

__all__ = [
    "letterbox_sample_core", "view_to_tensor_core", "color_adjust", "color_map",
]


def color_adjust(lo: float, hi: float) -> float:
    """The colour map's f32 scale ``(hi - lo) / f32(255)`` as
    sampling.py:160 computes it (an f32 division under NumPy 2)."""
    return float(np.float32(hi - lo) / np.float32(255.0))


def color_map(rgb, adjust: float, lo: float):
    """``rgb * adjust + lo`` for u8-valued channels, rounded once, as a
    fused multiply-add rounds it.

    That is what the JAX samplers compute once compiled: XLA:CPU contracts
    their colour map into an FMA (op by op, JAX rounds twice). The product
    of an 8-bit channel and an f32 scale is exact in float64, and so is its
    sum with an f32 ``lo`` of the colour ranges in use ([-1, 1], [0, 1],
    [0, 255]), so one rounding to f32 gives the FMA's result.
    """
    return (rgb.to(torch.float64) * adjust + lo).to(torch.float32)


def _gather_rgb(frames_u8, bidx, yi, xi, ok):
    """RGB of ``frames_u8 [B,H,W,4]`` at integer indices, black where not
    ``ok`` (the indices are masked before the gather: torch indexing wraps
    negative indices)."""
    B, H, W, _ = frames_u8.shape
    flat = frames_u8.reshape(B * H * W, 4)
    lin = torch.where(ok, (bidx * H + yi) * W + xi, torch.zeros_like(xi))
    rgb = flat[lin.reshape(-1)][:, :3].reshape(*lin.shape, 3)
    return torch.where(ok[..., None], rgb, torch.zeros_like(rgb))


def _letterbox_index(frames_u8, rrects, out_w: int, out_h: int):
    """The letterbox's separable index map (sampling.py:135-146, op for op):
    source rows ``yi [B,out_h,1]`` and columns ``xi [B,1,out_w]`` (0 where
    outside the frame) and ``ok [B,out_h,out_w]``."""
    B, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    u = div(torch.arange(out_w, dtype=torch.float32, device=dev), out_w)
    v = div(torch.arange(out_h, dtype=torch.float32, device=dev), out_h)
    xv = round_half_away(u[None, :] * rrects[:, 2:3])  # [B, out_w]
    yv = round_half_away(v[None, :] * rrects[:, 3:4])  # [B, out_h]
    wc = rrects[:, 2:3] * 0.5
    hc = rrects[:, 3:4] * 0.5
    fx = ((xv + 0.5) - wc) + wc + (rrects[:, 0:1] - wc)
    fy = ((yv + 0.5) - hc) + hc + (rrects[:, 1:2] - hc)
    xr = round_half_away(fx - 0.5)
    yr = round_half_away(fy - 0.5)
    okx = (xr >= 0) & (xr < W)
    oky = (yr >= 0) & (yr < H)
    xi = torch.where(okx, xr, 0.0).to(torch.int64)[:, None, :]
    yi = torch.where(oky, yr, 0.0).to(torch.int64)[:, :, None]
    return yi, xi, oky[:, :, None] & okx[:, None, :]


def letterbox_sample_core(frames_u8, rrects, out_w: int, out_h: int, lo: float, hi: float):
    """Exact axis-aligned view sample + colour map, batched over streams.

    ``frames_u8 [B,H,W,4] u8``, ``rrects [B,5] f32`` (angle ignored: the
    full-frame letterbox fit has angle 0) → ``[B,out_h,out_w,3] f32`` NHWC.
    The separable index vectors follow sampling.py:135-146 op for op.
    """
    yi, xi, ok = _letterbox_index(frames_u8, rrects, out_w, out_h)
    bidx = torch.arange(frames_u8.shape[0], device=frames_u8.device)[:, None, None]
    rgb = _gather_rgb(frames_u8, bidx, yi, xi, ok)
    return color_map(rgb, color_adjust(lo, hi), float(np.float32(lo)))


def view_to_tensor_core(
    frames_u8, rrects, out_w: int, out_h: int, lo: float = -1.0, hi: float = 1.0,
    layout: str = "NCHW",
):
    """Exact rotated-view sample + colour map, batched over streams
    (sampling.py:88 with ``_view_grid`` :50).

    ``frames_u8 [B,H,W,4] u8``, ``rrects [B,5] f32`` → ``[B,3,out_h,out_w]``
    (NCHW) or ``[B,out_h,out_w,3]`` (NHWC) f32.
    """
    B, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    u = div(torch.arange(out_w, dtype=torch.float32, device=dev), out_w)
    v = div(torch.arange(out_h, dtype=torch.float32, device=dev), out_h)
    xv = round_half_away(u[None, :] * rrects[:, 2:3])  # [B, out_w]
    yv = round_half_away(v[None, :] * rrects[:, 3:4])  # [B, out_h]
    gx = (xv + 0.5)[:, None, :].expand(B, out_h, out_w)
    gy = (yv + 0.5)[:, :, None].expand(B, out_h, out_w)
    root = rrect_transform_out(rrects[:, None, None, :], torch.stack([gx, gy], dim=-1))
    xr = round_half_away(root[..., 0] - 0.5)
    yr = round_half_away(root[..., 1] - 0.5)
    ok = (xr >= 0) & (yr >= 0) & (xr < W) & (yr < H)
    xi = torch.where(ok, xr, 0.0).to(torch.int64)
    yi = torch.where(ok, yr, 0.0).to(torch.int64)
    bidx = torch.arange(B, device=dev)[:, None, None]
    rgb = _gather_rgb(frames_u8, bidx, yi, xi, ok)
    mapped = color_map(rgb, color_adjust(lo, hi), float(np.float32(lo)))
    if layout == "NCHW":
        return mapped.permute(0, 3, 1, 2)
    return mapped
