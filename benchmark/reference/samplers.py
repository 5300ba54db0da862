"""The plain samplers, frozen: nearest-neighbour crops of RGBA u8 frames,
colour-mapped to float32, in the f32 operation order the cascade's
published behaviour fixes.

- :func:`letterbox`: the axis-aligned full-frame view a detector reads;
- :func:`rotated_prescaled`: a rotated view read through an integer-stride
  prescale grid of side ``prescale_m`` (the batched tracker's crop);
- :func:`rotated_exact`: a rotated view read pixel for pixel (the
  single-stream tracker's crop, and its detector's view).

Rounding rules: pixel indices round half away from zero; ``j / n`` is ``j *
f32(1/n)``; a rotated coordinate is one fused multiply-add; the colour map
``c·(hi−lo)/255 + lo`` is rounded once. Reads outside the frame are black.
Outputs are planar ``[N,3,h,w]``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["letterbox", "rotated_exact", "rotated_prescaled", "div", "fma", "recip", "round_half_away"]

PRESCALE_MARGIN = 2.0


def round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def div(x, d: float):
    """``x / d`` correctly rounded on every device (a 0-dim divisor)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def recip(n: float) -> float:
    return float(np.float32(1.0) / np.float32(n))


def fma(a, b, c):
    """``a * b + c`` for f32 tensors of one shape, rounded once: the exact
    f64 product, the f64 sum rounded to odd, then to f32."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    odd = torch.where((err != 0) & ((s.view(torch.int64) & 1) == 0), torch.nextafter(s, toward), s)
    return odd.float()


def _color(lo: float, hi: float):
    return float(np.float32(hi - lo) / np.float32(255.0)), float(np.float32(lo))


def _rgb(frames_u8, lin, ok, lo, hi):
    """Planar colour-mapped RGB ``[N,3,h,w]`` of the pixels ``lin [N,h,w]``
    of ``frames_u8`` seen as ``[B*H*W]`` RGBA words; black where not ``ok``."""
    words = frames_u8.contiguous().view(torch.int32).reshape(-1)
    px = words[torch.where(ok, lin, torch.zeros_like(lin))]
    shifts = torch.tensor([0, 8, 16], dtype=torch.int32, device=px.device)
    rgb = (px.unsqueeze(-3) >> shifts[:, None, None]) & 255
    rgb = torch.where(ok.unsqueeze(-3), rgb, torch.zeros_like(rgb))
    scale, offset = _color(lo, hi)
    return (rgb.to(torch.float64) * scale + offset).to(torch.float32)


def letterbox(frames_u8, rects, out_w: int, out_h: int, lo: float, hi: float):
    """``frames_u8 [B,H,W,4]``, unrotated ``rects [B,5]`` → ``[B,3,out_h,out_w]``."""
    B, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    u = torch.arange(out_w, dtype=torch.float32, device=dev) * recip(out_w)
    v = torch.arange(out_h, dtype=torch.float32, device=dev) * recip(out_h)
    xv = round_half_away(u[None, :] * rects[:, 2:3])
    yv = round_half_away(v[None, :] * rects[:, 3:4])
    wc, hc = rects[:, 2:3] * 0.5, rects[:, 3:4] * 0.5
    fx = ((xv + 0.5) - wc) + wc + (rects[:, 0:1] - wc)
    fy = ((yv + 0.5) - hc) + hc + (rects[:, 1:2] - hc)
    xr, yr = round_half_away(fx - 0.5), round_half_away(fy - 0.5)
    okx, oky = (xr >= 0) & (xr < W), (yr >= 0) & (yr < H)
    xi = torch.where(okx, xr, 0.0).to(torch.int64)[:, None, :]
    yi = torch.where(oky, yr, 0.0).to(torch.int64)[:, :, None]
    b = torch.arange(B, device=dev)[:, None, None]
    return _rgb(frames_u8, (b * H + yi) * W + xi, oky[:, :, None] & okx[:, None, :], lo, hi)


def rotated_exact(frames_u8, rects, out_w: int, out_h: int, lo: float, hi: float):
    """``frames_u8 [B,H,W,4]``, ``rects [B,5]`` → ``[B,3,out_h,out_w]``:
    output pixel ``j`` reads view pixel ``round(j/n · size)``, rotated into
    the frame."""
    B, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    u = torch.arange(out_w, dtype=torch.float32, device=dev)
    v = torch.arange(out_h, dtype=torch.float32, device=dev)
    xv = round_half_away(u * recip(out_w) * rects[:, 2:3])  # [B,out_w]
    yv = round_half_away(v * recip(out_h) * rects[:, 3:4])  # [B,out_h]
    shape = (B, out_h, out_w)
    r = rects[:, None, None, :]
    half_w, half_h = r[..., 2] * 0.5, r[..., 3] * 0.5
    px = ((xv + 0.5)[:, None, :] - half_w).expand(shape)
    py = ((yv + 0.5)[:, :, None] - half_h).expand(shape)
    c, s = torch.cos(r[..., 4]).expand(shape), torch.sin(r[..., 4]).expand(shape)
    xr = round_half_away(fma(c, px, -(s * py)) + half_w + (r[..., 0] - half_w) - 0.5)
    yr = round_half_away(fma(s, px, c * py) + half_h + (r[..., 1] - half_h) - 0.5)
    ok = (xr >= 0) & (yr >= 0) & (xr < W) & (yr < H)
    xi, yi = torch.where(ok, xr, 0.0).to(torch.int64), torch.where(ok, yr, 0.0).to(torch.int64)
    b = torch.arange(B, device=dev)[:, None, None]
    return _rgb(frames_u8, (b * H + yi) * W + xi, ok, lo, hi)


def _prescale_coefs(rects, prescale_m: int):
    """Per-view coefficients of the prescaled index map: ``(coefs [N,12],
    icoefs [N,4] int64)`` (sizes, cos, sin, half sizes, top-left, the grid's
    additive terms and inverse strides; the grid's first pixel and strides)."""
    cx, cy, w, h, th = rects.unbind(-1)
    c, s = torch.abs(torch.cos(th)), torch.abs(torch.sin(th))
    bw = w * c + h * s + PRESCALE_MARGIN
    bh = w * s + h * c + PRESCALE_MARGIN
    m = float(prescale_m)
    sx = torch.ceil(torch.clamp_min(div(bw, m), 1.0))
    sy = torch.ceil(torch.clamp_min(div(bh, m), 1.0))
    left = torch.floor(cx - sx * m * 0.5 + 0.5) - 0.5
    top = torch.floor(cy - sy * m * 0.5 + 0.5) - 0.5
    coefs = torch.stack([
        w, h, torch.cos(th), torch.sin(th), w * 0.5, h * 0.5, cx - w * 0.5, cy - h * 0.5,
        (-0.5 - left) / sx - 0.5, (-0.5 - top) / sy - 0.5, 1.0 / sx, 1.0 / sy,
    ], dim=-1)
    sxi, syi = sx.to(torch.int64), sy.to(torch.int64)
    lx = (left + 0.5).to(torch.int64) + (sxi - 1) // 2
    ly = (top + 0.5).to(torch.int64) + (syi - 1) // 2
    return coefs, torch.stack([lx, ly, sxi, syi], dim=-1)


def rotated_prescaled(frames_u8, rects, out_w: int, out_h: int, lo: float, hi: float, prescale_m: int):
    """``frames_u8 [B,H,W,4]``, ``rects [B,5]`` → ``[B,3,out_h,out_w]``: each
    output pixel reads the source pixel of its nearest point on a grid of
    ``prescale_m``² pixels at an integer stride that covers the view's
    rotated bounding box; points off the grid or the frame are black."""
    B, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    coefs, ic = _prescale_coefs(rects, prescale_m)
    col = lambda i: coefs[:, i, None, None]  # noqa: E731  [B,1,1]
    jf = torch.arange(out_w, dtype=torch.float32, device=dev) * recip(out_w)
    kf = torch.arange(out_h, dtype=torch.float32, device=dev) * recip(out_h)
    xv = torch.floor(jf[None, None, :] * col(0) + 0.5)
    yv = torch.floor(kf[None, :, None] * col(1) + 0.5)
    px, py = (xv + 0.5) - col(4), (yv + 0.5) - col(5)
    shape = (B, out_h, out_w)
    e = lambda t: t.expand(shape)  # noqa: E731
    fx = (fma(e(col(2)), e(px), e(-(col(3) * py))) + col(4)) + col(6)
    fy = (fma(e(col(3)), e(px), e(col(2) * py)) + col(5)) + col(7)
    jq = torch.floor(fma(fx, e(col(10)), e(col(8))) + 0.5)
    kq = torch.floor(fma(fy, e(col(11)), e(col(9))) + 0.5)
    ok = (jq >= 0) & (jq < prescale_m) & (kq >= 0) & (kq < prescale_m)
    x = ic[:, 0, None, None] + ic[:, 2, None, None] * torch.where(ok, jq, 0.0).to(torch.int64)
    y = ic[:, 1, None, None] + ic[:, 3, None, None] * torch.where(ok, kq, 0.0).to(torch.int64)
    ok &= (x >= 0) & (x < W) & (y >= 0) & (y < H)
    b = torch.arange(B, device=dev)[:, None, None]
    return _rgb(frames_u8, (b * H + y) * W + x, ok, lo, hi)
