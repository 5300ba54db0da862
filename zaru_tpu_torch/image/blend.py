"""Blend/blit between image views: the port of zaru_tpu/image/blend.py
(reference: crates/zaru-image/src/blend.rs + blend.wgsl).

Copies a source view onto a destination view region with bilinear
filtering in linear light; source samples outside the source image are
transparent zero (blend.wgsl:25-34). One pass of torch ops over the
destination image on its device, as JAX's jitted ``blend_device``.

The f32 arithmetic follows what XLA:CPU compiles where that was found to
matter: a division by a constant is a multiplication by the constant's f32
reciprocal (``num.recip``); each linear interpolation ``a * (1 - f) + b *
f`` is one fused multiply-add, ``fma(a, 1 - f, b * f)``, and so is the map
to u8, ``fma(c, 255, 0.5)`` (``num.fma``). The rest rounds as the JAX
source reads, through the port's ``rrect_transform_in``/
``rrect_transform_out``; XLA's compiled blend contracts some of that
further (the view rotations among it), and its ``pow`` differs from
torch's in the last ulp on a few percent of inputs, so an output value can
move by one u8 step (measured in tests/test_torch_pose3d.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import rrect_transform_in, rrect_transform_out
from ..num import fma, recip

__all__ = ["blend", "blend_device", "bilinear_sample"]


def _srgb_to_linear(c):
    """sRGB EOTF on [0,1] values (color.rs:58-73)."""
    return torch.where(c <= 0.04045, c * recip(12.92), ((c + 0.055) * recip(1.055)) ** 2.4)


def _linear_to_srgb(lin):
    return torch.where(
        lin <= 0.0031308, lin * 12.92, 1.055 * torch.clamp_min(lin, 1e-12) ** (1 / 2.4) - 0.055
    )


def _lerp(a, b, f):
    """``a * (1 - f) + b * f``, the first product fused into the sum."""
    return fma(a, 1 - f, b * f)


def bilinear_sample(image_u8, pts):
    """Bilinearly samples ``image_u8 [H,W,4]`` at absolute pixel coords
    ``pts [...,2]`` (texel centers at i+0.5, GPU sampler convention).

    Filtering happens in *linear* light like the reference's sRGB texture
    views (image.rs:50-53); alpha is linear already. Returns float32
    linear-RGB + alpha in [0,1]; coordinates outside [0, W]×[0, H] return 0
    (blend.wgsl's UV clamp-to-zero)."""
    H, W = image_u8.shape[0], image_u8.shape[1]
    x = pts[..., 0] - 0.5
    y = pts[..., 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def tex(xi, yi):
        xi = torch.clamp(xi.to(torch.int32), 0, W - 1).long()
        yi = torch.clamp(yi.to(torch.int32), 0, H - 1).long()
        texel = image_u8[yi, xi].to(torch.float32) * recip(255)
        rgb = _srgb_to_linear(texel[..., :3])
        return torch.cat([rgb, texel[..., 3:4]], dim=-1)

    c00 = tex(x0, y0)
    c10 = tex(x0 + 1, y0)
    c01 = tex(x0, y0 + 1)
    c11 = tex(x0 + 1, y0 + 1)
    out = _lerp(_lerp(c00, c10, fx), _lerp(c01, c11, fx), fy)

    u = pts[..., 0] * recip(W)
    v = pts[..., 1] * recip(H)
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return torch.where(inside[..., None], out, 0.0)


def blend_device(dest_u8, dest_rrect, src_u8, src_rrect):
    """Blits ``src_u8 [h,w,4]`` seen through ``src_rrect [5]`` onto the
    ``dest_rrect [5]`` region of ``dest_u8 [H,W,4]``, all on one device.
    Returns the new dest tensor."""
    H, W = dest_u8.shape[0], dest_u8.shape[1]
    dev = dest_u8.device
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    pts = torch.stack([gx, gy], dim=-1)  # [H,W,2] dest-image pixel centers

    local = rrect_transform_in(dest_rrect, pts)  # dest-view coords
    dw, dh = dest_rrect[2], dest_rrect[3]
    inside = (local[..., 0] >= 0) & (local[..., 0] <= dw) & (local[..., 1] >= 0) & (local[..., 1] <= dh)

    # Normalized position in the dest view → the same position in the src
    # view → root coords of the src image (affine, like the GPU quad UVs).
    uv = local / dest_rrect[2:4]
    src_pts = rrect_transform_out(src_rrect, uv * src_rrect[2:4])

    sampled = bilinear_sample(src_u8, src_pts)  # linear light, [0,1]
    srgb = torch.cat([_linear_to_srgb(sampled[..., :3]), sampled[..., 3:4]], dim=-1)
    u8 = torch.clamp(fma(srgb, torch.full_like(srgb, 255.0), torch.full_like(srgb, 0.5)), 0, 255)
    return torch.where(inside[..., None], u8.to(torch.uint8), dest_u8)


def blend(dest, src):
    """Blends ``src`` (Image or ImageView) onto ``dest`` (Image or
    ImageView), returning a new :class:`Image` of the destination root on
    its device (blend.rs:13-31). Use ``.view(rect)`` on either side to
    choose regions."""
    from . import Image, as_view

    dview, sview = as_view(dest), as_view(src)
    dev = dview.image.device

    def rect(view):
        return torch.from_numpy(np.array(view.view_rect.array, np.float32)).to(dev)

    out = blend_device(dview.image.data, rect(dview), sview.image.data.to(dev), rect(sview))
    return Image(out, dev)
