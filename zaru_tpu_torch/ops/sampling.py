"""Plain PyTorch samplers (zaru_tpu/ops/sampling.py).

``letterbox_sample_core`` (sampling.py:120) is the plain version of the
letterbox kernel in :mod:`.letterbox`; ``view_to_tensor_core`` (:88) is the
exact rotated-view sampler the JAX package keeps beside its fast one, and
``sample_view_rgba`` (:73) and ``sample_view`` (:164) are its RGBA form for
one view, which image views materialise through. Both
run batched over streams here (the JAX functions are per view and
``vmap``-ed) and keep the f32 operation order of the JAX functions as
XLA:CPU compiles them (``i / n`` as ``i * f32(1/n)``, the exact sampler's
rotation contracted into two FMAs, the colour map into one), so they are
bit-exact to it: nearest-neighbour source pixels chosen with
round-half-away, reads outside the frame are black (0, 0, 0, 0), and the
colour map is
``c·(hi−lo)/255 + lo`` (see :func:`color_map`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import profiling
from ..num import fma, recip, round_half_away

__all__ = [
    "letterbox_sample_core", "view_to_tensor_core", "color_adjust", "color_map",
    "sample_view", "sample_view_rgba",
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


def _channel_shifts(device):
    """The shifts that split R, G and B off an RGBA word, on ``device``."""
    return torch.tensor([0, 8, 16], dtype=torch.int32, device=device)


def _gather_rgb(frames_u8, lin, ok, shifts, planar: bool = False):
    """RGB of ``frames_u8 [B,H,W,4]`` at the pixels ``lin`` (indices into
    the ``[B*H*W]`` RGBA pixels), black where not ``ok``: ``[..., 3]`` or,
    ``planar``, ``[..., 3, h, w]`` for ``lin [..., h, w]``. One gather of
    whole pixels (as 32-bit words, little-endian: R in the low byte), the
    channels split off by ``shifts`` (:func:`_channel_shifts`); indices are
    masked before the gather, since torch indexing wraps negative ones."""
    words = frames_u8.contiguous().view(torch.int32).reshape(-1)
    px = words[torch.where(ok, lin, torch.zeros_like(lin))]
    if planar:
        rgb, ok = (px.unsqueeze(-3) >> shifts[:, None, None]) & 255, ok.unsqueeze(-3)
    else:
        rgb, ok = (px[..., None] >> shifts) & 255, ok[..., None]
    return torch.where(ok, rgb, torch.zeros_like(rgb))


def _letterbox_index(frames_u8, rrects, out_w: int, out_h: int):
    """The letterbox's separable index map (sampling.py:135-146, op for op
    as compiled):
    source rows ``yi [B,out_h,1]`` and columns ``xi [B,1,out_w]`` (0 where
    outside the frame) and ``ok [B,out_h,out_w]``."""
    B, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    u = torch.arange(out_w, dtype=torch.float32, device=dev) * recip(out_w)
    v = torch.arange(out_h, dtype=torch.float32, device=dev) * recip(out_h)
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
    B, H, W, _ = frames_u8.shape
    yi, xi, ok = _letterbox_index(frames_u8, rrects, out_w, out_h)
    bidx = torch.arange(B, device=frames_u8.device)[:, None, None]
    rgb = _gather_rgb(frames_u8, (bidx * H + yi) * W + xi, ok, _channel_shifts(frames_u8.device))
    return color_map(rgb, color_adjust(lo, hi), float(np.float32(lo)))


def _view_index(frames_u8, r, out_w: int, out_h: int, mirror=None, scale_to_view: bool = True):
    """The rotated views' nearest-neighbour source pixels (``_view_grid``
    :50 as XLA:CPU compiles it): for ``frames_u8 [B,H,W,4]`` and rects ``r
    [B,S,5]`` → ``(lin, ok)``, each ``[B,S,out_h,out_w]``: the source
    pixel's index into the ``[B*H*W]`` RGBA pixels (0 where it lies outside
    the frame) and whether it lies inside. ``scale_to_view``: output pixel
    ``j`` reads view pixel ``round(j/n · size)`` (a CNN input); else view
    pixel ``j`` itself (a view materialised at its own size)."""
    B, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    u = torch.arange(out_w, dtype=torch.float32, device=dev)
    v = torch.arange(out_h, dtype=torch.float32, device=dev)
    if scale_to_view:
        xv = round_half_away(u * recip(out_w) * r[..., 2:3])  # [B,S,out_w]
        yv = round_half_away(v * recip(out_h) * r[..., 3:4])  # [B,S,out_h]
    else:
        xv = u.expand(*r.shape[:2], out_w)
        yv = v.expand(*r.shape[:2], out_h)
    if mirror is not None:
        if len(mirror) != r.shape[1]:
            raise ValueError(f"mirror needs one flag per slot of [B,S,5] rects, got {len(mirror)} "
                             f"for {r.shape[1]} slots")
        with profiling.sync("zaru.sync.sampler_mirror"):
            flip = torch.tensor(mirror, dtype=torch.bool, device=dev)[:, None]
        xv = torch.where(flip, xv.flip(-1), xv)
    shape = (B, r.shape[1], out_h, out_w)
    rr = r[:, :, None, None, :]
    half_w, half_h = rr[..., 2] * 0.5, rr[..., 3] * 0.5
    px = (xv + 0.5)[:, :, None, :] - half_w  # [B,S,1,out_w]
    py = (yv + 0.5)[:, :, :, None] - half_h  # [B,S,out_h,1]
    c = torch.cos(rr[..., 4]).expand(shape)
    s = torch.sin(rr[..., 4]).expand(shape)
    px, py = px.expand(shape), py.expand(shape)
    # rrect_transform_out (``rotate_ccw(pt - centre) + centre + top-left``)
    # as XLA:CPU compiles it: both rotated coordinates contracted into FMAs.
    xr = round_half_away(fma(c, px, -(s * py)) + half_w + (rr[..., 0] - half_w) - 0.5)
    yr = round_half_away(fma(s, px, c * py) + half_h + (rr[..., 1] - half_h) - 0.5)
    ok = (xr >= 0) & (yr >= 0) & (xr < W) & (yr < H)
    xi = torch.where(ok, xr, 0.0).to(torch.int64)
    yi = torch.where(ok, yr, 0.0).to(torch.int64)
    bidx = torch.arange(B, device=dev)[:, None, None, None]
    return (bidx * H + yi) * W + xi, ok


def view_to_tensor_core(
    frames_u8, rrects, out_w: int, out_h: int, lo: float = -1.0, hi: float = 1.0,
    layout: str = "NCHW", mirror=None,
):
    """Exact rotated-view sample + colour map, batched over streams and
    slots (sampling.py:88 with ``_view_grid`` :50).

    ``frames_u8 [B,H,W,4] u8``, ``rrects [B,...,5] f32`` (the middle dims are
    slots: several views of one frame) → ``[B,...,3,out_h,out_w]`` (NCHW,
    gathered straight into the planar layout) or ``[B,...,out_h,out_w,3]``
    (NHWC) f32. ``mirror``: one flag per slot (rects ``[B,S,5]``); a flagged
    slot is flipped left to right, as the JAX iris path flips its right-eye
    crops (face_cascade.py:388), by reversing its view columns.
    """
    if layout not in ("NHWC", "NCHW"):
        raise ValueError(f"layout must be NHWC or NCHW, got {layout!r}")
    if mirror is not None and rrects.ndim != 3:
        raise ValueError(f"mirror needs [B,S,5] rects, got {tuple(rrects.shape)}")
    B = frames_u8.shape[0]
    lead = rrects.shape[:-1]
    lin, ok = _view_index(frames_u8, rrects.reshape(B, -1, 5), out_w, out_h, mirror)
    with profiling.sync("zaru.sync.sampler_shifts"):
        shifts = _channel_shifts(frames_u8.device)
    rgb = _gather_rgb(frames_u8, lin, ok, shifts, layout == "NCHW")
    mapped = color_map(rgb, color_adjust(lo, hi), float(np.float32(lo)))
    return mapped.reshape(*lead, *mapped.shape[2:])


def sample_view_rgba(image_u8, rrect, out_w: int, out_h: int, *, scale_to_view: bool = True):
    """RGBA u8 ``[out_h, out_w, 4]`` of the rotated view ``rrect [5]`` of
    ``image_u8 [H, W, 4]`` (sampling.py:73, as ``jax.jit`` compiles it);
    pixels outside the image are (0, 0, 0, 0). ``scale_to_view``: the view
    scaled to ``out_w×out_h`` as a CNN samples it; else its pixels at their
    own size from (0, 0) (``ImageView::to_image``)."""
    H, W, _ = image_u8.shape
    lin, ok = _view_index(image_u8[None], rrect.reshape(1, 1, 5), out_w, out_h, None, scale_to_view)
    words = image_u8.contiguous().view(torch.int32).reshape(-1)
    px = torch.where(ok, words[lin], torch.zeros_like(lin, dtype=torch.int32))
    return px[0, 0].contiguous().view(torch.uint8).reshape(out_h, out_w, 4)


def sample_view(image_u8, rrect, out_w: int, out_h: int):
    """The rotated view ``rrect [5]`` materialised as a new RGBA image
    ``[out_h, out_w, 4] u8`` (sampling.py:164, ``ImageView::to_image``)."""
    return sample_view_rgba(image_u8, rrect, out_w, out_h, scale_to_view=False)
