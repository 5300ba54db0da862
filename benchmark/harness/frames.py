"""The benchmark's frames, made from ``--seed``.

The base frame is the bench frame: the decoded fixture photo
(``benchmark/data/photo.npz``, 1280×720 RGB) upscaled to 1920×1080 by
OpenCV's u8 bilinear rule, with alpha 255. Each stream sees its own copy
under a similarity transform drawn from the seed (rotation, scale, shift,
edges replicated), resampled bilinearly on the device and rounded to u8.

A traffic mix with ``empty_share`` shows that share of its streams, drawn
from the seed, a face-free part of the photo instead (``empty_crop``: x0,
y0, x1, y1 of the 1280×720 photo), upscaled by the same rule and put under
each such stream's own transform.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["bench_frame", "empty_streams", "stream_params", "stream_frames", "traffic_frames"]

PHOTO = Path(__file__).resolve().parent.parent / "data" / "photo.npz"
_COEF_SCALE = np.float32(2048.0)  # OpenCV's INTER_RESIZE_COEF_SCALE


def _axis(src: int, dst: int):
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _weights(f):
    return (np.rint((np.float32(1.0) - f) * _COEF_SCALE).astype(np.int64),
            np.rint(f * _COEF_SCALE).astype(np.int64))


def _resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    of a ``[H,W,C]`` u8 image, upscaled: 11-bit tap weights, edge columns
    with weight 1, clipped edge rows, and the vertical pass in OpenCV's SIMD
    rounding."""
    H, W = img.shape[:2]
    sx, fx = _axis(W, width)
    edge = (sx < 0) | (sx >= W - 1)
    fx = np.where(edge, np.float32(0.0), fx).astype(np.float32)
    sx = np.clip(sx, 0, W - 1)
    ax0, ax1 = _weights(fx)
    sy, fy = _axis(H, height)
    by0, by1 = _weights(fy)
    src = img.astype(np.int64)
    hor = src[:, sx] * ax0.reshape(1, -1, 1) + src[:, np.minimum(sx + 1, W - 1)] * ax1.reshape(1, -1, 1)
    h0, h1 = hor[np.clip(sy, 0, H - 1)], hor[np.clip(sy + 1, 0, H - 1)]
    b0, b1 = by0.reshape(-1, 1, 1), by1.reshape(-1, 1, 1)
    out = (((b0 * (h0 >> 4)) >> 16) + ((b1 * (h1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def bench_frame(crop=None) -> np.ndarray:
    """The 1920×1080 RGBA u8 bench frame ``[1080,1920,4]``; with ``crop``
    (x0, y0, x1, y1 in the photo's pixels) that part of the photo, upscaled
    by the same rule."""
    with np.load(PHOTO) as f:
        rgb = f["rgb"]
    if crop is not None:
        x0, y0, x1, y1 = crop
        rgb = np.ascontiguousarray(rgb[y0:y1, x0:x1])
    frame = _resize_linear_u8(rgb, 1920, 1080)
    return np.concatenate([frame, np.full((1080, 1920, 1), 255, np.uint8)], axis=-1)


def stream_params(seed: int, streams: int, transform: dict) -> np.ndarray:
    """``[streams, 4]`` float64: rotation (radians), scale, and shift as
    shares of the frame's width and height, uniform within the traffic's
    ``rotation_deg``, ``scale`` and ``shift`` ranges."""
    rng = np.random.Generator(np.random.PCG64(seed))
    rot = math.radians(transform["rotation_deg"])
    lo, hi = transform["scale"]
    shift = transform["shift"]
    return np.stack([
        rng.uniform(-rot, rot, streams),
        rng.uniform(lo, hi, streams),
        rng.uniform(-shift, shift, streams),
        rng.uniform(-shift, shift, streams),
    ], axis=-1)


def empty_streams(seed: int, streams: int, share: float) -> np.ndarray:
    """The sorted indices of the ``round(share * streams)`` streams that show
    the face-free frame, drawn from the seed apart from the transforms."""
    rng = np.random.Generator(np.random.PCG64([seed, 2]))
    return np.sort(rng.choice(streams, size=round(share * streams), replace=False))


def stream_frames(base: np.ndarray, params: np.ndarray, width: int, height: int, device, chunk: int = 16,
                  out=None, rows=None):
    """The streams' frames ``[N,height,width,4] u8`` on ``device``: frame
    ``i`` shows ``base`` rotated by ``params[i,0]`` about its centre, scaled
    by ``params[i,1]`` and shifted by ``params[i,2:4]`` of its size, fitted
    to ``width×height``; pixels from beyond the base repeat its edge.
    ``out`` and ``rows``: write frame ``i`` into ``out[rows[i]]`` instead."""
    dev = torch.device(device)
    H, W = base.shape[:2]
    src = torch.from_numpy(base).to(dev).permute(2, 0, 1)[None].float()  # [1,4,H,W]
    if out is None:
        out = torch.empty((len(params), height, width, 4), dtype=torch.uint8, device=dev)
    for a in range(0, len(params), chunk):
        p = torch.as_tensor(params[a:a + chunk], dtype=torch.float64)
        c, s, k = torch.cos(p[:, 0]), torch.sin(p[:, 0]), p[:, 1]
        # Normalised output coords → normalised source coords: the rotation
        # acts in pixels, so it is conjugated by the frame's half sizes.
        ax = W / H
        theta = torch.stack([
            torch.stack([c / k, -s / (k * ax), -(c * p[:, 2] * 2 - s * p[:, 3] * 2 / ax) / k], -1),
            torch.stack([s * ax / k, c / k, -(s * p[:, 2] * 2 * ax + c * p[:, 3] * 2) / k], -1),
        ], 1).to(torch.float32).to(dev)
        n = theta.shape[0]
        grid = F.affine_grid(theta, [n, 4, height, width], align_corners=False)
        img = F.grid_sample(src.expand(n, -1, -1, -1), grid, mode="bilinear", padding_mode="border",
                            align_corners=False)
        at = slice(a, a + n) if rows is None else torch.as_tensor(rows[a:a + n], device=dev)
        out[at] = img.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return out


def traffic_frames(t: dict, seed: int, device, bases: dict):
    """The frames of traffic mix ``t`` for ``seed`` on ``device``; ``bases``
    caches the base frames by crop (None: the bench frame)."""
    def base(crop):
        key = None if crop is None else tuple(crop)
        if key not in bases:
            bases[key] = bench_frame(key)
        return bases[key]

    params = stream_params(seed, t["streams"], t["transform"])
    if not t.get("empty_share"):
        return stream_frames(base(None), params, t["width"], t["height"], device)
    empty = empty_streams(seed, t["streams"], t["empty_share"])
    faces = np.setdiff1d(np.arange(t["streams"]), empty)
    out = torch.empty((t["streams"], t["height"], t["width"], 4), dtype=torch.uint8, device=device)
    for rows, crop in ((faces, None), (empty, t["empty_crop"])):
        stream_frames(base(crop), params[rows], t["width"], t["height"], device, out=out, rows=rows)
    return out
