"""The programs the benchmarks time (zaru_tpu/bench_programs.py): the
measurement surface, kept apart from the scripts that orchestrate them.

- :func:`make_1080p_frame`: the one bench frame, the fixture photo upscaled
  to 1920×1080 RGBA u8, bit for bit the frame JAX's benches time;
- :func:`tile_frames`: one frame uploaded once and tiled over the batch on
  the device;
- :func:`build_cascade_scan`: ``scan_steps`` production-cadence steps of a
  tracker (detection forced every ``detect_every`` steps, landmarks and
  smoothing every step), the program JAX's ``bench.py`` measures;
- :func:`measure_tunnel_roundtrip`: the round trip of a trivial op and a
  read to the host, the floor a single-step latency includes.

Where JAX's programs differ in form:

- JAX's scan is one traced ``lax.scan``; here it is an eager loop of
  ``step_batch`` calls, each step issued from the host (its batch gate reads
  one bool on the host unless the step is forced);
- the port's trackers hold their own parameters, so ``run`` takes no
  ``params`` argument;
- JAX's ``make_1080p_frame`` decodes the JPEG and resizes with
  ``cv2.resize(INTER_LINEAR)``. The port depends on neither OpenCV nor a
  JPEG decoder (a GPU machine may lack both), so the photo comes decoded from
  ``fixtures/sad_linus_track.npz`` (``rgb``: JAX's decode of
  ``sad_linus.jpg``, equal array for array) and :func:`_resize_linear_u8` is
  a NumPy copy of OpenCV's fixed-point bilinear rule for u8 upscales.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ._device import resolve_device
from .assets import fixture_path

__all__ = [
    "build_cascade_scan",
    "make_1080p_frame",
    "measure_tunnel_roundtrip",
    "tile_frames",
]

_COEF_SCALE = np.float32(2048.0)  # OpenCV's INTER_RESIZE_COEF_SCALE (11 fraction bits)


def _axis(src: int, dst: int):
    """Source index and fraction of each destination pixel along one axis,
    in OpenCV's float32 arithmetic (pixel centres aligned)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _weights(f):
    """The two fixed-point tap weights of fractions ``f`` (rounded to
    nearest, as OpenCV's ``saturate_cast<short>``)."""
    return (np.rint((np.float32(1.0) - f) * _COEF_SCALE).astype(np.int64),
            np.rint(f * _COEF_SCALE).astype(np.int64))


def _resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    for a ``[H,W]`` or ``[H,W,C]`` uint8 image upscaled (``width >= W``,
    ``height >= H``), bit for bit.

    OpenCV's u8 path: 11-bit tap weights per axis; a column past either edge
    takes the edge pixel with weight 1 (its fraction is zeroed), while a
    row past an edge keeps its fraction and only its indices are clipped;
    the horizontal pass sums in integers, and the vertical pass is its SIMD
    form ``((b0·(h0 >> 4)) >> 16) + ((b1·(h1 >> 4)) >> 16) + 2 >> 2`` (the
    scalar ``(b0·h0 + b1·h1 + 2^21) >> 22`` rounds differently)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"a [H,W] or [H,W,C] uint8 image, got {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    if width < W or height < H:
        raise ValueError(f"an upscale only: {W}x{H} -> {width}x{height}")
    sx, fx = _axis(W, width)
    edge = (sx < 0) | (sx >= W - 1)
    fx = np.where(edge, np.float32(0.0), fx).astype(np.float32)
    sx = np.clip(sx, 0, W - 1)
    ax0, ax1 = _weights(fx)
    sy, fy = _axis(H, height)
    by0, by1 = _weights(fy)
    trail = (1,) * (img.ndim - 2)
    src = img.astype(np.int64)
    hor = src[:, sx] * ax0.reshape(1, -1, *trail) + src[:, np.minimum(sx + 1, W - 1)] * ax1.reshape(1, -1, *trail)
    h0, h1 = hor[np.clip(sy, 0, H - 1)], hor[np.clip(sy + 1, 0, H - 1)]
    b0, b1 = by0.reshape(-1, 1, *trail), by1.reshape(-1, 1, *trail)
    out = (((b0 * (h0 >> 4)) >> 16) + ((b1 * (h1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def make_1080p_frame() -> np.ndarray:
    """The bench frame: the fixture photo (1280×720) upscaled to 1920×1080
    RGBA u8, ``[1080,1920,4]``, alpha 255; the frame of
    ``zaru_tpu.bench_programs.make_1080p_frame`` bit for bit."""
    with np.load(fixture_path("sad_linus_track.npz")) as f:
        rgb = f["rgb"]
    frame = _resize_linear_u8(rgb, 1920, 1080)
    return np.concatenate([frame, np.full((1080, 1920, 1), 255, np.uint8)], axis=-1)


def tile_frames(frame, batch: int, device=None) -> torch.Tensor:
    """One ``[H,W,4]`` u8 frame (numpy or tensor) uploaded once and tiled to
    a contiguous ``[batch,H,W,4]`` tensor on ``device`` (``cuda`` unless
    named)."""
    dev = resolve_device(device)
    f = (frame if isinstance(frame, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(frame))).to(dev)
    return f.expand(batch, *f.shape).contiguous()


def build_cascade_scan(tracker, scan_steps: int, detect_every: int):
    """The headline program: ``scan_steps`` production-cadence steps of
    ``tracker.step_batch``, detection forced on every ``detect_every``-th
    step from the first. Returns ``run(state, frames) -> (state, confidences
    [scan_steps, B])``, the confidences stacked on the device; nothing is
    read back to the host but what the batch gate of an unforced step
    reads."""

    def run(state, frames):
        confs = []
        for t in range(scan_steps):
            state, out = tracker.step_batch(state, frames, force_detect=(t % detect_every == 0))
            confs.append(out["confidence"])
        return state, torch.stack(confs)

    return run


def measure_tunnel_roundtrip(n: int = 12, device=None) -> float:
    """Median seconds of a trivial op on ``device`` (``cuda`` unless named)
    and the read of its result to the host: the floor to subtract from a
    single step's latency for its device estimate. Each sample adds a new
    constant, so each reads a new tensor (a copy the host already holds
    would measure nothing)."""
    dev = resolve_device(device)
    tiny = torch.zeros(8, dtype=torch.float32, device=dev)
    (tiny + 0.0).cpu()  # first launch and transfer
    samples = []
    for i in range(n):
        t0 = time.perf_counter()
        (tiny + float(i + 1)).cpu()
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))
