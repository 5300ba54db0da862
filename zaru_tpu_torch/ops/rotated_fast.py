"""The rotated-ROI sampler: hand-written CUDA kernel and its plain version.

``rotated_sample_fast`` is the function of zaru_tpu/ops/rotated_fast.py:930
(``rotated_sample_fast``), the every-frame crop of the face cascade: frames
``[B,H,W,4] u8`` and view rects ``[B,...,5] f32`` → ``[B,...,out_h,out_w,3]
f32`` NHWC, colour-mapped. The extra middle dims of the rects are slots:
several views of one frame (rotated_fast.py:960-963). ``layout="NCHW"``
gives the planar ``[B,...,3,out_h,out_w]`` the CNNs take, and ``mirror``
flips chosen slots left to right (the iris path's right eyes).

Each output pixel reads one source pixel through an integer-stride
prescale grid of side ``prescale_m`` (``PRESCALE_M`` = 512, the JAX default;
the eye crops of iris refinement use 256): bit-exact to the exact sampler
for views whose rotated bounding box fits the grid, within
``ceil(stride/2)`` source pixels beyond. The per-view coefficients follow
the f32 op order of ``_prescale_geometry`` (:118), ``_prescale_coefs``
(:366-371) and ``_sampler_coefs`` (:539-570) (:func:`sampler_coefs`). The
sampler is the registered op ``zaru_tpu_torch::rotated_sample``
(:func:`rotated_sample_op`, so ``torch.export`` captures it): on a CUDA
tensor one launch of ``csrc/rotated_sample.cu`` (:func:`rotated_sample_launch`)
computes them per view and samples; on a CPU tensor the plain version
(:func:`rotated_sample_fast_reference`) runs both in torch ops; its fake
kernel gives the output's shape. The TPU kernels replaced are listed in the
CUDA source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import profiling
from ..num import div, fma, recip
from ._build import library
from .sampling import color_map

__all__ = [
    "PRESCALE_M",
    "kernel_coefs",
    "rotated_sample_fast",
    "rotated_sample_fast_reference",
    "rotated_sample_launch",
    "rotated_sample_op",
    "sampler_coefs",
]

PRESCALE_M = 512  # prescale grid side; sampling is bit-exact for bbox <= M
PRESCALE_MARGIN = 2.0  # prescale bbox slack (rotated_fast.py:76)


def sampler_coefs(rrects, prescale_m: int = PRESCALE_M):
    """Per-view coefficients of the index map for ``rrects [N,5]`` on a
    prescale grid of side ``prescale_m``.

    Returns ``(coefs [N,12] f32, icoefs [N,4] i32)``: ``coefs`` as
    ``_sampler_coefs`` orders them (w, h, cos, sin, w/2, h/2, top-left x/y,
    the prescale grid's additive terms and inverse strides) and ``icoefs``
    the grid's first source pixel and integer strides ``(lx, ly, sx, sy)``.
    """
    cx, cy, w, h, th = rrects.unbind(-1)
    c, s = torch.abs(torch.cos(th)), torch.abs(torch.sin(th))
    bw = w * c + h * s + PRESCALE_MARGIN
    bh = w * s + h * c + PRESCALE_MARGIN
    m = float(prescale_m)
    sx = torch.ceil(torch.clamp_min(div(bw, m), 1.0))
    sy = torch.ceil(torch.clamp_min(div(bh, m), 1.0))
    left = cx - sx * m * 0.5
    top = cy - sy * m * 0.5
    left = torch.floor(left + 0.5) - 0.5
    top = torch.floor(top + 0.5) - 0.5
    coefs = torch.stack(
        [
            w,
            h,
            torch.cos(th),
            torch.sin(th),
            w * 0.5,
            h * 0.5,
            cx - w * 0.5,
            cy - h * 0.5,
            (-0.5 - left) / sx - 0.5,
            (-0.5 - top) / sy - 0.5,
            1.0 / sx,
            1.0 / sy,
        ],
        dim=-1,
    )
    sxi = sx.to(torch.int32)
    syi = sy.to(torch.int32)
    lx = (left + 0.5).to(torch.int32) + (sxi - 1) // 2
    ly = (top + 0.5).to(torch.int32) + (syi - 1) // 2
    return coefs.contiguous(), torch.stack([lx, ly, sxi, syi], dim=-1).contiguous()


def _color(lo: float, hi: float) -> tuple[float, float]:
    """The colour map's f32 scale and offset (rotated_fast.py:1530-1531)."""
    return float(np.float32((hi - lo) / 255.0)), float(np.float32(lo))


def _source_index(frames_u8, coefs, icoefs, out_w, out_h, prescale_m):
    """The kernel's per-pixel index map in torch ops: ``(lin, ok)``, each
    ``[N,out_h,out_w]``: the source pixel's index in ``frames_u8`` viewed as
    ``[B*H*W]`` RGBA pixels (0 where not ``ok``), and whether it is read
    (inside the prescale grid and the frame; black otherwise).

    Four steps follow compiled JAX rather than its source (rotated_fast.py:
    645-653): ``j / out_w`` is ``j * f32(1/out_w)``; ``cth*px - sth*py``
    and ``sth*px + cth*py`` are each one fused multiply-add, ``fma(cth, px,
    -(sth*py))`` and ``fma(sth, px, cth*py)``; and so is the map into the
    prescale grid, ``fma(fx, inv_sx, qx0)`` and ``fma(fy, inv_sy, qy0)``."""
    B, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    N = coefs.shape[0]
    col = lambda i: coefs[:, i, None, None]  # noqa: E731  [N,1,1]
    jf = torch.arange(out_w, dtype=torch.float32, device=dev) * recip(out_w)
    kf = torch.arange(out_h, dtype=torch.float32, device=dev) * recip(out_h)
    xv = torch.floor(jf[None, None, :] * col(0) + 0.5)  # [N,1,out_w]
    yv = torch.floor(kf[None, :, None] * col(1) + 0.5)  # [N,out_h,1]
    px = (xv + 0.5) - col(4)
    py = (yv + 0.5) - col(5)
    shape = (N, out_h, out_w)
    fx = (fma(col(2).expand(shape), px.expand(shape), -(col(3) * py).expand(shape)) + col(4)) + col(6)
    fy = (fma(col(3).expand(shape), px.expand(shape), (col(2) * py).expand(shape)) + col(5)) + col(7)
    jq = torch.floor(fma(fx, col(10).expand(shape), col(8).expand(shape)) + 0.5)  # [N,out_h,out_w]
    kq = torch.floor(fma(fy, col(11).expand(shape), col(9).expand(shape)) + 0.5)
    ok = (jq >= 0) & (jq < prescale_m) & (kq >= 0) & (kq < prescale_m)
    ic = icoefs.to(torch.int64)
    x = ic[:, 0, None, None] + ic[:, 2, None, None] * torch.where(ok, jq, 0.0).to(torch.int64)
    y = ic[:, 1, None, None] + ic[:, 3, None, None] * torch.where(ok, kq, 0.0).to(torch.int64)
    ok &= (x >= 0) & (x < W) & (y >= 0) & (y < H)
    frame = (torch.arange(N, device=dev) // (N // B))[:, None, None]
    return torch.where(ok, (frame * H + y) * W + x, 0), ok


def _reference(frames_u8, coefs, icoefs, out_w, out_h, lo, hi, prescale_m):
    """The kernel's per-pixel map in torch ops: ``[N,out_h,out_w,3]``."""
    lin, ok = _source_index(frames_u8, coefs, icoefs, out_w, out_h, prescale_m)
    # The frame as one int32 RGBA pixel per element (little-endian R first).
    pixels = frames_u8.reshape(-1).view(torch.int32)[lin]
    pixels = torch.where(ok, pixels, 0)
    rgb = torch.stack([(pixels >> sh) & 0xFF for sh in (0, 8, 16)], dim=-1)
    return color_map(rgb, *_color(lo, hi))


def _check(frames_u8, rrects, layout, mirror):
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim != 4 or frames_u8.shape[-1] != 4:
        raise ValueError(f"frames must be [B,H,W,4] uint8, got {tuple(frames_u8.shape)} {frames_u8.dtype}")
    if (rrects.dtype != torch.float32 or rrects.ndim < 2 or rrects.shape[-1] != 5
            or rrects.shape[0] != frames_u8.shape[0]):
        raise ValueError(f"rects must be [B,...,5] float32, got {tuple(rrects.shape)} {rrects.dtype}")
    if rrects.device != frames_u8.device:
        raise ValueError("frames and rects must be on one device")
    if layout not in ("NHWC", "NCHW"):
        raise ValueError(f"layout must be NHWC or NCHW, got {layout!r}")
    slots = rrects[0, ..., 0].numel()
    if mirror is not None and len(mirror) != slots:
        raise ValueError(f"mirror needs one flag per slot ({slots}), got {len(mirror)}")


def _shaped(out, rrects, out_w, out_h, layout):
    """``[N,...]`` sampler output → ``[B,...,out_h,out_w,3]`` or, planar,
    ``[B,...,3,out_h,out_w]``."""
    tail = (out_h, out_w, 3) if layout == "NHWC" else (3, out_h, out_w)
    return out.reshape(*rrects.shape[:-1], *tail)


def _plain(frames_u8, rects, out_w, out_h, lo, hi, prescale_m, planar, mirror):
    """The plain version on flat ``rects [N,5]`` (``N/B`` views a frame) →
    ``[N,out_h,out_w,3]`` or, ``planar``, ``[N,3,out_h,out_w]``."""
    coefs, icoefs = sampler_coefs(rects, prescale_m)
    out = _reference(frames_u8.contiguous(), coefs, icoefs, out_w, out_h, lo, hi, prescale_m)
    if any(mirror):
        flip = torch.tensor(list(mirror), device=out.device).repeat(frames_u8.shape[0])
        out = torch.where(flip[:, None, None, None], out.flip(-2), out)
    return out.permute(0, 3, 1, 2).contiguous() if planar else out


def rotated_sample_fast_reference(
    frames_u8, rrects, out_w: int, out_h: int, lo: float = 0.0, hi: float = 1.0,
    prescale_m: int = PRESCALE_M, layout: str = "NHWC", mirror=None,
):
    """Plain PyTorch version of :func:`rotated_sample_fast` (same result bit
    for bit), on any device: the same index map with torch ops and a gather
    on the frame viewed as ``int32`` (out-of-range indices are masked before
    the gather, because torch wraps negative ones). The planar layout is the
    NHWC result permuted, a mirrored slot the NHWC result flipped."""
    _check(frames_u8, rrects, layout, mirror)
    out = _plain(frames_u8, rrects.reshape(-1, 5), out_w, out_h, lo, hi, prescale_m, layout == "NCHW",
                 list(mirror or ()))
    return _shaped(out, rrects, out_w, out_h, layout)


def rotated_sample_launch(
    frames_u8, rects, slots: int, out_w: int, out_h: int, lo: float, hi: float,
    prescale_m: int = PRESCALE_M, layout: str = "NHWC", mirror=None,
):
    """Launches ``csrc/rotated_sample.cu`` on CUDA ``frames_u8 [B,H,W,4] u8``
    for ``rects [N,5]`` (``slots`` = N/B views per frame, view ``n`` of frame
    ``n // slots``) → ``[N,out_h,out_w,3]`` or, ``layout="NCHW"``,
    ``[N,3,out_h,out_w]`` f32. The kernel computes each view's coefficients
    itself. Not counted: the registered op's CUDA kernel
    (:func:`rotated_sample_op`) counts its launches."""
    B, H, W, _ = frames_u8.shape
    N = rects.shape[0]
    if not (frames_u8.is_cuda and frames_u8.dtype == torch.uint8 and frames_u8.is_contiguous()):
        raise ValueError("frames must be a contiguous uint8 CUDA tensor")
    if (rects.device != frames_u8.device or rects.dtype != torch.float32
            or tuple(rects.shape) != (N, 5) or not rects.is_contiguous()):
        raise ValueError(f"rects must be contiguous [N,5] float32 on {frames_u8.device}")
    if N != B * slots or N == 0:
        raise ValueError(f"{N} views for {B} frames of {slots} slots")
    if out_w % 4 or out_w <= 0 or out_h <= 0:
        raise ValueError(f"the kernel writes rows of 4-pixel groups: out_w={out_w} is no multiple of 4")
    mask = 0
    if mirror is not None:
        if len(mirror) != slots or slots > 32:
            raise ValueError(f"mirror takes one flag for each of at most 32 slots, got {len(mirror)} for {slots}")
        mask = sum(1 << i for i, f in enumerate(mirror) if f)
    planar = layout == "NCHW"
    shape = (N, 3, out_h, out_w) if planar else (N, out_h, out_w, 3)
    out = torch.empty(shape, dtype=torch.float32, device=frames_u8.device)
    fn = library("rotated_sample").zaru_rotated_sample
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float] * 4
                   + [ctypes.c_int, ctypes.c_uint, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(frames_u8.device):  # the launch goes to the runtime's current device
        rc = fn(
            frames_u8.data_ptr(), rects.data_ptr(), out.data_ptr(), N, slots, H, W, prescale_m,
            out_w, out_h, recip(out_w), recip(out_h), *_color(lo, hi), int(planar), mask,
            torch.cuda.current_stream(frames_u8.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rotated_sample kernel launch failed: CUDA error {rc}")
    return out


@torch.library.custom_op("zaru_tpu_torch::rotated_sample", mutates_args=(), device_types="cuda")
def rotated_sample_op(
    frames: torch.Tensor, rects: torch.Tensor, out_w: int, out_h: int, lo: float, hi: float,
    prescale_m: int, planar: bool, mirror: list[bool],
) -> torch.Tensor:
    """The sampler as a registered op on flat ``rects [N,5]`` (``mirror``:
    one flag a slot, or empty): its CUDA kernel is one launch of
    :func:`rotated_sample_launch`, counted in ``launches.rotated_sample``
    (so a launch from inside an exported program counts too); its CPU
    kernel the plain version."""
    slots = rects.shape[0] // frames.shape[0]
    out = rotated_sample_launch(frames, rects, slots, out_w, out_h, lo, hi, prescale_m,
                                "NCHW" if planar else "NHWC", mirror or None)
    profiling.counters["launches.rotated_sample"] += 1
    return out


rotated_sample_op.register_kernel("cpu")(_plain)


@rotated_sample_op.register_fake
def _(frames, rects, out_w, out_h, lo, hi, prescale_m, planar, mirror):
    n = rects.shape[0]
    return frames.new_empty((n, 3, out_h, out_w) if planar else (n, out_h, out_w, 3), dtype=torch.float32)


def kernel_coefs(rects, prescale_m: int = PRESCALE_M):
    """The kernel's own per-view coefficients for CUDA ``rects [N,5]``, in
    the form of :func:`sampler_coefs`: what each block of the sampler
    computes, written out by a separate small kernel of the same source, so
    that they can be held against :func:`sampler_coefs` on the card. Not a
    launch of the sampler: not counted."""
    if not (rects.is_cuda and rects.dtype == torch.float32 and rects.ndim == 2
            and rects.shape[1] == 5 and rects.is_contiguous() and rects.shape[0] > 0):
        raise ValueError("rects must be a contiguous, non-empty [N,5] float32 CUDA tensor")
    N = rects.shape[0]
    coefs = torch.empty((N, 12), dtype=torch.float32, device=rects.device)
    icoefs = torch.empty((N, 4), dtype=torch.int32, device=rects.device)
    fn = library("rotated_sample").zaru_rotated_coefs
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(rects.device):
        rc = fn(rects.data_ptr(), coefs.data_ptr(), icoefs.data_ptr(), N, prescale_m,
                torch.cuda.current_stream(rects.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rotated_coefs kernel launch failed: CUDA error {rc}")
    return coefs, icoefs


def rotated_sample_fast(
    frames_u8, rrects, out_w: int, out_h: int, lo: float = 0.0, hi: float = 1.0,
    prescale_m: int = PRESCALE_M, layout: str = "NHWC", mirror=None,
):
    """Rotated-view sample + colour map; see the module docstring. Calls
    :func:`rotated_sample_op`: a CUDA tensor launches the kernel (or
    raises), a CPU tensor runs the plain version."""
    if frames_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {frames_u8.device}")
    _check(frames_u8, rrects, layout, mirror)
    out = rotated_sample_op(frames_u8, rrects.reshape(-1, 5).contiguous(), out_w, out_h, lo, hi, prescale_m,
                            layout == "NCHW", list(mirror or ()))
    return _shaped(out, rrects, out_w, out_h, layout)
