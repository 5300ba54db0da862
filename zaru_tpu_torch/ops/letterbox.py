"""The letterbox sampler: hand-written CUDA kernel and its plain version.

``letterbox_sample`` is the detect path's sampler (``Cnn.
sample_views_letterbox``): frames ``[B,H,W,4] u8`` and one unrotated rect per
stream ``[B,5] f32`` → ``[B,out_h,out_w,3] f32`` NHWC or, ``layout="NCHW"``,
planar ``[B,3,out_h,out_w]``, colour-mapped. On a
CUDA tensor it launches ``csrc/letterbox_sample.cu``, which replaces the TPU
kernel ``letterbox_sample_pallas`` (zaru_tpu/ops/pallas_kernels.py:44); on a
CPU tensor it runs the plain version, :func:`letterbox_sample_reference`
(``letterbox_sample_core``, zaru_tpu/ops/sampling.py:120). Both are
bit-exact to the JAX functions. The two are the CUDA and CPU kernels of the
registered op ``zaru_tpu_torch::letterbox_sample`` (:func:`letterbox_sample_op`),
which ``torch.export`` captures.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import profiling
from ._build import library
from .sampling import color_adjust, letterbox_sample_core

__all__ = [
    "letterbox_sample", "letterbox_sample_op", "letterbox_sample_planar_reference", "letterbox_sample_reference",
]

letterbox_sample_reference = letterbox_sample_core


def _check(frames_u8, rrects):
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim != 4 or frames_u8.shape[-1] != 4:
        raise ValueError(f"frames must be [B,H,W,4] uint8, got {tuple(frames_u8.shape)} {frames_u8.dtype}")
    if rrects.dtype != torch.float32 or tuple(rrects.shape) != (frames_u8.shape[0], 5):
        raise ValueError(f"rects must be [B,5] float32, got {tuple(rrects.shape)} {rrects.dtype}")
    if rrects.device != frames_u8.device:
        raise ValueError("frames and rects must be on one device")


def letterbox_sample_planar_reference(frames_u8, rrects, out_w: int, out_h: int, lo: float, hi: float):
    """The planar layout's plain version: the NHWC one, permuted."""
    return letterbox_sample_core(frames_u8, rrects, out_w, out_h, lo, hi).permute(0, 3, 1, 2).contiguous()


@torch.library.custom_op("zaru_tpu_torch::letterbox_sample", mutates_args=(), device_types="cuda")
def letterbox_sample_op(
    frames_u8: torch.Tensor, rrects: torch.Tensor, out_w: int, out_h: int, lo: float, hi: float, planar: bool,
) -> torch.Tensor:
    """The sampler as a registered op: its CUDA kernel launches
    ``csrc/letterbox_sample.cu`` once and counts it in
    ``profiling.counters["launches.letterbox_sample"]``; its CPU kernel is
    the plain version."""
    if not (frames_u8.is_contiguous() and rrects.is_contiguous()):
        raise ValueError("frames and rects must be contiguous")
    B, H, W, _ = frames_u8.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit of 65535")
    shape = (B, 3, out_h, out_w) if planar else (B, out_h, out_w, 3)
    out = torch.empty(shape, dtype=torch.float32, device=frames_u8.device)
    fn = library("letterbox_sample").zaru_letterbox_sample
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(frames_u8.device):  # the launch goes to the runtime's current device
        rc = fn(
            frames_u8.data_ptr(), rrects.data_ptr(), out.data_ptr(), B, H, W, out_w, out_h,
            color_adjust(lo, hi), float(np.float32(lo)), int(planar),
            torch.cuda.current_stream(frames_u8.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"letterbox_sample kernel launch failed: CUDA error {rc}")
    profiling.counters["launches.letterbox_sample"] += 1
    return out


@letterbox_sample_op.register_kernel("cpu")
def _(frames_u8, rrects, out_w, out_h, lo, hi, planar):
    if planar:
        return letterbox_sample_planar_reference(frames_u8, rrects, out_w, out_h, lo, hi)
    return letterbox_sample_core(frames_u8, rrects, out_w, out_h, lo, hi)


@letterbox_sample_op.register_fake
def _(frames_u8, rrects, out_w, out_h, lo, hi, planar):
    B = frames_u8.shape[0]
    return frames_u8.new_empty((B, 3, out_h, out_w) if planar else (B, out_h, out_w, 3), dtype=torch.float32)


def letterbox_sample(
    frames_u8, rrects, out_w: int, out_h: int, lo: float, hi: float, layout: str = "NHWC"
):
    """Letterbox sample + colour map; see the module docstring. A CUDA
    tensor launches the kernel (or raises), a CPU tensor runs the plain
    version."""
    _check(frames_u8, rrects)
    if layout not in ("NHWC", "NCHW"):
        raise ValueError(f"layout must be NHWC or NCHW, got {layout!r}")
    if frames_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {frames_u8.device}")
    return letterbox_sample_op(frames_u8, rrects, out_w, out_h, lo, hi, layout == "NCHW")
