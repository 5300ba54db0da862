"""RGB ↔ YUV (BT.601 full range): plain functions, and a hand-written CUDA
kernel with its plain version.

The counterparts of zaru_tpu/ops/pallas_kernels.py:129-191:

- :func:`rgb_to_yuv` and :func:`yuv_to_rgb` (:142, :149) are ``x @ M.T`` on
  float ``[..., 3]`` in [0, 1], U and V centred on 0. JAX computes them with
  XLA outside any kernel; here they stay ``torch.matmul``.
- :func:`rgb_to_yuv_fast` is the function of the TPU kernel
  ``rgb_to_yuv_pallas`` (:154): ``[H,W,3] f32`` → ``[H,W,3] f32``, each
  channel ``(m[i,0]*r + m[i,1]*g) + m[i,2]*b`` with every product and sum
  rounded on its own. On a CUDA tensor it launches ``csrc/rgb_to_yuv.cu``
  (:func:`rgb_to_yuv_launch`); on a CPU tensor it runs
  :func:`rgb_to_yuv_fast_reference`, the plain version, which is bit-equal
  to the kernel. Both are kernels of the registered op
  ``zaru_tpu_torch::rgb_to_yuv`` (:func:`rgb_to_yuv_op`). The Pallas kernel's planar transposes are a TPU lane-layout
  mechanism and are not ported: the kernel reads the interleaved layout.

No path of the JAX package runs the kernel; it is ported as a standalone
op.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import profiling
from ._build import library

__all__ = [
    "rgb_to_yuv",
    "rgb_to_yuv_fast",
    "rgb_to_yuv_fast_reference",
    "rgb_to_yuv_launch",
    "rgb_to_yuv_op",
    "yuv_to_rgb",
]

YUV_FROM_RGB = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    np.float32,
)  # pallas_kernels.py:131
RGB_FROM_YUV = np.linalg.inv(YUV_FROM_RGB).astype(np.float32)  # pallas_kernels.py:139


def _matrix(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(m).to(device=like.device, dtype=like.dtype)


def rgb_to_yuv(rgb):
    """BT.601 full-range RGB → YUV on float ``[..., 3]`` in [0, 1]."""
    return rgb @ _matrix(YUV_FROM_RGB, rgb).T


def yuv_to_rgb(yuv):
    """The inverse of :func:`rgb_to_yuv`."""
    return yuv @ _matrix(RGB_FROM_YUV, yuv).T


def _check(rgb):
    if rgb.dtype != torch.float32 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be [H,W,3] float32, got {tuple(rgb.shape)} {rgb.dtype}")


def rgb_to_yuv_fast_reference(rgb):
    """Plain PyTorch version of :func:`rgb_to_yuv_fast`, on any device: the
    kernel's arithmetic in the same order (bit-equal to it)."""
    _check(rgb)
    m = _matrix(YUV_FROM_RGB, rgb)
    r, g, b = rgb.unbind(-1)
    return torch.stack([(m[i, 0] * r + m[i, 1] * g) + m[i, 2] * b for i in range(3)], dim=-1)


def rgb_to_yuv_launch(rgb):
    """Launches ``csrc/rgb_to_yuv.cu`` on a contiguous CUDA ``[H,W,3] f32``
    → ``[H,W,3] f32``. Not counted: the registered op's CUDA kernel
    (:func:`rgb_to_yuv_op`) counts its launches."""
    _check(rgb)
    if not (rgb.is_cuda and rgb.is_contiguous()):
        raise ValueError("rgb must be a contiguous CUDA tensor")
    if rgb.data_ptr() % 16:
        rgb = rgb.clone()  # the kernel reads 16-byte vectors; a fresh tensor is aligned
    out = torch.empty_like(rgb)
    n = rgb.shape[0] * rgb.shape[1]
    if n == 0:
        return out
    fn = library("rgb_to_yuv").zaru_rgb_to_yuv
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    m = (ctypes.c_float * 9)(*YUV_FROM_RGB.ravel().tolist())
    with torch.cuda.device(rgb.device):  # the launch goes to the runtime's current device
        rc = fn(rgb.data_ptr(), out.data_ptr(), n, ctypes.addressof(m),
                torch.cuda.current_stream(rgb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rgb_to_yuv kernel launch failed: CUDA error {rc}")
    return out


@torch.library.custom_op("zaru_tpu_torch::rgb_to_yuv", mutates_args=(), device_types="cuda")
def rgb_to_yuv_op(rgb: torch.Tensor) -> torch.Tensor:
    """The conversion as a registered op: its CUDA kernel is one launch of
    :func:`rgb_to_yuv_launch`, counted in ``launches.rgb_to_yuv``; its
    CPU kernel the plain version."""
    out = rgb_to_yuv_launch(rgb.contiguous())
    profiling.counters["launches.rgb_to_yuv"] += 1
    return out


rgb_to_yuv_op.register_kernel("cpu")(rgb_to_yuv_fast_reference)


@rgb_to_yuv_op.register_fake
def _(rgb):
    return torch.empty_like(rgb, memory_format=torch.contiguous_format)


def rgb_to_yuv_fast(rgb):
    """RGB → YUV of ``[H,W,3] f32``; see the module docstring. Calls
    :func:`rgb_to_yuv_op`: a CUDA tensor launches the kernel (or raises), a
    CPU tensor runs the plain version."""
    _check(rgb)
    if rgb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rgb.device}")
    return rgb_to_yuv_op(rgb)
