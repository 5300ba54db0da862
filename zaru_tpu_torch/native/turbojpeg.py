"""Native JPEG decode backend (zaru_tpu/native/turbojpeg.py): libjpeg through
the port's C++ bridge (``csrc/zaru_native.cpp``).

Selected with ``ZARU_TPU_JPEG_BACKEND=native`` (the analog of the
reference's ``ZARU_JPEG_BACKEND``, zaru-image/src/jpeg.rs:53-75). The
decode runs in C with the interpreter lock released (ctypes), so a
``DecodePool`` decodes frames in parallel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import lib

__all__ = ["decode"]


def decode(data: bytes) -> np.ndarray:
    """Decodes JPEG bytes to an ``[H, W, 3] uint8`` RGB array; raises
    ValueError on data that is not a JPEG it can decode."""
    l = lib()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if l.zj_jpeg_size(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("invalid JPEG data (header parse failed)")
    out = np.empty((h.value, w.value, 3), np.uint8)
    err = ctypes.create_string_buffer(200)
    rc = l.zj_jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p), w.value, h.value, err, len(err))
    if rc != 0:
        raise ValueError(f"JPEG decode failed: {err.value.decode()}")
    return out
