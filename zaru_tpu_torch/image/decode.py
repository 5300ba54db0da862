"""Image decoding with selectable backends: the port's own copy of
zaru_tpu/image/decode.py.

Mirrors the reference's multi-backend JPEG design (zaru-image/src/jpeg.rs:
53-70: 5 software decoders selectable via env var, because no single CPU
decoder hit 4K30): backends here are selected with ``ZARU_TPU_JPEG_BACKEND``:

- ``cv2``      — OpenCV/libjpeg-turbo (default; fastest available in-process)
- ``pil``      — Pillow
- ``native``   — libjpeg through the port's C++ bridge
                 (:mod:`zaru_tpu_torch.native`, built at first use)

Each is imported when a frame is decoded, not when this module is; a
backend that cannot be imported falls back to cv2 with a warning, as in
JAX. PNG/GIF/APNG go through PIL regardless. :class:`DecodePool` decodes
frames on a thread pool.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["DecodePool", "decode_jpeg", "load_image", "jpeg_backend"]


def jpeg_backend() -> str:
    return os.environ.get("ZARU_TPU_JPEG_BACKEND", "cv2")


def _decode_jpeg_cv2(data: bytes) -> np.ndarray:
    import cv2

    arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if arr is None:
        raise ValueError("cv2 failed to decode JPEG data")
    return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)


def _decode_jpeg_pil(data: bytes) -> np.ndarray:
    import io

    from PIL import Image as PILImage

    return np.asarray(PILImage.open(io.BytesIO(data)).convert("RGB"))


def _decode_jpeg_native(data: bytes) -> np.ndarray:
    from ..native import turbojpeg

    return turbojpeg.decode(data)


_BACKENDS = {
    "cv2": _decode_jpeg_cv2,
    "pil": _decode_jpeg_pil,
    "native": _decode_jpeg_native,
}


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decodes JPEG bytes to ``[H, W, 3] uint8`` RGB
    (reference jpeg.rs:107-232)."""
    backend = jpeg_backend()
    fn = _BACKENDS.get(backend)
    if fn is None:
        raise ValueError(
            f"unknown ZARU_TPU_JPEG_BACKEND {backend!r}; have {sorted(_BACKENDS)}"
        )
    try:
        return fn(data)
    except ImportError as e:
        log.warning("JPEG backend %s unavailable (%s); falling back to cv2", backend, e)
        return _decode_jpeg_cv2(data)


def load_image(path: str | Path) -> np.ndarray:
    """Loads any supported image file as ``[H, W, 3|4] uint8`` RGB(A)
    (reference decode.rs:29-75)."""
    path = Path(path)
    data = path.read_bytes()
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data)
    from io import BytesIO

    from PIL import Image as PILImage

    img = PILImage.open(BytesIO(data))
    if img.mode in ("RGBA", "LA", "P"):
        return np.asarray(img.convert("RGBA"))
    return np.asarray(img.convert("RGB"))


class DecodePool:
    """A thread pool of :func:`decode_jpeg` (zaru_tpu/image/decode.py:95):
    cv2 (libjpeg-turbo) and the native backend release the interpreter lock
    while they decode, so frames decode in parallel on the host's cores."""

    def __init__(self, threads: int = 8):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=threads)
        self.threads = threads

    def decode_batch(self, blobs) -> list[np.ndarray]:
        """Decodes JPEG blobs concurrently: RGB arrays in input order."""
        return list(self._pool.map(decode_jpeg, blobs))

    def submit(self, blob: bytes):
        """One frame's decode, as a ``Future`` of its RGB array."""
        return self._pool.submit(decode_jpeg, blob)

    def close(self):
        self._pool.shutdown(wait=False)
