"""ctypes bridge to the port's native runtime (zaru_tpu/native/__init__.py):
``zaru_tpu_torch/csrc/zaru_native.cpp``, JPEG decode through libjpeg and
V4L2 capture, on the host.

The library is built at first use (never when this module is imported)::

    g++ -O2 -fPIC -shared -Wall -o zaru_native_<hash>.so zaru_native.cpp -ljpeg

into ``zaru_tpu_torch/_build/``, named by a hash of the source and the
flags, as the CUDA kernels are (``ops/_build.py``): an edited source
rebuilds, an unchanged one is loaded as it is. It needs ``g++``, libjpeg's
headers and the V4L2 kernel headers. ``ZARU_TPU_NATIVE=0`` disables it; a
missing source, a failed build or a failed load raise
:class:`NativeUnavailable`, which callers take as "use the Python paths".
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

log = logging.getLogger(__name__)

__all__ = ["NativeUnavailable", "lib"]

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
_SOURCE = _PACKAGE_DIR / "csrc" / "zaru_native.cpp"
_BUILD_DIR = _PACKAGE_DIR / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-Wall"]
LIBS = ["-ljpeg"]

_lib = None
_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _target() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return _BUILD_DIR / f"zaru_native_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(_SOURCE), *LIBS]
    log.info("building the native library: %s", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeUnavailable(f"native build failed: {detail}") from e
    os.replace(tmp, so)


def lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("ZARU_TPU_NATIVE", "1") == "0":
            raise NativeUnavailable("disabled via ZARU_TPU_NATIVE=0")
        if not _SOURCE.is_file():
            raise NativeUnavailable(f"native source not found at {_SOURCE}; set ZARU_TPU_NATIVE=0 to silence")
        so = _target()
        if not so.is_file():
            _build(so)
        try:
            loaded = ctypes.CDLL(str(so))
        except OSError as e:
            raise NativeUnavailable(f"native library load failed: {e}") from e
        _configure(loaded)
        _lib = loaded
        return _lib


def _configure(l: ctypes.CDLL) -> None:
    l.zj_jpeg_size.restype = ctypes.c_int
    l.zj_jpeg_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
    l.zj_jpeg_decode.restype = ctypes.c_int
    l.zj_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_size_t]
    l.zj_cam_query.restype = ctypes.c_int
    l.zj_cam_query.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint32)]
    l.zj_cam_enum.restype = ctypes.c_int
    l.zj_cam_enum.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
    l.zj_cam_open.restype = ctypes.c_void_p
    l.zj_cam_open.argtypes = [ctypes.c_char_p] + [ctypes.c_uint32] * 5
    l.zj_cam_read.restype = ctypes.c_long
    l.zj_cam_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    l.zj_cam_close.restype = None
    l.zj_cam_close.argtypes = [ctypes.c_void_p]
