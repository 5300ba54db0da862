"""V4L2 webcam capture: the port's own copy of zaru_tpu/video/webcam.py
(reference: crates/zaru/src/video/webcam.rs).

Device access goes through the port's native C++ layer
(``zaru_tpu_torch/csrc/zaru_native.cpp``, :mod:`zaru_tpu_torch.native`);
frames decode on the host into :class:`~zaru_tpu_torch.image.Image` on the
device the caller names;
format negotiation, preference sorting, and error resilience mirror the
reference:

- devices enumerated from /dev/video*, filtered by capture capability and
  ``ZARU_TPU_WEBCAM_NAME`` (webcam.rs:203,214-236);
- JPEG/MJPG pixel formats preferred, candidate (resolution, fps) modes
  sorted by :class:`ParamPreference`, constraints dropped progressively when
  nothing matches (webcam.rs:97-190);
- corrupted MJPEG frames decode to a *blank* frame instead of erroring,
  with an optional dump hook ``ZARU_TPU_WEBCAM_ERROR_DUMP``
  (webcam.rs:291-313).
"""

from __future__ import annotations

import ctypes
import enum
import glob
import logging
import os
import time
from dataclasses import dataclass, replace

from ..image import Image, decode as idec
from ..resolution import Resolution
from ..timer import Timer

log = logging.getLogger(__name__)

__all__ = ["ParamPreference", "WebcamOptions", "Webcam", "list_devices"]

_FOURCC_MJPG = 0x47504A4D  # 'MJPG'
_FOURCC_JPEG = 0x4745504A  # 'JPEG'
_CAP_VIDEO_CAPTURE = 0x00000001


class ParamPreference(enum.Enum):
    """What to optimize when the requested mode is unavailable
    (webcam.rs:20-38)."""

    RESOLUTION = "resolution"
    FRAMERATE = "framerate"


@dataclass(frozen=True)
class WebcamOptions:
    """Builder-style webcam options (webcam.rs:41-94)."""

    name: str | None = None
    resolution: Resolution | None = None
    fps: int | None = None
    prefer: ParamPreference = ParamPreference.RESOLUTION

    def with_name(self, name: str) -> "WebcamOptions":
        return replace(self, name=name)

    def with_resolution(self, resolution: Resolution) -> "WebcamOptions":
        return replace(self, resolution=resolution)

    def with_fps(self, fps: int) -> "WebcamOptions":
        return replace(self, fps=fps)

    def with_prefer(self, prefer: ParamPreference) -> "WebcamOptions":
        return replace(self, prefer=prefer)


@dataclass(frozen=True)
class _Mode:
    fourcc: int
    width: int
    height: int
    fps_num: int
    fps_den: int

    @property
    def fps(self) -> float:
        return self.fps_num / max(1, self.fps_den)


def list_devices() -> list[tuple[str, str]]:
    """Returns (path, card name) for all V4L2 capture devices."""
    from ..native import NativeUnavailable, lib

    out = []
    try:
        l = lib()
    except NativeUnavailable as e:
        log.warning("native V4L2 layer unavailable: %s", e)
        return out
    for path in sorted(glob.glob("/dev/video*")):
        name = ctypes.create_string_buffer(64)
        caps = ctypes.c_uint32()
        if l.zj_cam_query(path.encode(), name, 64, ctypes.byref(caps)) == 0:
            if caps.value & _CAP_VIDEO_CAPTURE:
                out.append((path, name.value.decode(errors="replace")))
    return out


def _enum_modes(path: str) -> list[_Mode]:
    from ..native import lib

    l = lib()
    cap = 512
    arr = (ctypes.c_uint32 * (cap * 5))()
    n = l.zj_cam_enum(path.encode(), arr, cap)
    modes = []
    for i in range(max(0, n)):
        modes.append(
            _Mode(arr[i * 5], arr[i * 5 + 1], arr[i * 5 + 2], arr[i * 5 + 3], arr[i * 5 + 4])
        )
    return modes


def negotiate_format(modes: list[_Mode], options: WebcamOptions) -> _Mode | None:
    """Picks the best JPEG mode per the option constraints, dropping them
    progressively — reference semantics (webcam.rs:96-190):

    - constraints are *at least*: resolution eligible when both dims >=
      the requested size; fps eligible when round(fps) >= requested
      (negotiate_format_step, webcam.rs:167-190);
    - among eligible modes the preference is enforced by the SORT
      (maximize pixels then fps, or fps then pixels);
    - on failure the PREFERRED constraint is dropped first
      (webcam.rs:148-161: prefer resolution takes the resolution
      constraint first — the sort still chases max resolution), then
      the other; both gone means no JPEG mode exists at all.
    """
    jpeg = [m for m in modes if m.fourcc in (_FOURCC_MJPG, _FOURCC_JPEG)]
    if not jpeg:
        return None

    def sort_key(m: _Mode):
        if options.prefer == ParamPreference.RESOLUTION:
            return (m.width * m.height, m.fps)
        return (m.fps, m.width * m.height)

    res, fps = options.resolution, options.fps
    while True:
        candidates = [
            m for m in jpeg
            if (res is None or (m.width >= res.width and m.height >= res.height))
            and (fps is None or round(m.fps) >= fps)
        ]
        if candidates:
            return max(candidates, key=sort_key)
        if options.prefer == ParamPreference.RESOLUTION:
            if res is not None:
                res = None
            elif fps is not None:
                fps = None
            else:
                return None
        else:
            if fps is not None:
                fps = None
            elif res is not None:
                res = None
            else:
                return None


class Webcam:
    """A V4L2 webcam capture stream (webcam.rs:191-346)."""

    def __init__(self, handle, mode: _Mode, path: str, device=None):
        self._handle = handle
        self._mode = mode
        self._path = path
        self._device = device
        self._buf = (ctypes.c_uint8 * (mode.width * mode.height * 4 + (1 << 16)))()
        self._t_dequeue = Timer("dequeue")
        self._t_decode = Timer("decode")

    @staticmethod
    def open(options: WebcamOptions | None = None, device=None) -> "Webcam":
        """The first capture device (matching ``options.name`` or
        ``ZARU_TPU_WEBCAM_NAME``) that offers a JPEG mode and opens; its
        frames come as images on ``device`` (``cuda`` unless named)."""
        options = options or WebcamOptions()
        name_filter = options.name or os.environ.get("ZARU_TPU_WEBCAM_NAME")
        devices = list_devices()
        if name_filter:
            devices = [d for d in devices if name_filter.lower() in d[1].lower()]
        if not devices:
            raise RuntimeError(
                "no usable V4L2 capture device found"
                + (f" matching {name_filter!r}" if name_filter else "")
            )
        errors = []
        for path, card in devices:
            modes = _enum_modes(path)
            mode = negotiate_format(modes, options)
            if mode is None:
                errors.append(f"{path} ({card}): no JPEG mode")
                continue
            from ..native import lib

            handle = lib().zj_cam_open(
                path.encode(), mode.fourcc, mode.width, mode.height,
                mode.fps_num, mode.fps_den,
            )
            if not handle:
                errors.append(f"{path} ({card}): open failed")
                continue
            log.debug("opened %s (%s) at %dx%d@%.0f", path, card, mode.width, mode.height, mode.fps)
            return Webcam(handle, mode, path, device)
        raise RuntimeError("failed to open any webcam: " + "; ".join(errors))

    def resolution(self) -> Resolution:
        return Resolution(self._mode.width, self._mode.height)

    def fps(self) -> float:
        return self._mode.fps

    def read(self) -> Image:
        """Dequeues and decodes one frame; corrupted frames yield a blank
        image (webcam.rs:287-313)."""
        from ..native import lib

        with self._t_dequeue.measure():
            n = lib().zj_cam_read(self._handle, self._buf, len(self._buf))
        if n <= 0:
            raise RuntimeError("webcam read failed")
        data = bytes(self._buf[:n])
        with self._t_decode.measure():
            try:
                rgb = idec.decode_jpeg(data)
                return Image.from_array(rgb, self._device)
            except Exception as e:
                dump = os.environ.get("ZARU_TPU_WEBCAM_ERROR_DUMP")
                if dump:
                    # The dump must never break the blank-frame contract
                    # (webcam.rs:291-313): a missing/unwritable dump dir
                    # logs and moves on.
                    fname = f"{dump}/frame-{int(time.time() * 1e3)}.jpg"
                    try:
                        os.makedirs(dump, exist_ok=True)
                        with open(fname, "wb") as f:
                            f.write(data)
                        log.error("corrupted frame dumped to %s (%s)", fname, e)
                    except OSError as dump_err:
                        log.error(
                            "failed to decode frame (%s); dump to %s also "
                            "failed (%s), returning blank", e, fname, dump_err,
                        )
                else:
                    log.error("failed to decode frame, returning blank: %s", e)
                return Image.new(self._mode.width, self._mode.height, self._device)

    def timers(self):
        return [self._t_dequeue, self._t_decode]

    def close(self) -> None:
        if self._handle:
            from ..native import lib

            lib().zj_cam_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
