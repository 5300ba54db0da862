"""GUI event loop: per-key windows driven from the main thread
(zaru_tpu/gui/loop.py).

The *main* thread owns the window system and runs the event loop; the user
callback runs on a spawned thread and hands frames over through
``show_image``; closing a window or pressing ESC/``q`` ends the loop, which
ends the app. Window titles carry a live FPS readout. Frames reach the loop
as host ``[H, W, 3|4] uint8`` arrays (``show_image`` reads a device frame
on the caller's thread), so nothing here touches CUDA.

Renderers (``ZARU_TPU_GUI``):

- ``cv2``  — OpenCV HighGUI windows; every HighGUI call stays on the loop
  thread (cv2's requirement), frames coalesce to latest-wins per window.
- ``file`` — every frame appended as a PNG under ``ZARU_TPU_GUI_DIR``
  (default ``zaru_tpu_gui`` in the temporary directory); nothing is dropped (the recording analog). The PNG encoder is the
  package's own (numpy and zlib), so it runs where no OpenCV is installed;
  it writes what ``cv2.imwrite`` writes with OpenCV's defaults.
- ``none`` — frames are counted and discarded.
"""

from __future__ import annotations

import logging
import os
import struct
import tempfile
import threading
import time
import zlib
from collections import deque
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["EventLoop", "make_renderer", "encode_png"]

_ESC = 27
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_IDAT_BYTES = 8192  # libpng's compression buffer: one IDAT chunk each


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``rgb`` (``[H, W, 3] uint8``), byte for byte what
    OpenCV's ``imwrite`` writes with its defaults (libpng with the Sub
    filter on every row of more than one pixel, zlib level 1 with the RLE strategy, the window
    and the zlib header's window field shrunk for small images as libpng
    does, IDAT chunks of 8192 bytes)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, w * 3)
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]  # Sub: each byte minus the one a pixel left (mod 256)
    # libpng drops Sub for one-pixel rows (filter type 0, None).
    kind = np.full((h, 1), 1 if w > 1 else 0, np.uint8)
    raw = np.concatenate([kind, sub], axis=1).tobytes()
    size = len(raw)
    wbits = 15  # libpng's png_deflate_claim: the window for small images
    if size <= 16384:
        half = 1 << (wbits - 1)
        while size + 262 <= half:
            half >>= 1
            wbits -= 1
    comp = zlib.compressobj(1, zlib.DEFLATED, max(wbits, 9), 8, zlib.Z_RLE)
    data = bytearray(comp.compress(raw) + comp.flush())
    cinfo = data[0] >> 4  # libpng's optimize_cmf: the header's window field
    half = 1 << (cinfo + 7)
    if size <= half:
        while True:
            half >>= 1
            cinfo -= 1
            if cinfo == 0 or size > half:
                break
    cmf = (cinfo << 4) | 8
    flg = data[1] & 0xE0
    data[0], data[1] = cmf, flg | (31 - (cmf * 256 + flg) % 31)
    out = [_PNG_SIGNATURE, _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    out += [_png_chunk(b"IDAT", bytes(data[i:i + _IDAT_BYTES])) for i in range(0, len(data), _IDAT_BYTES)]
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


class _Renderer:
    #: True → only the newest pending frame per window is rendered.
    coalesce = True

    def render(self, key: str, frame) -> None:
        raise NotImplementedError

    def poll(self) -> bool:
        """Pump window events; returns False to request loop shutdown."""
        time.sleep(0.005)
        return True

    def set_title(self, key: str, title: str) -> None:
        pass

    def close(self) -> None:
        pass


class NullRenderer(_Renderer):
    def __init__(self):
        self.frames = 0

    def render(self, key, frame):
        self.frames += 1


class FileRenderer(_Renderer):
    """PNG-per-frame sink (headless recording): ``<dir>/<key>/000000.png``,
    ``000001.png``, ..."""

    coalesce = False

    def __init__(self, directory: str | None = None):
        self.dir = Path(directory or os.environ.get("ZARU_TPU_GUI_DIR")
                        or Path(tempfile.gettempdir()) / "zaru_tpu_gui")
        self._counters: dict[str, int] = {}

    def render(self, key, frame):
        out_dir = self.dir / key
        out_dir.mkdir(parents=True, exist_ok=True)
        n = self._counters.get(key, 0)
        self._counters[key] = n + 1
        (out_dir / f"{n:06d}.png").write_bytes(encode_png(frame[..., :3]))


class Cv2Renderer(_Renderer):
    """Interactive HighGUI windows; must run on one thread (the loop's)."""

    def __init__(self):
        import cv2

        self._cv2 = cv2
        self._windows: set[str] = set()

    def render(self, key, frame):
        cv2 = self._cv2
        if key not in self._windows:
            cv2.namedWindow(key, cv2.WINDOW_AUTOSIZE)
            self._windows.add(key)
        cv2.imshow(key, cv2.cvtColor(frame[..., :3], cv2.COLOR_RGB2BGR))

    def poll(self) -> bool:
        cv2 = self._cv2
        if not self._windows:
            time.sleep(0.005)
            return True
        k = cv2.waitKey(15) & 0xFF
        if k in (_ESC, ord("q")):
            log.info("ESC/q pressed; shutting down")
            return False
        for key in self._windows:
            # A window the user closed reads as not visible.
            if cv2.getWindowProperty(key, cv2.WND_PROP_VISIBLE) < 1:
                log.info("window %r closed; shutting down", key)
                return False
        return True

    def set_title(self, key, title):
        if key in self._windows:
            self._cv2.setWindowTitle(key, title)

    def close(self):
        self._cv2.destroyAllWindows()


def make_renderer(backend: str) -> _Renderer:
    if backend == "cv2":
        return Cv2Renderer()
    if backend == "file":
        return FileRenderer()
    if backend == "none":
        return NullRenderer()
    raise ValueError(f"unknown ZARU_TPU_GUI backend {backend!r}")


class EventLoop:
    """Latest-wins (or fully-queued) frame mailbox + render/poll loop."""

    def __init__(self, renderer: _Renderer):
        self.renderer = renderer
        self._mailbox: dict[str, deque] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._user_done = threading.Event()
        self._stop = threading.Event()
        self.exit_code: int | None = None
        self.ui_requested_exit = False
        self._fps_count: dict[str, int] = {}
        self._fps_t0 = time.monotonic()

    # --- called from any thread ------------------------------------------

    def post(self, key: str, frame) -> None:
        with self._lock:
            q = self._mailbox.setdefault(key, deque(maxlen=1 if self.renderer.coalesce else None))
            q.append(frame)
        self._wake.set()

    def request_stop(self, code: int = 0) -> None:
        """Programmatic shutdown (what closing a window does)."""
        self.exit_code = code
        self.ui_requested_exit = True
        self._stop.set()
        self._wake.set()

    def notify_user_done(self) -> None:
        self._user_done.set()
        self._wake.set()

    # --- main thread ---------------------------------------------------------

    def _drain_once(self) -> int:
        with self._lock:
            batch = []
            for key, q in self._mailbox.items():
                if not q:
                    continue
                if self.renderer.coalesce:
                    batch.append((key, [q.popleft()]))
                else:
                    # Recording sinks keep every frame: drain the whole
                    # queue each iteration, or a producer above ~200 fps
                    # outruns the 5 ms poll and the queue grows all run.
                    frames = list(q)
                    q.clear()
                    batch.append((key, frames))
        n = 0
        for key, frames in batch:
            for frame in frames:
                self.renderer.render(key, frame)
            n += len(frames)
            self._fps_count[key] = self._fps_count.get(key, 0) + len(frames)
        now = time.monotonic()
        if now - self._fps_t0 >= 1.0:
            dt = now - self._fps_t0
            for key, cnt in self._fps_count.items():
                if cnt:
                    self.renderer.set_title(key, f"{key} — {cnt / dt:.0f} FPS")
            self._fps_count = {k: 0 for k in self._fps_count}
            self._fps_t0 = now
        return n

    def _pending(self) -> bool:
        with self._lock:
            return any(self._mailbox.values())

    def run(self) -> None:
        """Runs until the UI requests exit, or the user callback finished
        AND the mailbox is drained. Call it on the thread that owns the
        window system."""
        try:
            while not self._stop.is_set():
                rendered = self._drain_once()
                if not self.renderer.poll():
                    self.ui_requested_exit = True
                    self.exit_code = 0
                    break
                if self._user_done.is_set() and not self._pending():
                    break
                if not rendered:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            # Final drain so recording sinks keep every frame.
            while self._pending():
                self._drain_once()
        finally:
            self.renderer.close()
