"""Video file input (mp4/mkv/webm/... via OpenCV): the port's own copy of
zaru_tpu/video/file.py; frames decode on the host into
:class:`~zaru_tpu_torch.image.Image` on the device the caller names.

Beyond the reference's lineup (webcam / httpcam / animated images): the
reference's TODO.txt lists "video unification" as unfinished; this module
completes the source family with a uniform frame-iterator interface.
"""

from __future__ import annotations

from pathlib import Path

from ..image import Image
from ..timer import Timer

__all__ = ["VideoFile"]


class VideoFile:
    """Decodes frames from a video file."""

    def __init__(self, path: str | Path, device=None):
        import cv2

        self._path = str(path)
        self._device = device
        self._cap = cv2.VideoCapture(self._path)
        if not self._cap.isOpened():
            raise RuntimeError(f"failed to open video file {path!r}")
        self._t_decode = Timer("decode")

    def fps(self) -> float:
        import cv2

        return float(self._cap.get(cv2.CAP_PROP_FPS) or 0.0)

    def frame_count(self) -> int:
        import cv2

        return int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)

    def resolution(self):
        import cv2

        from ..resolution import Resolution

        w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        return Resolution(w, h) if w and h else None

    def read(self) -> Image | None:
        """Next frame, or None at end of stream."""
        import cv2

        with self._t_decode.measure():
            ok, bgr = self._cap.read()
            if not ok:
                return None
            return Image.from_array(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB), self._device)

    def __iter__(self):
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def timers(self):
        return [self._t_decode]

    def close(self) -> None:
        self._cap.release()
