"""HTTP multipart-MJPEG camera client: the port's own copy of
zaru_tpu/video/httpcam.py (reference: crates/zaru/src/video/httpcam.rs).

Speaks ``multipart/x-mixed-replace`` streams as served by IP cameras and
mjpg-streamer, over plain sockets (no third-party HTTP dependency). Frames
decode on the host (``image.decode``'s backend) into
:class:`~zaru_tpu_torch.image.Image` on the device the caller names.
"""

from __future__ import annotations

import logging
import re
import socket
from urllib.parse import urlparse

from ..image import Image
from ..timer import Timer

log = logging.getLogger(__name__)

__all__ = ["HttpCam"]


class HttpCam:
    """Connects to an HTTP MJPEG stream and yields frames
    (httpcam.rs:12-127) as images on ``device`` (``cuda`` unless named)."""

    def __init__(self, url: str, timeout: float = 10.0, device=None):
        self._url = url
        self._device = device
        parsed = urlparse(url)
        if parsed.scheme != "http":
            raise ValueError(f"only http:// streams are supported, got {url!r}")
        host = parsed.hostname
        port = parsed.port or 80
        path = parsed.path or "/"
        if parsed.query:
            path += "?" + parsed.query

        self._sock = socket.create_connection((host, port), timeout=timeout)
        req = (
            f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
            "Connection: keep-alive\r\nAccept: multipart/x-mixed-replace\r\n\r\n"
        )
        self._sock.sendall(req.encode())
        self._buf = b""
        self._boundary = self._read_headers()
        self._t_read = Timer("read")
        self._t_decode = Timer("decode")

    def _recv_until(self, marker: bytes) -> bytes:
        while marker not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise EOFError("stream closed")
            self._buf += chunk
        data, _, self._buf = self._buf.partition(marker)
        return data

    def _read_headers(self) -> bytes:
        head = self._recv_until(b"\r\n\r\n")
        status_line, *headers = head.split(b"\r\n")
        if b"200" not in status_line:
            raise RuntimeError(f"HTTP error: {status_line.decode(errors='replace')}")
        ctype = next(
            (h for h in headers if h.lower().startswith(b"content-type")), b""
        )
        # Media types and parameter names are case-insensitive (RFC 9110);
        # cameras emit e.g. "Boundary=" / "Multipart/X-Mixed-Replace".
        m = re.search(rb'boundary="?([^";\s]+)"?', ctype, re.IGNORECASE)
        if not m or b"multipart" not in ctype.lower():
            raise RuntimeError(f"not a multipart MJPEG stream: {ctype.decode(errors='replace')}")
        boundary = m.group(1)
        if not boundary.startswith(b"--"):
            boundary = b"--" + boundary
        return boundary

    def read(self) -> Image:
        """Reads and decodes the next frame."""
        with self._t_read.measure():
            # Skip to the next part boundary, then parse its headers.
            self._recv_until(self._boundary)
            part_head = self._recv_until(b"\r\n\r\n")
            m = re.search(rb"content-length:\s*(\d+)", part_head, re.IGNORECASE)
            if m:
                length = int(m.group(1))
                while len(self._buf) < length:
                    chunk = self._sock.recv(65536)
                    if not chunk:
                        raise EOFError("stream closed mid-frame")
                    self._buf += chunk
                frame, self._buf = self._buf[:length], self._buf[length:]
            else:
                # No Content-Length: read until the next boundary.
                frame = self._recv_until(self._boundary)
                self._buf = self._boundary + self._buf

        with self._t_decode.measure():
            return Image.decode_jpeg(frame, self._device)

    def timers(self):
        return [self._t_read, self._t_decode]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
