"""The port's host inputs (zaru_tpu_torch.native, image.decode's ``native``
backend, video.httpcam, video.webcam) against zaru_tpu's, on the CPU:
tests/test_video_native.py's cases on the port's modules.

- The native bridge is the port's own copy of the C++ source
  (``zaru_tpu_torch/csrc/zaru_native.cpp``), built with g++ at first use into
  ``zaru_tpu_torch/_build/``: its JPEG decode equals cv2's and JAX's native
  decode on the fixture photo and on JPEGs made with PIL, and rejects
  garbage; ``ZARU_TPU_NATIVE=0`` makes it unavailable.
- Every backend of ``decode_jpeg``, and an unknown one.
- Webcam format negotiation on made-up V4L2 mode lists (no camera is
  needed), held to JAX's ``negotiate_format`` case by case; with no camera
  attached, none is listed and opening one fails cleanly; a corrupt MJPEG frame reads as a
  blank frame (and is dumped when ``ZARU_TPU_WEBCAM_ERROR_DUMP`` is set).
- ``HttpCam`` reading a multipart MJPEG stream from a local socket server,
  with and without Content-Length, and refusing a response that is not
  multipart.
"""

import io
import socket
import threading

import numpy as np
import pytest

from torch_port import one_torch_thread  # noqa: F401


def make_jpeg(w=32, h=24, color=(255, 0, 0), seed=None) -> bytes:
    """A JPEG made with PIL: a flat colour, or seeded noise."""
    from PIL import Image as PILImage

    if seed is None:
        img = PILImage.new("RGB", (w, h), color)
    else:
        img = PILImage.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, "JPEG")
    return buf.getvalue()


def cv2_rgb(data: bytes) -> np.ndarray:
    import cv2

    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


# --- the native bridge and the decode backends --------------------------------------


@pytest.mark.parametrize("source", ["photo", "pil_flat", "pil_noise_odd"])
def test_native_decode_matches_cv2_and_jax(source):
    """The port's native decode equals cv2's and JAX's native decode."""
    from zaru_tpu.native import turbojpeg as jax_turbojpeg

    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.native import turbojpeg

    data = {"photo": lambda: fixture_path("sad_linus.jpg").read_bytes(),
            "pil_flat": lambda: make_jpeg(color=(12, 200, 77)),
            "pil_noise_odd": lambda: make_jpeg(w=67, h=45, seed=3)}[source]()
    ours = turbojpeg.decode(data)
    assert ours.dtype == np.uint8 and ours.ndim == 3 and ours.shape[2] == 3
    np.testing.assert_array_equal(ours, cv2_rgb(data))
    np.testing.assert_array_equal(ours, jax_turbojpeg.decode(data))


def test_native_garbage_rejected():
    from zaru_tpu_torch.native import turbojpeg

    with pytest.raises(ValueError):
        turbojpeg.decode(b"not a jpeg")
    with pytest.raises(ValueError):
        turbojpeg.decode(make_jpeg()[:40])  # a header cut short


def test_native_library_builds_into_the_build_dir(monkeypatch):
    """The library is named by a hash of its source and flags under
    ``zaru_tpu_torch/_build/``; ``ZARU_TPU_NATIVE=0`` makes a fresh load
    raise ``NativeUnavailable``, which ``list_devices`` takes as no device."""
    from zaru_tpu_torch import native
    from zaru_tpu_torch.video.webcam import list_devices

    native.lib()
    so = native._target()
    assert so.is_file() and so.parent.name == "_build" and so.parent.parent.name == "zaru_tpu_torch"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("ZARU_TPU_NATIVE", "0")
    with pytest.raises(native.NativeUnavailable, match="ZARU_TPU_NATIVE=0"):
        native.lib()
    assert list_devices() == []


def test_backend_selection(monkeypatch):
    """Every backend decodes a red JPEG to red, the port's and JAX's alike."""
    from zaru_tpu.image import decode as jdec

    from zaru_tpu_torch.image import decode as idec

    data = make_jpeg()
    for backend in ("cv2", "pil", "native"):
        monkeypatch.setenv("ZARU_TPU_JPEG_BACKEND", backend)
        rgb = idec.decode_jpeg(data)
        assert rgb.shape == (24, 32, 3) and rgb[:, :, 0].mean() > 200, backend
        np.testing.assert_array_equal(rgb, jdec.decode_jpeg(data))


def test_unknown_backend(monkeypatch):
    from zaru_tpu_torch.image import decode as idec

    monkeypatch.setenv("ZARU_TPU_JPEG_BACKEND", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        idec.decode_jpeg(make_jpeg())


def test_decode_pool_native(monkeypatch):
    """``DecodePool`` on the native backend decodes blobs in input order."""
    from zaru_tpu_torch.image.decode import DecodePool

    monkeypatch.setenv("ZARU_TPU_JPEG_BACKEND", "native")
    blobs = [make_jpeg(w=40, h=30, seed=s) for s in range(6)]
    pool = DecodePool(threads=3)
    try:
        got = pool.decode_batch(blobs)
    finally:
        pool.close()
    for blob, rgb in zip(blobs, got):
        np.testing.assert_array_equal(rgb, cv2_rgb(blob))


# --- webcam negotiation -----------------------------------------------------------------


def modes(pkg):
    """test_video_native.py's mode list in ``pkg``'s ``_Mode``."""
    m = pkg._Mode
    return [m(pkg._FOURCC_MJPG, 1920, 1080, 30, 1), m(pkg._FOURCC_MJPG, 1280, 720, 60, 1),
            m(pkg._FOURCC_MJPG, 640, 480, 120, 1), m(0x56595559, 3840, 2160, 30, 1)]  # YUYV, ignored


# (case, options as keyword arguments, the mode's (width, height, fps)).
NEGOTIATION = [
    ("resolution by default", {}, (1920, 1080, 30)),
    ("frame rate preferred", {"prefer": "FRAMERATE"}, (640, 480, 120)),
    ("resolution is at least", {"resolution": (1280, 720)}, (1920, 1080, 30)),
    ("floor with frame rate preferred", {"resolution": (1280, 720), "prefer": "FRAMERATE"}, (1280, 720, 60)),
    ("fps floor beats exact resolution", {"resolution": (640, 480), "fps": 60}, (1280, 720, 60)),
    ("constraint degradation", {"resolution": (1920, 1080), "fps": 500}, (1920, 1080, 30)),
]


def options_of(pkg, res_cls, kw):
    opts = {}
    if "resolution" in kw:
        opts["resolution"] = res_cls(*kw["resolution"])
    if "fps" in kw:
        opts["fps"] = kw["fps"]
    if "prefer" in kw:
        opts["prefer"] = getattr(pkg.ParamPreference, kw["prefer"])
    return pkg.WebcamOptions(**opts)


@pytest.mark.parametrize("case,kw,want", NEGOTIATION, ids=[c for c, _, _ in NEGOTIATION])
def test_negotiate_format(case, kw, want):
    """Each preference case of tests/test_video_native.py: the port picks
    the mode JAX picks."""
    import zaru_tpu.video.webcam as jcam
    from zaru_tpu.resolution import Resolution as JaxResolution

    import zaru_tpu_torch.video.webcam as cam
    from zaru_tpu_torch.resolution import Resolution

    got = cam.negotiate_format(modes(cam), options_of(cam, Resolution, kw))
    ref = jcam.negotiate_format(modes(jcam), options_of(jcam, JaxResolution, kw))
    assert (got.width, got.height, round(got.fps)) == want
    assert (ref.width, ref.height, ref.fps) == (got.width, got.height, got.fps)


def test_negotiate_non_jpeg_only():
    import zaru_tpu_torch.video.webcam as cam

    assert cam.negotiate_format([cam._Mode(0x56595559, 640, 480, 30, 1)], cam.WebcamOptions()) is None
    opts = cam.WebcamOptions().with_name("x").with_fps(30).with_prefer(cam.ParamPreference.FRAMERATE)
    assert (opts.name, opts.fps, opts.prefer) == ("x", 30, cam.ParamPreference.FRAMERATE)


def test_device_listing_and_open_without_a_camera(monkeypatch):
    """Enumeration never crashes; with no camera attached, opening one raises
    a clean error (naming the name filter, from the options or from
    ``ZARU_TPU_WEBCAM_NAME``, when one is set), as in JAX."""
    from zaru_tpu_torch.video.webcam import Webcam, WebcamOptions, list_devices

    devices = list_devices()
    assert all(isinstance(path, str) and isinstance(name, str) for path, name in devices)
    if not devices:
        with pytest.raises(RuntimeError, match="no usable V4L2"):
            Webcam.open(device="cpu")
        with pytest.raises(RuntimeError, match="matching 'cam'"):
            Webcam.open(WebcamOptions(name="cam"), device="cpu")
        monkeypatch.setenv("ZARU_TPU_WEBCAM_NAME", "front")
        with pytest.raises(RuntimeError, match="matching 'front'"):
            Webcam.open(device="cpu")


class _FakeCamLib:
    """Stands in for the native library's capture calls: each read fills
    the buffer with the next payload."""

    def __init__(self, payloads):
        self.payloads = list(payloads)

    def zj_cam_read(self, handle, buf, cap):
        data = self.payloads.pop(0)
        import ctypes

        ctypes.memmove(buf, data, len(data))
        return len(data)

    def zj_cam_close(self, handle):
        pass


def test_webcam_corrupt_frame_reads_blank(monkeypatch, tmp_path):
    """A good MJPEG frame decodes; a corrupt one reads as a blank frame of
    the mode's size (webcam.rs:291-313) and, with
    ``ZARU_TPU_WEBCAM_ERROR_DUMP``, is written there."""
    import zaru_tpu_torch.native as native
    import zaru_tpu_torch.video.webcam as cam

    good = make_jpeg(w=32, h=24, color=(0, 0, 255))
    fake = _FakeCamLib([good, b"\xff\xd8\xffgarbage", b"junk"])
    monkeypatch.setattr(native, "lib", lambda: fake)
    monkeypatch.setenv("ZARU_TPU_WEBCAM_ERROR_DUMP", str(tmp_path / "dump"))
    webcam = cam.Webcam(handle=1, mode=cam._Mode(cam._FOURCC_MJPG, 32, 24, 30, 1), path="/dev/video9", device="cpu")
    assert (webcam.resolution().width, webcam.resolution().height, webcam.fps()) == (32, 24, 30)
    frame = webcam.read().to_numpy()
    assert frame.shape == (24, 32, 4) and frame[..., 2].mean() > 200
    for _ in range(2):
        blank = webcam.read().to_numpy()
        assert blank.shape == (24, 32, 4) and not blank.any()
    assert len(list((tmp_path / "dump").glob("frame-*.jpg"))) >= 1 and not fake.payloads
    webcam.close()


# --- HttpCam -----------------------------------------------------------------------------


def serve_mjpeg(sock, jpegs, use_content_length=True):
    conn, _ = sock.accept()
    conn.recv(4096)  # the request
    conn.sendall(b"HTTP/1.0 200 OK\r\nContent-Type: multipart/x-mixed-replace; boundary=frameboundary\r\n\r\n")
    for j in jpegs:
        part = b"--frameboundary\r\nContent-Type: image/jpeg\r\n"
        if use_content_length:
            part += b"Content-Length: %d\r\n" % len(j)
        part += b"\r\n" + j + b"\r\n"
        conn.sendall(part)
    conn.sendall(b"--frameboundary--\r\n")
    conn.close()


def listening():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    return sock, sock.getsockname()[1]


@pytest.mark.parametrize("use_content_length", [True, False])
def test_httpcam_reads_frames(use_content_length):
    """Two frames from a local MJPEG server, each the decode of the JPEG
    sent, on the CPU device."""
    from zaru_tpu_torch.video.httpcam import HttpCam

    jpegs = [make_jpeg(color=(255, 0, 0)), make_jpeg(w=48, h=16, seed=5)]
    sock, port = listening()
    t = threading.Thread(target=serve_mjpeg, args=(sock, jpegs, use_content_length))
    t.start()
    try:
        cam = HttpCam(f"http://127.0.0.1:{port}/stream", device="cpu")
        f1 = cam.read()
        f2 = cam.read()
        assert str(f1.device) == "cpu" and f1.to_numpy()[..., 0].mean() > 200
        np.testing.assert_array_equal(f2.to_numpy()[..., :3], cv2_rgb(jpegs[1]))
        assert len(cam.timers()) == 2
        cam.close()
    finally:
        t.join(timeout=10)
        sock.close()
    assert not t.is_alive()


def test_httpcam_rejects_non_multipart():
    from zaru_tpu_torch.video.httpcam import HttpCam

    sock, port = listening()

    def serve():
        conn, _ = sock.accept()
        conn.recv(4096)
        conn.sendall(b"HTTP/1.0 200 OK\r\nContent-Type: text/html\r\n\r\nhi")
        conn.close()

    t = threading.Thread(target=serve)
    t.start()
    try:
        with pytest.raises(RuntimeError, match="multipart"):
            HttpCam(f"http://127.0.0.1:{port}/", device="cpu")
    finally:
        t.join(timeout=10)
        sock.close()
    assert not t.is_alive()
    with pytest.raises(ValueError, match="http://"):
        HttpCam("rtsp://127.0.0.1/stream", device="cpu")
