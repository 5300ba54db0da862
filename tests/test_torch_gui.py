"""The port's GUI event loop and app harness (zaru_tpu_torch.gui), held to
tests/test_gui_loop.py's cases on the file and null back-ends, to a
patched cv2 for the HighGUI back-end, and to the JAX package's file
back-end byte for byte (the port's PNG encoder against cv2.imwrite)."""

import logging
import threading
import time
import types

import numpy as np
import pytest
import torch

from torch_port import one_torch_thread  # noqa: F401

from zaru_tpu_torch import gui
from zaru_tpu_torch.gui.loop import EventLoop, FileRenderer, NullRenderer, encode_png


@pytest.fixture(autouse=True)
def loggers_given_back():
    """``gui.run`` and ``init_logger`` set the package's and the app's log
    levels; give them back after each test."""
    levels = {n: logging.getLogger(n).level for n in ("zaru_tpu_torch", "__main__")}
    yield
    for n, level in levels.items():
        logging.getLogger(n).setLevel(level)


def _frame(v=0):
    return np.full((8, 8, 4), v, np.uint8)


class TestEventLoop:
    def test_file_renderer_keeps_every_frame(self, tmp_path):
        loop = EventLoop(FileRenderer(str(tmp_path)))

        def app():
            for i in range(5):
                loop.post("win", _frame(i))
            loop.notify_user_done()

        t = threading.Thread(target=app)
        t.start()
        loop.run()
        t.join()
        files = sorted((tmp_path / "win").glob("*.png"))
        assert len(files) == 5  # recording sink: nothing dropped

    def test_null_renderer_coalesces(self):
        r = NullRenderer()
        loop = EventLoop(r)
        for i in range(100):
            loop.post("win", _frame(i))
        loop.notify_user_done()
        loop.run()
        assert 1 <= r.frames < 100  # latest-wins mailbox

    def test_request_stop_ends_loop(self):
        loop = EventLoop(NullRenderer())

        def app():
            loop.post("win", _frame())
            time.sleep(0.05)
            loop.request_stop(3)
            time.sleep(10)  # the loop must not wait for the app

        t = threading.Thread(target=app, daemon=True)
        t.start()
        t0 = time.monotonic()
        loop.run()
        assert time.monotonic() - t0 < 5
        assert loop.ui_requested_exit
        assert loop.exit_code == 3

    def test_multiple_windows(self, tmp_path):
        loop = EventLoop(FileRenderer(str(tmp_path)))
        for key in ("a", "b"):
            loop.post(key, _frame())
        loop.notify_user_done()
        loop.run()
        assert (tmp_path / "a" / "000000.png").is_file()
        assert (tmp_path / "b" / "000000.png").is_file()


class TestRunHarness:
    def test_run_renders_and_exits_cleanly(self, tmp_path, monkeypatch):
        monkeypatch.setenv("ZARU_TPU_GUI", "file")
        monkeypatch.setenv("ZARU_TPU_GUI_DIR", str(tmp_path))

        def app():
            for i in range(3):
                gui.show_image("w", _frame(i))

        gui.run(app)  # returns without SystemExit on success
        assert len(list((tmp_path / "w").glob("*.png"))) == 3

    def test_run_maps_error_to_exit_code(self, monkeypatch):
        monkeypatch.setenv("ZARU_TPU_GUI", "none")

        def app():
            raise RuntimeError("boom")

        with pytest.raises(SystemExit) as e:
            gui.run(app)
        assert e.value.code == 1

    def test_run_nonzero_return_becomes_exit_code(self, monkeypatch):
        monkeypatch.setenv("ZARU_TPU_GUI", "none")
        with pytest.raises(SystemExit) as e:
            gui.run(lambda: 7)
        assert e.value.code == 7

    def test_main_decorator_runs_on_call_not_decoration(self, monkeypatch):
        monkeypatch.setenv("ZARU_TPU_GUI", "none")
        ran = []

        @gui.main
        def app():
            ran.append(helper())

        def helper():  # defined after the decorated function, like real apps
            return 42

        assert ran == []  # decoration did not run it
        app()
        assert ran == [42]

    def test_init_logger_accepts_lowercase_env(self, monkeypatch):
        monkeypatch.setenv("ZARU_TPU_LOG", "debug")
        gui.init_logger()  # must not raise ValueError('Unknown level')
        assert logging.getLogger("zaru_tpu_torch").level == logging.DEBUG
        monkeypatch.setenv("ZARU_TPU_LOG", "warning")
        gui.init_logger()
        assert logging.getLogger("zaru_tpu_torch").level == logging.WARNING

    def test_file_renderer_drains_fast_producer(self, tmp_path, monkeypatch):
        """A producer faster than the 5 ms poll still gets every frame
        recorded promptly (whole-queue drain per iteration)."""
        monkeypatch.setenv("ZARU_TPU_GUI", "file")
        monkeypatch.setenv("ZARU_TPU_GUI_DIR", str(tmp_path))
        n = 300

        def app():
            for i in range(n):
                gui.show_image("w", _frame(i))

        t0 = time.monotonic()
        gui.run(app)
        assert len(list((tmp_path / "w").glob("*.png"))) == n
        assert time.monotonic() - t0 < 10

    def test_request_stop_from_app(self, monkeypatch):
        monkeypatch.setenv("ZARU_TPU_GUI", "none")

        def app():
            gui.show_image("w", _frame())
            gui.request_stop(0)
            time.sleep(10)  # the loop must not wait for us

        t0 = time.monotonic()
        with pytest.raises(SystemExit) as e:
            gui.run(app)
        assert time.monotonic() - t0 < 5
        assert e.value.code == 0

    def test_gui_file_backend_standalone(self, tmp_path, monkeypatch):
        """Outside ``run``, ``show_image`` renders directly
        (tests/test_examples.py::test_gui_file_backend)."""
        from zaru_tpu_torch.image import Image

        monkeypatch.setenv("ZARU_TPU_GUI", "file")
        monkeypatch.setenv("ZARU_TPU_GUI_DIR", str(tmp_path))
        gui.show_image("testwin", Image.new(8, 8, device="cpu"))
        assert len(list((tmp_path / "testwin").glob("*.png"))) == 1


def _fake_cv2(keys):
    """A cv2 stand-in recording HighGUI calls; ``waitKey`` waits its
    milliseconds and returns the next of ``keys`` (then -1)."""
    calls = []
    keys = list(keys)
    cv2 = types.SimpleNamespace(
        WINDOW_AUTOSIZE=1, WND_PROP_VISIBLE=4, COLOR_RGB2BGR=4, calls=calls,
        namedWindow=lambda key, flags: calls.append(("namedWindow", key)),
        imshow=lambda key, img: calls.append(("imshow", key, img.shape)),
        cvtColor=lambda img, code: np.ascontiguousarray(img[..., ::-1]),
        waitKey=lambda ms: (time.sleep(ms / 1000), keys.pop(0) if keys else -1)[1],  # waits as HighGUI does
        getWindowProperty=lambda key, prop: 1.0,
        setWindowTitle=lambda key, title: calls.append(("setWindowTitle", key)),
        destroyAllWindows=lambda: calls.append(("destroyAllWindows",)),
    )
    return cv2


@pytest.mark.parametrize("key", [27, ord("q")])
def test_cv2_backend_esc_or_q_ends_the_app(key, monkeypatch):
    """The HighGUI back-end with cv2 patched: windows open on the loop
    thread, ESC or ``q`` ends the app with code 0 while it still runs, the
    windows are destroyed."""
    cv2 = _fake_cv2([-1, -1, key])
    monkeypatch.setitem(__import__("sys").modules, "cv2", cv2)
    monkeypatch.setenv("ZARU_TPU_GUI", "cv2")
    shown = threading.Event()
    loop_thread = []

    def app():
        gui.show_image("cam", torch.zeros((6, 5, 4), dtype=torch.uint8))
        shown.set()
        time.sleep(10)  # the loop must not wait for us

    real_imshow = cv2.imshow
    cv2.imshow = lambda k, img: (loop_thread.append(threading.current_thread()), real_imshow(k, img))
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as e:
        gui.run(app)
    assert time.monotonic() - t0 < 5 and e.value.code == 0 and shown.is_set()
    assert ("namedWindow", "cam") in cv2.calls and ("imshow", "cam", (6, 5, 3)) in cv2.calls
    assert loop_thread and all(t is threading.main_thread() for t in loop_thread)
    assert cv2.calls[-1] == ("destroyAllWindows",)


def test_show_image_takes_port_images_and_tensors(tmp_path, monkeypatch):
    """A port ``Image``, a u8 tensor and a numpy array give the same PNG;
    the loop receives host arrays."""
    from zaru_tpu_torch.image import Image

    monkeypatch.setenv("ZARU_TPU_GUI", "file")
    monkeypatch.setenv("ZARU_TPU_GUI_DIR", str(tmp_path))
    rgba = np.random.default_rng(0).integers(0, 256, (12, 10, 4), dtype=np.uint8)
    image = Image(rgba, device="cpu")
    posted = []
    real_post = EventLoop.post
    monkeypatch.setattr(EventLoop, "post", lambda self, k, f: (posted.append(type(f)), real_post(self, k, f)))

    def app():
        gui.show_image("w", image)
        gui.show_image("w", torch.from_numpy(rgba))
        gui.show_image("w", rgba)

    gui.run(app)
    files = sorted((tmp_path / "w").glob("*.png"))
    assert len(files) == 3 and posted == [np.ndarray] * 3
    assert len({f.read_bytes() for f in files}) == 1


def _frames():
    """Three RGBA frames: the photo's top-left 240×320, random pixels at an
    odd size, and 8×8 (libpng's smallest zlib window)."""
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.image import Image

    photo = Image.load(fixture_path("sad_linus.jpg"), device="cpu").to_numpy()[:240, :320]
    noise = np.random.default_rng(1).integers(0, 256, (37, 53, 4), dtype=np.uint8)
    return [np.ascontiguousarray(photo), noise, _frame(9)]


def test_file_backend_bytes_equal_jax(tmp_path, monkeypatch):
    """The same three frames through ``zaru_tpu.gui`` (cv2.imwrite) and
    ``zaru_tpu_torch.gui`` (its own encoder) under the file back-end give
    byte-equal PNG files."""
    from zaru_tpu import gui as jax_gui
    from zaru_tpu_torch.image import Image

    frames = _frames()
    monkeypatch.setenv("ZARU_TPU_GUI", "file")
    for name, mod, feed in (("jax", jax_gui, lambda f: f), ("port", gui, lambda f: Image(f, device="cpu"))):
        monkeypatch.setenv("ZARU_TPU_GUI_DIR", str(tmp_path / name))

        def app():
            for f in frames:
                mod.show_image("w", feed(f))

        mod.run(app)
    jax_files = sorted((tmp_path / "jax" / "w").glob("*.png"))
    port_files = sorted((tmp_path / "port" / "w").glob("*.png"))
    assert [f.name for f in jax_files] == [f.name for f in port_files] == ["000000.png", "000001.png", "000002.png"]
    for a, b in zip(jax_files, port_files):
        assert a.read_bytes() == b.read_bytes(), a.name


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (64, 80), (300, 400)])
def test_encode_png_equals_cv2(shape):
    """The encoder against cv2.imencode at sizes that take each zlib
    window (1×1 and 3×5 the smallest, 64×80 a shrunk one, 300×400 the full
    window over several IDAT chunks), on noise and on flat regions; the
    file decodes back to the pixels."""
    import cv2

    rng = np.random.default_rng(sum(shape))
    flat = np.full((*shape, 3), 7, np.uint8)
    flat[shape[0] // 3:, : shape[1] // 2] = 200
    for rgb in (rng.integers(0, 256, (*shape, 3), dtype=np.uint8), flat):
        ok, want = cv2.imencode(".png", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        got = encode_png(rgb)
        assert ok and got == want.tobytes()
        back = cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(back[..., ::-1], rgb)
