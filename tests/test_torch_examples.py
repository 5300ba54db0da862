"""The demo examples on the port (zaru_tpu_torch/examples), run headless
on the CPU as tests/test_examples.py runs the JAX package's: every script
of its RUNNABLE list but jpegbench (a measurement script, run with the
others in tests/test_torch_bench_examples.py), the animation and
face-recognition examples, and the usage errors. The scripts run in this process (``sys.argv`` patched,
``ZARU_TPU_GUI=none``, one frame, ``--device cpu``) under ``gui.run``, as
their ``__main__`` does; only the usage errors start ``python -m``.
"""

import importlib
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port import one_torch_thread  # noqa: F401

from zaru_tpu_torch import gui

ROOT = Path(__file__).resolve().parent.parent

RUNNABLE = [
    "load_image",
    "face_detection",
    "facemesh",
    "facemarks68",
    "pose68",
    "fused_cascade",
    "eye_tracking",
    "palm_detection",
    "hand_tracking",
    "identify_stream",
]
ALL = RUNNABLE + ["animation", "eval_face_recognition", "webcam", "httpcam", "body_detection", "body_tracking"]


@pytest.fixture(autouse=True)
def headless(monkeypatch):
    """One frame, no window, and the loggers ``gui.run`` sets given back."""
    monkeypatch.setenv("ZARU_TPU_GUI", "none")
    monkeypatch.setenv("ZARU_TPU_EXAMPLE_FRAMES", "1")
    monkeypatch.setenv("ZARU_TPU_LOG", "WARNING")
    levels = {n: logging.getLogger(n).level for n in ("zaru_tpu_torch", "__main__")}
    yield
    for n, level in levels.items():
        logging.getLogger(n).setLevel(level)


def run_example(name, *args, monkeypatch):
    """Runs the example ``name`` as its ``__main__`` would; returns its exit
    code."""
    mod = importlib.import_module(f"zaru_tpu_torch.examples.{name}")
    monkeypatch.setattr(sys, "argv", [name, *args])
    try:
        gui.run(mod.main)
    except SystemExit as e:
        return e.code
    return 0


@pytest.mark.parametrize("name", RUNNABLE)
def test_example_runs(name, monkeypatch, capsys, caplog):
    code = run_example(name, "--device", "cpu", monkeypatch=monkeypatch)
    out = capsys.readouterr().out
    assert code == 0, f"{name} failed:\n{out}\n{caplog.text}"
    if name == "identify_stream":
        # The stream is the full photo, the gallery its crop: every stream
        # of every frame is identified as it.
        frames = [line for line in out.splitlines() if line.startswith("frame ")]
        assert "enroll sad_linus_cropped: ok" in out and len(frames) == 4, out
        assert all(line.count("'sad_linus_cropped'") == 2 and "<unknown>" not in line for line in frames), out


def test_animation_example(tmp_path, monkeypatch, caplog):
    from PIL import Image as PILImage

    gif = tmp_path / "t.gif"
    frames = [PILImage.new("RGB", (8, 8), c) for c in ((255, 0, 0), (0, 255, 0))]
    frames[0].save(gif, save_all=True, append_images=frames[1:], duration=10)
    monkeypatch.setenv("ZARU_TPU_GUI", "file")
    monkeypatch.setenv("ZARU_TPU_GUI_DIR", str(tmp_path / "shown"))
    assert run_example("animation", str(gif), "--device", "cpu", monkeypatch=monkeypatch) == 0, caplog.text
    shown = sorted((tmp_path / "shown" / "animation").glob("*.png"))
    assert len(shown) == 2


def test_eval_face_recognition_example(tmp_path, monkeypatch, capsys, caplog):
    """Two photos of one person: one intra-person pair through the whole
    detect → crop → embed → distance loop."""
    person = tmp_path / "linus"
    person.mkdir()
    for src in ("sad_linus.jpg", "sad_linus_cropped.jpg"):
        (person / src).write_bytes((ROOT / "assets" / "img" / src).read_bytes())
    code = run_example("eval_face_recognition", str(tmp_path), "--device", "cpu", monkeypatch=monkeypatch)
    out = capsys.readouterr().out
    assert code == 0, caplog.text
    assert "intra-person distance" in out, out


def test_usage_errors():
    env = dict(os.environ, ZARU_TPU_GUI="none", ZARU_TPU_LOG="WARNING")
    for name in ("animation", "httpcam"):
        res = subprocess.run([sys.executable, "-m", f"zaru_tpu_torch.examples.{name}"], capture_output=True,
                             text=True, timeout=120, env=env, cwd=ROOT)
        assert res.returncode == 2, (name, res.returncode, res.stderr)
        assert "usage" in res.stdout


def test_examples_raise_without_a_gpu(monkeypatch, tmp_path):
    """Without ``--device cpu`` and without a GPU every example raises
    before it loads a model, rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ALL:
        mod = importlib.import_module(f"zaru_tpu_torch.examples.{name}")
        args = {"animation": [str(tmp_path / "a.gif")], "httpcam": ["http://localhost:9/stream"],
                "eval_face_recognition": [str(tmp_path)]}.get(name, [])
        monkeypatch.setattr(sys, "argv", [name, *args])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main()


def test_frame_source_and_device_option(tmp_path, monkeypatch):
    """``--device`` (either spelling) is taken out of the arguments before
    the image path is read; a ``.npy`` path is a uint8 array; the photo
    loops ``ZARU_TPU_EXAMPLE_FRAMES`` times."""
    from zaru_tpu_torch.examples._common import example_device, frame_source, take_device

    argv = ["x", "--device", "cpu", "img.jpg"]
    assert take_device(argv) == "cpu" and argv == ["x", "img.jpg"]
    argv = ["x", "--device=cpu"]
    assert take_device(argv) == "cpu" and argv == ["x"]
    assert take_device(["x", "img.jpg"]) is None
    with pytest.raises(SystemExit):
        take_device(["x", "--device"])
    monkeypatch.setattr(sys, "argv", ["x", "--device", "cpu"])
    assert example_device() == torch.device("cpu") and sys.argv == ["x"]

    rgba = np.random.default_rng(0).integers(0, 256, (6, 5, 4), dtype=np.uint8)
    np.save(tmp_path / "frame.npy", rgba)
    monkeypatch.setenv("ZARU_TPU_EXAMPLE_FRAMES", "3")
    frames = list(frame_source("cpu", [str(tmp_path / "frame.npy"), "--device", "cpu"]))
    assert len(frames) == 3 and all(np.array_equal(f.to_numpy(), rgba) for f in frames)
    rgb = rgba[..., :3].copy()
    np.save(tmp_path / "rgb.npy", rgb)
    monkeypatch.setenv("ZARU_TPU_EXAMPLE_FRAMES", "1")
    (frame,) = frame_source("cpu", ["--device=cpu", str(tmp_path / "rgb.npy")])
    np.testing.assert_array_equal(frame.to_numpy()[..., :3], rgb)
    assert (frame.to_numpy()[..., 3] == 255).all()


def test_marker_and_rect_draw_what_cv2_draws():
    """The examples draw ``marker`` and ``rect`` with NumPy (the GPU
    machine has no OpenCV): the same pixels as ``cv2.drawMarker`` and
    ``cv2.rectangle``, on random images, positions partly or wholly
    outside them, sizes 0-9 and rectangles of either orientation."""
    import cv2

    from zaru_tpu_torch.color import Color
    from zaru_tpu_torch.image import Image
    from zaru_tpu_torch.image import draw
    from zaru_tpu_torch.rect import Rect

    rng = np.random.default_rng(0)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        base = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        color = Color(*(int(v) for v in rng.integers(0, 256, 4)))
        pos, size = rng.uniform(-10, 50, 2), int(rng.integers(0, 10))
        r = Rect.from_top_left(*rng.uniform(-20, 50, 2), *rng.uniform(-5, 40, 2))
        canvas = draw.Canvas(Image(base, "cpu"))
        draw.marker(canvas, pos, size=size, color=color)
        draw.rect(canvas, r, color=color)
        want = base.copy()
        x, y = int(round(float(pos[0]))), int(round(float(pos[1])))
        cv2.drawMarker(want, (x, y), draw._bgr(color), cv2.MARKER_CROSS, max(1, size), 1)
        tl, br = r.top_left().astype(int), (r.top_left() + r.size()).astype(int)
        cv2.rectangle(want, tuple(int(v) for v in tl), tuple(int(v) for v in br), draw._bgr(color), 1)
        np.testing.assert_array_equal(canvas.array, want)
