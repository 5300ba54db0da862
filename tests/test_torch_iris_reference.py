"""The port's iris branch (``FaceTracker(iris=True)``) against the
benchmark's plain iris reference (``benchmark/reference/face_iris.py``), on
the CPU at 3 streams of the fixture photo, with seeded random weights of
the iris file's shapes in both: the eyes of ``step_batch``, its eye crops
bit for bit, the three ``zaru.iris.*`` spans and the ``eye_crops``
counter."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from torch_port import one_torch_thread  # noqa: E402,F401

from benchmark.reference import face_iris  # noqa: E402
from benchmark.reference.graph import Graph  # noqa: E402
from zaru_tpu_torch import profiling  # noqa: E402
from zaru_tpu_torch.pipeline import FaceTracker  # noqa: E402

MODELS = ROOT / "assets" / "onnx"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "face_v1_iris.json").read_text())
FIXTURE = ROOT / "zaru_tpu_torch" / "fixtures" / "sad_linus_track.npz"
IRIS_SPANS = ("zaru.iris.sample", "zaru.iris.net", "zaru.iris.tail")
# Both sides run the same float32 torch ops on the CPU (the executor's
# per-op graph, the reference's graph runner) on the same crops, so the
# eyes agree to rounding; 1e-4 px is a few ulps of image coordinates.
EYES_ATOL_PX = 1e-4


def _random_weights(seed: int) -> dict:
    """Seeded weights of the iris file's shapes, scaled so activations stay
    of order 1 (between 0.3 and 2.2 a value at every Add on crops in [-1,
    1]): convolutions ``N(0, 1/fan_in)``, halved on the convolution that
    closes a residual branch, biases ``N(0, 0.1²)``, PRelu slopes in [0.1,
    0.3)."""
    graph = Graph(MODELS / face_iris.network_file(CONFIG, "iris"))
    slopes = {n.inputs[1] for n in graph.nodes if n.op_type == "PRelu"}
    added = {name for n in graph.nodes if n.op_type == "Add" for name in n.inputs}
    closing = {n.inputs[1] for n in graph.nodes if n.op_type == "Conv" and n.outputs[0] in added}
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, w in graph.weights.items():
        if name in slopes:
            v = 0.1 + 0.2 * torch.rand(w.shape, generator=gen)
        elif w.ndim == 4:
            v = torch.randn(w.shape, generator=gen) / float(np.sqrt(w[0].numel())) * (0.5 if name in closing else 1.0)
        else:
            v = 0.1 * torch.randn(w.shape, generator=gen)
        out[name] = v
    return out


def _initializers(file: str) -> dict:
    return {k: v.numpy() for k, v in Graph(MODELS / file).weights.items()}


@pytest.fixture(scope="module")
def eye_weights():
    return _random_weights(23)


@pytest.fixture(scope="module")
def tracker(eye_weights):
    params = {"det": _initializers(CONFIG["detector"]["file"]), "lm": _initializers(CONFIG["landmarker"]["file"]),
              "eye": {k: v.numpy() for k, v in eye_weights.items()}}
    return FaceTracker(device="cpu", iris=True, params=params)


@pytest.fixture(scope="module")
def reference(eye_weights):
    ref = face_iris.Cascade(CONFIG, MODELS, "cpu")
    ref.eye_net.weights = dict(eye_weights)
    return ref


@pytest.fixture(scope="module")
def frames():
    """Three streams: the photo, and the photo shifted by (24, 16) and
    (-40, 8) pixels."""
    with np.load(FIXTURE) as f:
        rgb = f["rgb"]
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return torch.from_numpy(np.stack([rgba, np.roll(rgba, (16, 24), (0, 1)), np.roll(rgba, (8, -40), (0, 1))]))


@pytest.fixture(scope="module")
def steps(tracker, frames):
    """Two port steps, the first a forced detect step: ``[(state in,
    frames, detect, state out, outputs), ...]``; the second step's frames
    moved by a pixel, so the filter moves."""
    state, out = tracker.step_batch(tracker.init_state(3), frames, True)
    moved = torch.roll(frames, (1, 1), (1, 2))
    state2, out2 = tracker.step_batch(state, moved)
    assert bool(out["valid"].all()) and bool(out2["valid"].all())
    return [(tracker.init_state(3), frames, True, state, out), (state, moved, False, state2, out2)]


def test_eyes_equal_the_reference(reference, steps):
    """Each step from the port's state in: the reference's landmarks equal
    the port's, and its eyes within ``EYES_ATOL_PX``."""
    for state_in, frames, detect, _state_out, out in steps:
        _r_state, r_out = reference.step(state_in, frames, detect)
        assert torch.equal(r_out["landmarks"], out["landmarks"])
        assert r_out["eyes"].shape == out["eyes"].shape == (3, 2, 76, 3)
        assert float(out["eyes"].abs().max()) > 100.0  # in image pixels, not the crop's
        torch.testing.assert_close(out["eyes"], r_out["eyes"], rtol=0.0, atol=EYES_ATOL_PX)


@pytest.mark.parametrize("exact", [False, True], ids=["prescaled", "exact"])
def test_eye_crops_equal_the_reference_bit_for_bit(tracker, reference, steps, exact):
    """The eye rects from the port's landmarks, and the crops of both eyes
    (the right eye mirrored), through the prescale grid and the exact
    sampler."""
    _, frames, _, _, out = steps[1]
    rects = tracker._eye_view_rects(out["landmarks"])
    assert torch.equal(rects, reference.eye_rects(out["landmarks"]))
    crops = tracker._eye_samples(frames, rects, exact)
    r_crops = reference.eye_crops(frames, rects, exact)
    assert crops.shape == r_crops.shape == (3, 2, 3, 64, 64)
    assert torch.equal(crops, r_crops)
    assert not torch.equal(r_crops[:, 1], r_crops[:, 1].flip(-1))  # the mirror is seen


def _annotations(log_dir):
    (path,) = log_dir.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_iris_spans_open_once_a_step_inside_it(tmp_path, tracker, steps):
    """One tracking step under the profiler: each ``zaru.iris.*`` span once,
    inside the step's ``zaru.step``, in the order sample, net, tail, with the
    flips' sync inside the tail."""
    state_in, frames, *_ = steps[1]
    with profiling.trace(tmp_path):
        tracker.step_batch(state_in, frames)
    spans = _annotations(tmp_path)
    (step,) = [e for e in spans if e["name"] == "zaru.step"]
    found = [e for e in spans if e["name"] in IRIS_SPANS]
    assert sorted(e["name"] for e in found) == sorted(IRIS_SPANS)
    assert [e["name"] for e in sorted(found, key=lambda e: e["ts"])] == list(IRIS_SPANS)
    inside = lambda a, b: b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]  # noqa: E731
    assert all(inside(e, step) for e in found)
    (flip,) = [e for e in spans if e["name"] == "zaru.sync.iris_flip"]
    assert inside(flip, found[[e["name"] for e in found].index("zaru.iris.tail")])


def test_eye_crops_count_two_a_stream_a_step(tracker, steps):
    state_in, frames, *_ = steps[1]
    before = profiling.counters["eye_crops"]
    state, _ = tracker.step_batch(state_in, frames)
    tracker.step_batch(state, frames, True)
    assert profiling.counters["eye_crops"] - before == 2 * 2 * 3


if __name__ == "__main__":
    sys.exit(pytest.main([os.path.abspath(__file__), "-q"]))
