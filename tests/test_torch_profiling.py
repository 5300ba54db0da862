"""The port's spans and counters (``zaru_tpu_torch/profiling.py``) on the
tracker step, on the CPU at batch 2 on the fixture photo.

- Under a profiler, one step writes each span of the step path into the
  trace, nested under ``zaru.step``; a span that waits for its work
  before it exits covers that work's interval, on one clock.
- With no profiler running, a span is a shared no-op that enters no
  ``record_function``.
- ``host_syncs`` counts the sites of the main path: the gate's read on a
  step that is not forced, the letterbox fit's copy on a detect step (a
  forced step reads no gate); after warm-up a step copies no host value to
  the device and builds no kernel.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

from zaru_tpu_torch import profiling  # noqa: E402

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "zaru_tpu_torch", "fixtures", "sad_linus_track.npz",
)
STEP_SPANS = (
    "zaru.sync.gate", "zaru.sync.frame_fit", "zaru.detect", "zaru.detect.sample", "zaru.detect.net",
    "zaru.detect.tail", "zaru.track.sample", "zaru.track.net", "zaru.track.tail",
)
# Host syncs of the main path a step (PERF.md §3): the gate on a step that
# is not forced, the letterbox fit's copy on a detect step.
SYNCS_TRACKING, SYNCS_FORCED, SYNCS_LOST = 1, 1, 2


@pytest.fixture(scope="module")
def tracker():
    from zaru_tpu_torch.pipeline import FaceTracker

    return FaceTracker(device="cpu")


@pytest.fixture(scope="module")
def frames():
    with np.load(FIXTURE) as f:
        rgb = f["rgb"]
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return torch.from_numpy(np.stack([rgba] * 2))


@pytest.fixture(scope="module")
def tracked(tracker, frames):
    """A state that tracks both streams, after a detect step."""
    state, out = tracker.step_batch(tracker.init_state(2), frames, True)
    assert bool(out["valid"].all())
    return state


def _annotations(log_dir):
    (path,) = log_dir.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_one_step_traces_each_span_under_the_step(tmp_path, tracker, frames):
    """A step from a fresh state reads the gate, detects and tracks: every
    span of the step path is in the trace, inside the one ``zaru.step``,
    the detect branch's parts inside ``zaru.detect``."""
    profiling.reset()
    with profiling.trace(tmp_path):
        tracker.step_batch(tracker.init_state(2), frames)
    spans = _annotations(tmp_path)
    (step,) = [e for e in spans if e["name"] == "zaru.step"]
    by_name = {e["name"]: e for e in spans if e["name"].startswith("zaru.")}
    assert set(STEP_SPANS) <= set(by_name)
    for e in spans:
        if e["name"].startswith("zaru.") and e is not step:
            assert _inside(e, step), e["name"]
    for part in ("sample", "net", "tail"):
        assert _inside(by_name[f"zaru.detect.{part}"], by_name["zaru.detect"])
    assert profiling.counters["steps"] == 1 and profiling.counters["detect_steps"] == 1


def test_span_covers_the_work_issued_inside_it(tmp_path):
    """A span that waits for its work before it exits covers that work's
    interval in the trace: the host's ranges and the work lie on one clock
    (on a CUDA device the kernel's interval, here the CPU op's)."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    x = torch.ones(256, 256, device=dev)
    with profiling.trace(tmp_path):
        with profiling.span("zaru.test"):
            y = x @ x
            if dev == "cuda":
                torch.cuda.synchronize()
    (path,) = tmp_path.glob("*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    (outer,) = [e for e in events if e["name"] == "zaru.test" and e.get("cat") == "user_annotation"]
    work = [e for e in events if e.get("cat") == ("kernel" if dev == "cuda" else "cpu_op")
            and (dev == "cuda" or e["name"] == "aten::mm")]
    assert work and all(_inside(e, outer) for e in work)
    assert float(y[0, 0]) == 256.0


def test_no_profiler_no_record_function(monkeypatch, tracker, frames, tracked):
    """With no profiler running, a span is one shared no-op and a whole step
    enters no ``record_function``."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("zaru.a") is profiling.span("zaru.b")
    with profiling.span("zaru.a"):
        pass
    tracker.step_batch(tracked, frames)
    tracker.step_batch(tracked, frames, True)


def _counted(step):
    before = dict(profiling.counters)
    step()
    return {k: v - before[k] for k, v in profiling.counters.items()}


def test_host_syncs_count_the_gate_and_the_detect_sites(tracker, frames, tracked):
    """An unforced tracking step syncs once (the gate); a forced step only
    at the letterbox fit, reading no gate; a step with a lost stream at
    both. Each is one step, and only the detect steps count as such."""
    tracking = _counted(lambda: tracker.step_batch(tracked, frames))
    assert tracking == {"steps": 1, "detect_steps": 0, "host_syncs": SYNCS_TRACKING, "host_copies": 0,
                        "kernel_builds": 0, "bottleneck_blocks": 0, "blaze_blocks": 6, "entry_blocks": 0,
                        "eye_crops": 0, "launches.blaze_stage": 0, "launches.blaze_stage_nhwc": 0,
                        "launches.bottleneck_stage": 0, "launches.blaze_block": 0, "launches.entry_block": 0,
                        "launches.letterbox_sample": 0, "launches.rotated_sample": 0, "launches.rgb_to_yuv": 0}
    forced = _counted(lambda: tracker.step_batch(tracked, frames, True))
    assert forced["host_syncs"] == SYNCS_FORCED and forced["detect_steps"] == 1
    assert forced["blaze_blocks"] == 11 + 6  # BlazeFace, then Face Mesh V1
    lost = _counted(lambda: tracker.step_batch(tracker.init_state(2), frames))
    assert lost["host_syncs"] == SYNCS_LOST and lost["detect_steps"] == 1
    profiling.reset()
    assert not any(profiling.counters.values())


def test_nothing_copied_or_built_after_warm_up(tracker, frames, tracked):
    """After the warm-up steps of both branches, neither branch copies a
    host value to the device nor builds a kernel."""
    for force in (True, False):
        ran = _counted(lambda: tracker.step_batch(tracked, frames, force))
        assert ran["host_copies"] == 0 and ran["kernel_builds"] == 0


def test_build_all_counts_each_source_it_builds(tmp_path, monkeypatch):
    """``build_all`` counts each library it builds, inside the span
    ``zaru.build.kernels``, and builds nothing when every library is
    current. A shell stands in for ``nvcc``."""
    from zaru_tpu_torch.ops import _build

    sources = {name: tmp_path / f"{name}.cu" for name in ("a", "b")}
    monkeypatch.setattr(_build, "SOURCES", sources)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "_target", lambda name: tmp_path / "out" / f"{name}.so")
    monkeypatch.setattr(_build, "_nvcc", lambda: "/bin/sh")
    monkeypatch.setattr(_build, "flags", lambda name: ["-c", 'touch "$2"', "sh"])
    built = _counted(lambda: _build.build_all())
    assert built["kernel_builds"] == 2 and (tmp_path / "out" / "a.so").exists()
    with profiling.trace(tmp_path / "prof"):
        assert _counted(lambda: _build.build_all())["kernel_builds"] == 0
    assert not [e for e in _annotations(tmp_path / "prof") if e["name"] == "zaru.build.kernels"]
