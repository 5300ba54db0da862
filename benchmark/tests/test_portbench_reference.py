"""The plain reference against ``zaru_tpu_torch`` on the CPU, through the
harness's own run at 3 streams of small frames: sound runs come out
correct; the control (the program's bfloat16 bodies) and a broken step
come out not correct. The chip runs the same comparison at the cells' own
sizes."""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from benchmark.harness.report import result
from benchmark.harness.spec import Cell, Spec
from zaru_tpu_torch.pipeline.face_cascade import FaceTracker

ROOT = Path(__file__).resolve().parents[2]
# Every traffic mix with its configurations. The serve mixes are no cells of
# BENCHMARK.json (their chip runs spread too far); their files stay for the
# cells a later benchmark change brings back.
CELLS = ["face_v1.track_b512", "face_v2.track_b512", "face_v1.serve_b64", "face_v1.serve_b1"]
SEED = 2**31 + 17


def cell_of(name: str, per_layer=()) -> Cell:
    """A cell from its configuration, traffic mix and limits files."""
    spec = Spec()
    config, traffic = name.split(".")
    return Cell(name, spec.config(config), spec.traffic(traffic), 1, spec.data["end_to_end"], list(per_layer),
                spec.limits(name))


def small(cell):
    """The cell's traffic at 3 streams (1 for one stream) of 480×270 frames,
    a detect period of 3 steps, 3 kept steps besides the first two."""
    t = dict(cell.traffic, streams=min(3, cell.traffic["streams"]), width=480, height=270, check_steps=3)
    if t["loop"] == "track":
        t.update(detect_every=3, profile={"from": 3, "steps": 3})
    return t


def run(name, seconds=0.3, traced=False, compute_dtype=None, per_layer=()):
    cell = cell_of(name, per_layer)
    out, _ = result(cell, ROOT, SEED, seconds, traced, time.perf_counter(), "cpu", compute_dtype, small(cell))
    return out


@pytest.mark.parametrize("name", CELLS)
def test_reference_holds_the_program(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["streams_lost_after_first_step"] == 0
    assert out["checks"]["landmarks_px"]["value"] <= 1e-4
    assert set(out["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert list(out)[-1] == "checks"


def test_traced_run_reads_the_program_counters():
    out = run("face_v1.serve_b64", traced=True, per_layer=[{"name": "ingest_host_ms", "unit": "ms"}])
    assert out["correct"] and set(out["metrics"]) == {"ingest_host_ms"}


@pytest.mark.parametrize("name", ["face_v1.track_b512", "face_v1.serve_b1"])
def test_control_in_bfloat16_is_not_correct(name):
    out = run(name, compute_dtype=torch.bfloat16)
    assert not out["correct"]
    assert out["checks"]["landmarks_px"]["value"] > out["checks"]["landmarks_px"]["limit"]


def _state_unchanged(step):
    def broken(self, state, frames, *args, **kw):
        _, out = step(self, state, frames, *args, **kw)
        return state, out
    return broken


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _half_batch(step):
    """The step run on the first half of the streams; the other half gets
    copies of its results."""
    def broken(self, state, frames, *args, **kw):
        n, h = frames.shape[0], (frames.shape[0] + 1) // 2
        new, out = step(self, _tree(lambda v: v[:h], state), frames[:h], *args, **kw)
        grow = lambda v: torch.cat([v, v[: n - h]])  # noqa: E731
        return _tree(grow, new), _tree(grow, out)
    return broken


def _answer_altered(step):
    def broken(self, state, frames, *args, **kw):
        new, out = step(self, state, frames, *args, **kw)
        lm = out["landmarks"].clone()
        lm[..., 0, 0] += 5.0  # one landmark of each stream five pixels off
        return new, dict(out, landmarks=lm)
    return broken


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch, "answer_altered": _answer_altered}


@pytest.mark.parametrize("name, fault", [(c, f) for c in CELLS[:3] for f in FAULTS]
                         + [("face_v1.serve_b1", "state_unchanged"), ("face_v1.serve_b1", "answer_altered")])
def test_broken_step_is_not_correct(name, fault, monkeypatch):
    entry = "step" if cell_of(name).traffic.get("single") else "step_batch"
    monkeypatch.setattr(FaceTracker, entry, FAULTS[fault](getattr(FaceTracker, entry)))
    out = run(name)
    assert not out["correct"], out["checks"]
