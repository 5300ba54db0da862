"""What a configuration and a traffic mix may carry as data, with no edit to
the harness: the tracker's options (``program.options``), further networks
counted in the work (``networks``), further compared numbers (``eyes_px``),
face-free streams (``empty_share``, ``empty_crop``); and the span readers'
pairing of launch calls with device work by correlation id."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark.harness import bottlenecks, check, frames, program, readings, spans, trace
from benchmark.harness.cell import Session
from benchmark.harness.loops import Window
from benchmark.harness.spec import Spec
from benchmark.reference.cascade import Cascade
from benchmark.work import networks

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MODELS = ROOT / "assets" / "onnx"
H100 = "NVIDIA H100 80GB HBM3"
IRIS = {"name": "iris", "file": "iris_landmark.onnx", "crops": 2, "steps": "every"}


def _iris_spec(root: Path) -> Spec:
    """A copy of the benchmark with an iris configuration, a limits file
    naming ``eyes_px`` and a cell, written as new files and new entries."""
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "face_v1.json").read_text())
    cfg = dict(cfg, name="face_v1_iris", program=dict(cfg["program"], options={"iris": True}), networks=[IRIS])
    (root / "benchmark" / "configs" / "face_v1_iris.json").write_text(json.dumps(cfg))
    limits = json.loads((BENCH / "limits" / "face_v1.track_b512.json").read_text())
    limits["eyes_px"] = {"limit": 0.5, "lower": 0.0, "upper": 5.0}
    (root / "benchmark" / "limits" / "face_v1_iris.track_b512.json").write_text(json.dumps(limits))
    data["configs"].append({"name": "face_v1_iris", "source": "https://arxiv.org/abs/2006.11341", "reduced": [],
                            "why": "x", "file": "benchmark/configs/face_v1_iris.json"})
    data["workloads"].append({"name": "face_v1_iris.track_b512", "config": "face_v1_iris",
                              "traffic": "track_b512", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return Spec(root, root / "benchmark")


def _run(config, profiled, span=None):
    return readings.Run(config, Window(1.0, [0.01], 0, 0, profiled, {}), span, H100, MODELS)


def _steps(detects):
    tracked = torch.ones(512, dtype=torch.bool)
    return [(512, tracked, d) for d in detects]


# --- tracker options -----------------------------------------------------

def test_program_options_reach_the_tracker(tmp_path):
    spec = _iris_spec(tmp_path)
    tracker = program.build(spec.cell("face_v1_iris.track_b512").config, torch.device("cpu"))
    assert tracker.iris and tracker.eye_cnn is not None
    assert not program.build(Spec().config("face_v1"), torch.device("cpu")).iris


# --- further networks ----------------------------------------------------

def test_the_published_networks_keep_their_counts():
    assert networks.flops(MODELS / "face_detection_short_range.onnx") == 63_533_952
    assert networks.flops(MODELS / "face_landmark.onnx") == 72_995_005
    assert networks.flops(MODELS / "face_landmarks_detector.onnx") == 236_374_173


@pytest.mark.parametrize("config, landmarker", [("face_v1", "face_landmark.onnx"),
                                                ("face_v2", "face_landmarks_detector.onnx")])
def test_configurations_without_further_networks_count_as_before(config, landmarker):
    """The counts of a configuration that lists no further network, to the
    operation: the landmark network every step, the detector on detect
    steps, as the harness counted them before it took further networks."""
    steps = _steps([True] + [False] * 8 + [True] * 3)
    run = _run(Spec().config(config), steps)
    lm_file, det_file = str(MODELS / landmarker), str(MODELS / "face_detection_short_range.onnx")
    lm, det = networks.flops(lm_file), networks.flops(det_file)
    assert readings.network_flops(run) == sum(n * (lm + (det if d else 0)) for n, _, d in steps)

    def stage(path):  # a loop, as the harness sums (Python's sum() of floats compensates)
        p, total = run.peaks, 0.0
        for c, h, w, b in networks.stage_chains(path):
            total += max(b * networks.block_ops(c, h, w) / p["f32_flops"], 2 * 4 * c * h * w / p["bytes_per_s"])
        return total

    def chains(path):
        p = run.peaks
        return sum(max(n * bottlenecks.block_ops(c, h, w) / p["f32_flops"], 2 * 4 * c * h * w / p["bytes_per_s"])
                   for c, h, w, n in bottlenecks.chains(path))

    for got, per_frame in ((readings.stage_bound_seconds(run), stage), (bottlenecks.bound_seconds(run), chains)):
        lm_s, det_s = per_frame(lm_file), per_frame(det_file)
        assert got == sum(n * (lm_s + (det_s if d else 0.0)) for n, _, d in steps)


def test_a_further_network_is_counted_for_its_crops_and_steps():
    cfg = dict(Spec().config("face_v1"), networks=[IRIS])
    lm, det, iris = (networks.flops(MODELS / f) for f in
                     ("face_landmark.onnx", "face_detection_short_range.onnx", "iris_landmark.onnx"))
    run = _run(cfg, _steps([True, False, False]))
    assert readings.network_flops(run) == 512 * (3 * (lm + 2 * iris) + det)
    assert bottlenecks.bound_seconds(run) == pytest.approx(
        3 * 512 * 2 * bottlenecks.bound_seconds(_run(dict(cfg, landmarker={"file": "iris_landmark.onnx"},
                                                           networks=[]), _steps([False]))) / 512)
    on_detect = dict(cfg, networks=[dict(IRIS, steps="detect")])
    assert readings.network_flops(_run(on_detect, _steps([True, False]))) == 512 * (2 * lm + det + 2 * iris)
    with pytest.raises(ValueError, match="steps"):
        readings.network_flops(_run(dict(cfg, networks=[dict(IRIS, steps="sometimes")]), _steps([True])))


# --- further compared numbers --------------------------------------------

class _Stub:
    """A reference that returns the program's own outputs and state, and
    ``eyes`` off by ``gap`` pixels, where it is given eyes at all."""

    def __init__(self, record, gap=None):
        self.record, self.gap = record, gap

    def step(self, state, frames, detect, exact):
        out = dict(self.record["out"])
        if self.gap is None:
            out.pop("eyes", None)
        else:
            out["eyes"] = out["eyes"] + self.gap
        return self.record["state_out"], out


def _record(eyes=True):
    n = 4
    out = {"landmarks": torch.rand(n, 468, 3), "confidence": torch.rand(n), "roi": torch.rand(n, 5),
           "valid": torch.ones(n, dtype=torch.bool)}
    if eyes:
        out["eyes"] = torch.rand(n, 2, 76, 3)
    state = {"roi": out["roi"], "tracking": out["valid"],
             "filter": {"x": torch.rand(n, 468, 3), "dx": torch.rand(n, 468, 3),
                        "init": torch.ones(n, 468, 3, dtype=torch.bool)}}
    return {"state_in": state, "out": out, "state_out": state, "detect": False}


def _compare(reference, rec):
    return check.compare(reference, [(0, rec)], lambda a, b: None, exact=False, single=False, rows=8,
                         device=torch.device("cpu"))


def test_eyes_are_compared_where_both_sides_give_them():
    rec = _record()
    numbers = _compare(_Stub(rec, gap=0.25), rec)
    assert numbers["eyes_px"] == pytest.approx(0.25)
    assert {k: numbers[k] for k in ("landmarks_px", "roi_px", "confidence", "filter_dx", "flags")} == \
        dict.fromkeys(("landmarks_px", "roi_px", "confidence", "filter_dx", "flags"), 0.0)
    # The reference gives no eyes, or the program none: no eyes_px.
    assert "eyes_px" not in _compare(_Stub(rec), rec)
    plain = _record(eyes=False)
    assert list(_compare(_Stub(plain), plain)) == ["landmarks_px", "roi_px", "confidence", "filter_dx", "flags"]


def test_limits_naming_a_number_the_outputs_cannot_give_are_an_error():
    plain = _record(eyes=False)
    numbers = _compare(_Stub(plain), plain)
    limits = {"landmarks_px": {"limit": 0.74}, "eyes_px": {"limit": 0.5}}
    with pytest.raises(KeyError, match="eyes_px"):
        check.judge(numbers, limits)
    assert check.judge(numbers, {"landmarks_px": {"limit": 0.74}}) == (
        True, {"landmarks_px": {"value": 0.0, "limit": 0.74}})


class _WithEyes(Cascade):
    """The plain reference with eyes where the program put them, moved by
    a quarter pixel: no iris reference exists yet."""

    def __init__(self, *args, eyes, **kw):
        super().__init__(*args, **kw)
        self.eyes = eyes

    def step(self, state, frames, detect, exact=False):
        r_state, r_out = super().step(state, frames, detect, exact)
        return r_state, dict(r_out, eyes=self.eyes.pop(0) + 0.25)


def test_an_iris_configuration_is_built_counted_and_compared_as_data(tmp_path):
    """A configuration with ``program.options {"iris": true}``, the iris
    network listed as two crops a stream every step, and a limits file
    naming ``eyes_px``: built, counted and compared by the harness as it
    stands (a small window on the CPU)."""
    harness = {p.name: p.read_bytes() for p in (BENCH / "harness").glob("*.py")}
    spec = _iris_spec(tmp_path)
    cell = spec.cell("face_v1_iris.track_b512")
    small = dict(cell.traffic, streams=2, width=480, height=270, check_steps=1)
    session = Session(cell, tmp_path, "cpu", traffic=small)
    assert session.program.iris

    kept = []
    reference = _WithEyes(cell.config, MODELS, "cpu", eyes=kept)
    orig_compare = check.compare

    def compare(ref, steps, *a, **kw):
        kept.extend(rec["out"]["eyes"] for _, rec in steps)
        return orig_compare(ref, steps, *a, **kw)

    check.compare = compare
    try:
        outcome = session.run(11, 0.2, False, 0.0, reference=reference)
    finally:
        check.compare = orig_compare
    assert not kept
    assert outcome.numbers["eyes_px"] == pytest.approx(0.25, abs=1e-3)
    assert outcome.numbers["landmarks_px"] == 0.0
    correct, checks = check.judge(outcome.numbers, cell.limits)
    assert correct and checks["eyes_px"] == {"value": outcome.numbers["eyes_px"], "limit": 0.5}
    lm, det, iris = (networks.flops(MODELS / f) for f in
                     ("face_landmark.onnx", "face_detection_short_range.onnx", "iris_landmark.onnx"))
    run = _run(cell.config, _steps([True, False]))
    assert readings.network_flops(run) == 512 * (2 * (lm + 2 * iris) + det)
    assert {p.name: p.read_bytes() for p in (BENCH / "harness").glob("*.py")} == harness


# --- face-free streams ---------------------------------------------------

def _traffic(**kw):
    t = dict(Spec().traffic("track_b512"), streams=8, width=192, height=108)
    t.update(kw)
    return t


def test_without_empty_share_the_frames_are_the_bench_frames():
    t = _traffic()
    made = frames.traffic_frames(t, 4294967311, "cpu", {})
    params = frames.stream_params(4294967311, 8, t["transform"])
    assert torch.equal(made, frames.stream_frames(frames.bench_frame(), params, 192, 108, "cpu"))


def test_empty_streams_are_drawn_from_the_seed():
    crop = Spec().traffic("empty_b512")["empty_crop"]
    t = _traffic(empty_share=0.25, empty_crop=crop)
    a = frames.traffic_frames(t, 2**31 + 7, "cpu", {})
    assert torch.equal(a, frames.traffic_frames(t, 2**31 + 7, "cpu", {}))
    empty = frames.empty_streams(2**31 + 7, 8, 0.25)
    assert len(empty) == 2 and list(empty) == sorted(set(empty))
    assert list(empty) != list(frames.empty_streams(2**31 + 8, 8, 0.25)) or \
        list(empty) != list(frames.empty_streams(2**31 + 9, 8, 0.25))
    # The other streams are the bench frame's, as without the key; the
    # empty ones the crop's under their own transforms.
    plain = frames.traffic_frames(_traffic(), 2**31 + 7, "cpu", {})
    faces = [i for i in range(8) if i not in set(empty)]
    assert torch.equal(a[faces], plain[faces])
    params = frames.stream_params(2**31 + 7, 8, t["transform"])
    alone = frames.stream_frames(frames.bench_frame(crop), params[empty], 192, 108, "cpu")
    assert torch.equal(a[list(empty)], alone)
    assert len(frames.empty_streams(1, 512, 0.25)) == 128


def test_the_reference_detector_finds_no_face_on_the_empty_streams():
    traffic = Spec().traffic("empty_b512")
    t = _traffic(streams=16, width=384, height=216, empty_share=1.0, empty_crop=traffic["empty_crop"])
    ref = Cascade(Spec().config("face_v1"), MODELS, "cpu")
    for seed in (3, 2**31 + 11):
        _rois, found = ref.detect(frames.traffic_frames(t, seed, "cpu", {}), exact=False)
        assert not found.any()
    # The bench frame's faces are found at the same size.
    _rois, found = ref.detect(frames.traffic_frames(_traffic(width=384, height=216), 3, "cpu", {}), exact=False)
    assert found.all()


# --- launch calls paired with device work by correlation id ---------------

def _events(lost=0, ids=True):
    """A Chrome trace of two steps, in µs: each a span ``zaru.detect`` with
    three launches and a span ``zaru.track.net`` with two. ``lost``: the
    device records of the first launches that the profiler lost."""
    ev = [{"ph": "X", "name": trace.MARK, "cat": "user_annotation", "ts": 0.0, "dur": 0.0},
          {"ph": "X", "name": trace.MARK, "cat": "user_annotation", "ts": 10000.0, "dur": 0.0}]
    corr, t_dev = 100, 50.0
    for step in range(2):
        t0 = 5000.0 * step + 10.0
        for name, a, b, n in (("zaru.detect", 0.0, 1000.0, 3), ("zaru.track.net", 1000.0, 2000.0, 2)):
            ev.append({"ph": "X", "name": name, "cat": "user_annotation", "ts": t0 + a, "dur": b - a})
            for j in range(n):
                corr += 1
                ts = t0 + a + 100.0 * (j + 1)
                args = {"correlation": corr} if ids else {}
                ev.append({"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": ts, "dur": 5.0,
                           "args": args})
                dur = 200.0 + 10.0 * j
                t_dev = max(t_dev, ts + 20.0)
                if corr - 100 > lost:
                    ev.append({"ph": "X", "name": f"k{corr}", "cat": "kernel", "ts": t_dev, "dur": dur, "args": args})
                t_dev += dur
    return ev


def _read(events, name):
    run = _run(Spec().config("face_v1"), _steps([True, True]), trace.parse(events))
    return spans.device_ms(run, name)


def _by_order(events, name):
    """The pairing the readers used before the ids: the n-th launch call
    with the n-th device interval, only where the counts agree."""
    span = trace.parse(events)
    calls = sorted((iv for iv in span.host if iv.kind == "cuda_runtime"), key=lambda iv: iv.start)
    work = sorted(span.device, key=lambda iv: iv.start)
    if len(calls) != len(work):
        return None
    ann = [iv for iv in span.host if iv.name == name]
    return sum(w.seconds for s in ann for c, w in zip(calls, work) if s.start <= c.start <= s.end) / len(ann) * 1e3


def test_spans_pair_by_correlation_id_as_order_did_where_order_held():
    for name, per in (("zaru.detect", 200 + 210 + 220), ("zaru.track.net", 200 + 210)):
        assert _read(_events(), name) == pytest.approx(per * 1e-3)
        assert _read(_events(), name) == pytest.approx(_by_order(_events(), name), abs=1e-12)
    # The ids are kept from the trace's args; a trace without them is not read.
    span = trace.parse(_events())
    assert {iv.correlation for iv in span.device} == {iv.correlation for iv in span.host if iv.kind == "cuda_runtime"}
    assert _read(_events(ids=False), "zaru.detect") is None


def test_records_lost_at_the_spans_start_leave_the_other_spans_read():
    """The profiler lost the first two device records: in order they no
    longer pair (None); by id the first step's detect span is left out and
    the rest are read."""
    assert _by_order(_events(lost=2), "zaru.detect") is None
    assert _read(_events(lost=2), "zaru.detect") == pytest.approx((200 + 210 + 220) * 1e-3)
    assert _read(_events(lost=2), "zaru.track.net") == pytest.approx((200 + 210) * 1e-3)
    pairs = spans.launched(trace.parse(_events(lost=2)))
    assert [w is None for _, w in pairs] == [True, True] + [False] * 8
    # Every detect span lost a record: nothing to read, never 0.
    assert _read(_events(lost=7), "zaru.detect") is None
