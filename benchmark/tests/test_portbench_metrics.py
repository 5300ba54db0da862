"""The benchmark's arithmetic on fixed inputs: the end-to-end statistics,
the trace reduction, the work counts and each per-layer reader."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from benchmark.harness import readings, trace
from benchmark.harness.cell import p95_ms, rate
from benchmark.harness.loops import Kept, Window
from benchmark.harness.report import breakdown
from benchmark.harness.spec import Spec
from benchmark.work import networks

ROOT = Path(__file__).resolve().parents[2]
MODELS = ROOT / "assets" / "onnx"
H100 = "NVIDIA H100 80GB HBM3"


def test_p95_and_rate_over_a_window_move_with_one_stalled_step():
    steady = [0.010] * 199
    stalled = steady[:100] + [0.250] + steady[100:]
    assert p95_ms(steady) == pytest.approx(10.0)
    assert rate(512 * 199, sum(steady)) == pytest.approx(51200.0)
    # One stall in 200 steps lies beyond the 95th percentile by itself, but
    # the rate, taken over all the time, falls with it.
    assert p95_ms(stalled) == pytest.approx(10.0)
    assert rate(512 * 200, sum(stalled)) < 0.9 * rate(512 * 199, sum(steady))
    # Eleven stalls in 200 steps move the percentile too.
    many = [0.010] * 189 + [0.250] * 11
    assert p95_ms(many) > 100.0


def test_idle_share_from_kernel_intervals():
    device = [trace.Interval("a", 0.0, 2.0, "kernel"), trace.Interval("b", 1.0, 3.0, "kernel"),
              trace.Interval("c", 5.0, 6.0, "copy"), trace.Interval("d", 9.0, 9.5, "kernel")]
    assert trace.union_seconds(device) == pytest.approx(4.5)
    assert trace.gaps(device, 10.0) == [(3.0, 5.0), (6.0, 9.0), (9.5, 10.0)]
    run = _run(trace.Span(10.0, device), [(512, torch.ones(512, dtype=torch.bool), False)])
    assert readings.idle_share(run) == pytest.approx(55.0)
    assert readings.idle_share(_run(trace.Span(10.0, []), [])) is None


def test_trace_events_reduce_to_the_marked_span():
    events = [
        {"ph": "X", "name": trace.MARK, "cat": "user_annotation", "ts": 100.0, "dur": 0.0},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 90.0, "dur": 20.0},
        {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 150.0, "dur": 10.0},
        {"ph": "X", "name": "aten::item", "cat": "cpu_op", "ts": 170.0, "dur": 20.0},
        {"ph": "X", "name": "k2", "cat": "kernel", "ts": 195.0, "dur": 30.0},
        {"ph": "X", "name": trace.MARK, "cat": "user_annotation", "ts": 200.0, "dur": 0.0},
        {"ph": "i", "name": "flow", "ts": 120.0},
    ]
    span = trace.parse(events)
    assert span.seconds == pytest.approx(100e-6)
    assert [(iv.name, iv.kind) for iv in span.device] == [("k1", "kernel"), ("Memcpy HtoD", "copy"), ("k2", "kernel")]
    assert [iv.seconds for iv in span.device] == pytest.approx([10e-6, 10e-6, 5e-6])
    b = breakdown(span)
    assert b["device_ops"][0][0] == "k1" and b["device_ops"][0][1] == pytest.approx(10e-6)
    assert b["idle_gaps"] == [["host: Python between traced ops", pytest.approx(40e-6)],
                              ["host: aten::item", pytest.approx(35e-6)]]


@pytest.mark.parametrize("file, gflop", [("face_detection_short_range.onnx", 0.064),
                                         ("face_landmark.onnx", 0.073),
                                         ("face_landmarks_detector.onnx", 0.236)])
def test_network_flops_are_the_ports_count(file, gflop):
    from zaru_tpu_torch.nn import NeuralNetwork
    from zaru_tpu_torch.onnx.analysis import analyze

    ours = networks.flops(MODELS / file)
    assert round(ours / 1e9, 3) == gflop
    assert ours == analyze(NeuralNetwork.load(MODELS / file, device="cpu")).flops


def test_stage_chains_bound_the_ten_chains_at_512():
    ops = sum(blocks * networks.block_ops(c, h, w) * 512
              for f in ("face_detection_short_range.onnx", "face_landmark.onnx")
              for c, h, w, blocks in networks.stage_chains(MODELS / f))
    assert round(ops / 67e12 * 1e3, 4) == 0.4991
    assert networks.stage_chains(MODELS / "face_landmarks_detector.onnx") == ()
    assert len(networks.stage_chains(MODELS / "face_landmark.onnx")) == 8


def test_stage_chains_are_those_the_program_fuses():
    from zaru_tpu_torch.onnx.executor import find_stages
    from zaru_tpu_torch.onnx.proto import parse_model

    for f in ("face_detection_short_range.onnx", "face_landmark.onnx"):
        blocks = sum(len(s.blocks) for s in find_stages(parse_model((MODELS / f).read_bytes())))
        assert blocks == sum(n for *_, n in networks.stage_chains(MODELS / f))


def _run(span, profiled, counters=None, config="face_v1", kind=H100):
    window = Window(1.0, [0.01], 0, 0, profiled, counters or {})
    return readings.Run(Spec().config(config), window, span, kind, MODELS)


def _span():
    k = lambda n, a, b: trace.Interval(n, a, b, "kernel")  # noqa: E731
    return trace.Span(0.020, [
        k("void blaze_stage_kernel<16>(...)", 0.000, 0.004), k("void rotated_sample_kernel(...)", 0.004, 0.005),
        k("void cudnn::conv(...)", 0.005, 0.009), trace.Interval("Memcpy DtoD", 0.009, 0.010, "copy"),
        k("void blaze_stage_kernel<128>(...)", 0.012, 0.014), k("elementwise", 0.014, 0.018),
    ])


def test_readers_on_a_canned_span():
    spec = Spec()
    tracked = torch.ones(512, dtype=torch.bool)
    profiled = [(512, tracked, True)] + [(512, tracked, False)] * 8
    run = _run(_span(), profiled, {"steps": 10, "ingest_s": 1.0})
    read = lambda name: spec.reader(name)(run)  # noqa: E731
    assert read("device_idle_share") == pytest.approx(100 * (1 - 0.016 / 0.020))
    assert read("network_device_ms") == pytest.approx((0.004 + 0.004 + 0.002 + 0.004) / 9 * 1e3)
    assert read("kernels_per_step.b1") == pytest.approx(5 / (9 * 512))
    assert read("ingest_host_ms") == pytest.approx(100.0)
    lm, det = (networks.flops(MODELS / f) for f in ("face_landmark.onnx", "face_detection_short_range.onnx"))
    assert read("step_mfu") == pytest.approx(100 * 512 * (9 * lm + det) / (0.020 * 67e12))
    bound = readings.stage_bound_seconds(run)
    assert read("stage_roofline") == pytest.approx(100 * bound / 0.006)
    # A stream that comes in lost makes an unforced step a detect step.
    lost = tracked.clone()
    lost[3] = False
    assert readings.network_flops(_run(_span(), [(512, lost, False)])) == 512 * (lm + det)


def test_readers_find_nothing_without_a_trace_or_a_known_card():
    spec = Spec()
    for name in ("device_idle_share", "network_device_ms", "kernels_per_step.b1", "step_mfu", "stage_roofline"):
        assert spec.reader(name)(_run(None, [])) is None
    assert spec.reader("ingest_host_ms")(_run(None, [])) is None
    for name in ("step_mfu", "stage_roofline"):
        assert spec.reader(name)(_run(_span(), [(1, torch.ones(1, dtype=torch.bool), True)], kind="cpu")) is None
    # No blaze_stage kernel in the span: no share, never 0.
    span = trace.Span(0.01, [trace.Interval("elementwise", 0.0, 0.005, "kernel")])
    assert spec.reader("stage_roofline")(_run(span, [(1, torch.ones(1, dtype=torch.bool), True)])) is None


def test_kept_steps_are_the_first_two_and_a_seeded_draw():
    def kept(seed, n):
        k = Kept(seed, 4)
        for t in range(n):
            k.offer(t, t)
        return [t for t, _ in k.steps()]

    a = kept(2**31 + 5, 500)
    assert a[:2] == [0, 1] and len(a) == 6 and a == sorted(a) and a == kept(2**31 + 5, 500)
    assert a != kept(2**31 + 6, 500)
    assert kept(1, 4) == [0, 1, 2, 3]
