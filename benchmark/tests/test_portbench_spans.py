"""The readers of the program's own spans (``benchmark/harness/spans.py``)
on canned traces: the counts and idle after the host syncs, each span's
device time from the launches paired with the device's intervals, and
nothing where the trace holds no span or its launches do not pair."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from benchmark.harness import readings, spans, trace
from benchmark.harness.loops import Window
from benchmark.harness.report import breakdown
from benchmark.harness.spec import Spec

MODELS = Path(__file__).resolve().parents[2] / "assets" / "onnx"


def _run(span, profiled):
    window = Window(1.0, [0.01], 0, 0, profiled, {})
    return readings.Run(Spec().config("face_v1"), window, span, "NVIDIA H100 80GB HBM3", MODELS)


def _span():
    """Kernels and a copy, with no span of the program (an older program)."""
    k = lambda n, a, b: trace.Interval(n, a, b, "kernel")  # noqa: E731
    return trace.Span(0.020, [k("void blaze_stage_kernel<16>(...)", 0.000, 0.004),
                              trace.Interval("Memcpy DtoD", 0.009, 0.010, "copy"), k("elementwise", 0.014, 0.018)])


def _spanned():
    """Two steps, times in ms: a tracking step (0-7.8) that reads the gate
    at 0.5-1.0, its copy done at 0.7 and the device idle until 1.2; a
    forced detect step (7.8-20) whose letterbox fit copies at 8.2-8.6,
    covered on the device by that copy until 8.7, then idle until 8.8.
    Each launch call and its interval on the device share a correlation
    id."""
    ms = lambda n, a, b, kind: trace.Interval(n, a * 1e-3, b * 1e-3, kind)  # noqa: E731
    launches = [("cudaMemcpyAsync", 0.5, "Memcpy DtoH", 0.6, 0.7, "copy"),
                ("cudaLaunchKernel", 1.1, "lm", 1.2, 5.2, "kernel"),
                ("cuLaunchKernel", 1.5, "blaze_stage", 5.2, 7.2, "kernel"),
                ("cudaLaunchKernel", 2.1, "tail", 7.2, 7.5, "kernel"),
                ("cudaMemcpyAsync", 8.2, "Memcpy HtoD", 8.5, 8.7, "copy"),
                ("cudaLaunchKernel", 8.7, "det", 8.8, 16.8, "kernel"),
                ("cudaMemsetAsync", 10.1, "Memset", 16.8, 16.9, "copy"),
                ("cudaLaunchKernel", 10.2, "nms", 16.9, 17.4, "kernel"),
                ("cudaLaunchKernel", 12.1, "lm", 17.4, 19.4, "kernel"),
                ("cudaLaunchKernel", 13.1, "tail", 19.4, 19.5, "kernel")]
    device = [ms(n, a, b, kind) for _, _, n, a, b, kind in launches]
    calls = [ms(c, t, t + 0.01, "cuda_driver" if c.startswith("cu") and not c.startswith("cuda") else "cuda_runtime")
             for c, t, *_ in launches]
    for k, (call, work) in enumerate(zip(calls, device)):
        call.correlation = work.correlation = 100 + k
    ann = [ms(n, a, b, "user_annotation") for n, a, b in [
        ("zaru.step", 0.0, 7.8), ("zaru.sync.gate", 0.5, 1.0), ("zaru.track.net", 1.1, 2.0),
        ("zaru.track.tail", 2.0, 3.0), ("zaru.step", 7.8, 20.0), ("zaru.detect", 8.1, 12.0),
        ("zaru.sync.frame_fit", 8.2, 8.6), ("zaru.detect.net", 8.7, 10.0), ("zaru.detect.tail", 10.0, 11.0),
        ("zaru.track.net", 12.1, 13.0), ("zaru.track.tail", 13.0, 14.0)]]
    other = [ms("cudaStreamIsCapturing", 2.2, 2.21, "cuda_runtime"), ms("aten::copy_", 8.2, 8.6, "cpu_op")]
    return trace.Span(0.020, device, ann + calls + other)


def test_span_readers_on_a_canned_span():
    spec = Spec()
    tracked = torch.ones(512, dtype=torch.bool)
    run = _run(_spanned(), [(512, tracked, False), (512, tracked, True)])
    read = lambda name: spec.reader(name)(run)  # noqa: E731
    assert read("host_syncs_per_step") == pytest.approx(1.0)
    # The gate's end lies in the idle stretch 0.7-1.2 ms; the fit's end
    # under its copy, so the stretch after it, 8.7-8.8 ms, counts.
    assert read("sync_idle_ms") == pytest.approx((0.5 + 0.1) / 2)
    # The work launched inside each span, whenever the device ran it.
    assert read("detect_device_ms") == pytest.approx(0.2 + 8.0 + 0.1 + 0.5)
    assert read("landmark_device_ms") == pytest.approx((6.0 + 2.0) / 2)
    assert read("track_tail_device_ms") == pytest.approx((0.3 + 0.1) / 2)
    # The step's span names the idle stretch between the steps, where no
    # op of the host was traced.
    assert breakdown(run.span)["idle_gaps"][0] == ["host: zaru.step", pytest.approx(0.001)]


@pytest.mark.parametrize("fault", ["a launch untraced", "work with no launch"])
@pytest.mark.parametrize("name", ["detect_device_ms", "landmark_device_ms", "track_tail_device_ms"])
def test_device_readers_refuse_calls_and_work_that_do_not_pair(name, fault):
    span = _spanned()
    if fault == "a launch untraced":
        span.host = [iv for iv in span.host if not (iv.name == "cuLaunchKernel")]
    else:
        span.device.append(trace.Interval("Memcpy DtoD", 0.0195, 0.0196, "copy", correlation=999))
    assert spans.launched(_spanned()) is not None and spans.launched(span) is None
    assert Spec().reader(name)(_run(span, [(512, torch.ones(512, dtype=torch.bool), True)])) is None


@pytest.mark.parametrize("name", ["host_syncs_per_step", "sync_idle_ms", "detect_device_ms",
                                  "landmark_device_ms", "track_tail_device_ms"])
def test_span_readers_find_nothing_without_the_programs_spans(name):
    read = Spec().reader(name)
    profiled = [(512, torch.ones(512, dtype=torch.bool), True)]
    assert read(_run(None, [])) is None
    # A trace with kernels but none of the program's spans (an older program).
    assert read(_run(_span(), profiled)) is None
