"""The readers of the program's fused bottleneck chains
(``benchmark/harness/bottlenecks.py``, ``bottleneck_device_ms``,
``bottleneck_roofline``) on canned traces, and the benchmark's own count of
the chains and their operations against the program's plan and
``onnx/analysis.analyze``."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from benchmark.harness import bottlenecks, readings, spans, trace
from benchmark.harness.loops import Window
from benchmark.harness.spec import Spec

MODELS = Path(__file__).resolve().parents[2] / "assets" / "onnx"
V2 = MODELS / "face_landmarks_detector.onnx"
H100 = "NVIDIA H100 80GB HBM3"


def _run(span, profiled, kind=H100):
    window = Window(1.0, [0.01], 0, 0, profiled, {})
    return readings.Run(Spec().config("face_v2"), window, span, kind, MODELS)


def _spanned(extra_launch=False, lost=(), copies=True):
    """Two tracking steps, times in ms: each step copies its gate's flag to
    the host, then its landmark network (a span ``zaru.track.net``)
    launches a kernel of its own and three chains of bottleneck blocks,
    each a span ``zaru.net.bottleneck`` whose launches run on the device
    after the host has moved on; each launch call and its interval share a
    correlation id. ``lost``: device records the profiler lost, by launch
    index."""
    ms = lambda n, a, b, kind: trace.Interval(n, a * 1e-3, b * 1e-3, kind)  # noqa: E731
    launches, ann, t_dev = [], [], 1.0
    for step in range(2):
        t0 = 10.0 * step
        ann.append(ms("zaru.step", t0, t0 + 9.0, "user_annotation"))
        ann.append(ms("zaru.track.net", t0 + 0.5, t0 + 4.0, "user_annotation"))
        if copies:
            launches.append(("cudaMemcpyAsync", t0 + 0.2, "Memcpy DtoH", 0.01))
        launches.append(("cudaLaunchKernel", t0 + 0.6, "stem", 0.5))
        for k, n in enumerate((1, 2, 1)):
            a = t0 + 1.0 + k
            ann.append(ms("zaru.net.bottleneck", a, a + 0.5, "user_annotation"))
            launches += [("cudaLaunchKernel", a + 0.1 * (j + 1), "bottleneck_block_kernel", 0.25 * (k + 1))
                         for j in range(n)]
        launches.append(("cudaLaunchKernel", t0 + 4.5, "tail", 0.1))
    device, calls = [], []
    for k, (call, t, name, dur) in enumerate(launches):
        calls.append(ms(call, t, t + 0.01, "cuda_runtime"))
        t_dev = max(t_dev, t + 0.05)
        device.append(ms(name, t_dev, t_dev + dur, "copy" if call == "cudaMemcpyAsync" else "kernel"))
        calls[-1].correlation = device[-1].correlation = 100 + k
        t_dev += dur
    if extra_launch:
        calls.append(ms("cudaLaunchKernel", 19.5, 19.51, "cuda_runtime"))
        calls[-1].correlation = 99
    device = [iv for k, iv in enumerate(device) if k not in lost]
    return trace.Span(0.020, device, ann + calls)


def test_device_ms_sums_every_chain_of_a_step():
    tracked = torch.ones(512, dtype=torch.bool)
    run = _run(_spanned(), [(512, tracked, False), (512, tracked, False)])
    # Per step: chains of 1, 2 and 1 launches of 0.25, 0.5 and 0.75 ms.
    per_step = 0.25 + 2 * 0.5 + 0.75
    seconds, steps = spans.device_seconds(run, bottlenecks.SPAN)
    assert seconds == pytest.approx(2 * per_step * 1e-3) and steps == run.profiled()
    assert Spec().reader("bottleneck_device_ms")(run) == pytest.approx(per_step)
    bound = bottlenecks.bound_seconds(run)
    assert Spec().reader("bottleneck_roofline")(run) == pytest.approx(100 * bound / (2 * per_step * 1e-3))


def test_bound_is_the_chains_least_time_at_512():
    """Face Mesh V2's seven chains at 512 frames, each bound by its
    operations (its input and output bytes take less): 1.3171 ms in all,
    the bound chip_smoke.py prints."""
    run = _run(trace.Span(0.01, [trace.Interval("k", 0, 0.001, "kernel")]),
               [(512, torch.ones(512, dtype=torch.bool), False)])
    assert round(bottlenecks.bound_seconds(run) * 1e3, 4) == 1.3171
    # The detector has no chain: a detect step bounds no more.
    assert bottlenecks.bound_seconds(_run(run.span, [(512, torch.ones(512, dtype=torch.bool), True)])) == \
        bottlenecks.bound_seconds(run)


@pytest.mark.parametrize("lost, extra_launch", [((0,), False), ((0, 1), False), ((4,), False), ((), True)])
def test_device_ms_reads_the_steps_whose_launches_pair(lost, extra_launch):
    """The device records of the first launches are lost (the copy, then
    the stem's kernel), or one inside the first step's chains, or a launch
    after the last step has none: the steps whose every launch pairs by
    correlation id are read."""
    tracked = torch.ones(512, dtype=torch.bool)
    run = _run(_spanned(extra_launch, lost), [(512, tracked, False), (512, tracked, False)])
    assert [w is None for _, w in spans.launched(run.span)].count(True) == len(lost) + extra_launch
    assert Spec().reader("bottleneck_device_ms")(run) == pytest.approx(0.25 + 2 * 0.5 + 0.75)
    seconds, steps = spans.device_seconds(run, bottlenecks.SPAN)
    assert len(steps) == (1 if lost else 2)
    assert Spec().reader("bottleneck_roofline")(run) == pytest.approx(
        100 * bottlenecks.bound_seconds(run, steps) / seconds)


@pytest.mark.parametrize("lost, copies", [((4, 13), True), ((6, 10), True), ((0, 8), False)])
def test_device_ms_refuses_when_no_step_pairs(lost, copies):
    """A record lost in each step leaves no step to read."""
    tracked = torch.ones(512, dtype=torch.bool)
    span = _spanned(lost=lost, copies=copies)
    assert Spec().reader("bottleneck_device_ms")(_run(span, [(512, tracked, False)] * 2)) is None


@pytest.mark.parametrize("name", ["bottleneck_device_ms", "bottleneck_roofline"])
def test_readers_find_nothing_without_the_span_or_pairs(name):
    read = Spec().reader(name)
    profiled = [(512, torch.ones(512, dtype=torch.bool), False)] * 2
    assert read(_run(None, [])) is None
    # An older program: kernels, launches and no zaru.net.bottleneck span.
    older = _spanned()
    older.host = [iv for iv in older.host if iv.name != bottlenecks.SPAN]
    assert read(_run(older, profiled)) is None
    # Work lost inside each step: no step pairs.
    assert read(_run(_spanned(lost=(4, 13)), profiled)) is None
    if name == "bottleneck_roofline":
        assert read(_run(_spanned(), profiled, kind="cpu")) is None


def test_chains_are_those_the_program_fuses():
    from zaru_tpu_torch.onnx.executor import find_bottlenecks
    from zaru_tpu_torch.onnx.proto import parse_model

    for f in ("face_landmarks_detector.onnx", "iris_landmark.onnx", "face_landmark.onnx",
              "face_detection_short_range.onnx"):
        program = [(c.channels, len(c.blocks)) for c in find_bottlenecks(parse_model((MODELS / f).read_bytes()))]
        assert program == [(c, n) for c, _, _, n in bottlenecks.chains(MODELS / f)]
    assert sum(n for *_, n in bottlenecks.chains(V2)) == 28


def test_block_ops_are_the_ports_count_of_the_nodes():
    """Each of Face Mesh V2's chains: the benchmark's operations equal what
    ``onnx/analysis.analyze``'s counter counts for the chain's nodes run one
    by one at batch 1, and the registered op's formula."""
    from torch.utils.flop_counter import FlopCounterMode

    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.onnx.analysis import _mapping
    from zaru_tpu_torch.onnx.executor import _OPS
    from zaru_tpu_torch.ops.bottleneck import bottleneck_flops

    net = load_model(V2.read_bytes(), torch.device("cpu"))
    params = net.params()
    x0 = torch.zeros(1, 3, 256, 256)
    with torch.no_grad():
        env = net.activations(x0)
    for chain, (c, h, w, n) in zip(net.bottlenecks, bottlenecks.chains(V2)):
        counter = FlopCounterMode(display=False, custom_mapping=_mapping())
        vals = dict(params)
        vals[chain.input] = env[chain.input]
        with torch.no_grad(), counter:
            for i in chain.nodes:
                node = net.nodes[i]
                vals[node.outputs[0]] = _OPS[node.op_type](node, [vals[k] for k in node.inputs])
        assert n * bottlenecks.block_ops(c, h, w) == counter.get_total_flops()
        assert n * bottlenecks.block_ops(c, h, w) == bottleneck_flops((1, c, h, w), (n, c * c + 8 * c))
