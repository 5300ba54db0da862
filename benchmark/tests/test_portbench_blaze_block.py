"""The readers of the program's fused BlazeBlocks
(``benchmark/harness/blaze_blocks.py``, ``blaze_block_device_ms``,
``blaze_block_roofline``) on canned traces, and the benchmark's own walk of
the blocks, their operations and bytes against the program's plan and
``onnx/analysis.analyze``."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from benchmark.harness import blaze_blocks, readings, spans, trace
from benchmark.harness.loops import Window
from benchmark.harness.spec import Spec

MODELS = Path(__file__).resolve().parents[2] / "assets" / "onnx"
SHORT = MODELS / "face_detection_short_range.onnx"
V1 = MODELS / "face_landmark.onnx"
H100 = "NVIDIA H100 80GB HBM3"


def _run(span, profiled, kind=H100, config="face_v1"):
    window = Window(1.0, [0.01], 0, 0, profiled, {})
    return readings.Run(Spec().config(config), window, span, kind, MODELS)


def _spanned(lost=(), detect=(True, False)):
    """Two steps, times in ms: each copies its gate's flag to the host, then
    runs a network (a span ``zaru.track.net``) that launches a kernel of its
    own and three blocks, each a span ``zaru.net.blaze_block`` with one
    launch that runs on the device after the host has moved on; a detect
    step first runs two more blocks in ``zaru.detect.net``. Each launch call
    and its interval share a correlation id. ``lost``: device records the
    profiler lost, by launch index."""
    ms = lambda n, a, b, kind: trace.Interval(n, a * 1e-3, b * 1e-3, kind)  # noqa: E731
    launches, ann, t_dev = [], [], 1.0
    for step, detects in enumerate(detect):
        t0 = 10.0 * step
        ann.append(ms("zaru.step", t0, t0 + 9.0, "user_annotation"))
        launches.append(("cudaMemcpyAsync", t0 + 0.2, "Memcpy DtoH", 0.01))
        if detects:
            for k in range(2):
                a = t0 + 0.3 + 0.1 * k
                ann.append(ms(blaze_blocks.SPAN, a, a + 0.05, "user_annotation"))
                launches.append(("cudaLaunchKernel", a + 0.01, "blaze_block_kernel", 0.125))
        ann.append(ms("zaru.track.net", t0 + 0.5, t0 + 4.0, "user_annotation"))
        launches.append(("cudaLaunchKernel", t0 + 0.6, "stem", 0.5))
        for k in range(3):
            a = t0 + 1.0 + k
            ann.append(ms(blaze_blocks.SPAN, a, a + 0.5, "user_annotation"))
            launches.append(("cudaLaunchKernel", a + 0.1, "blaze_block_kernel", 0.25 * (k + 1)))
        launches.append(("cudaLaunchKernel", t0 + 4.5, "tail", 0.1))
    device, calls = [], []
    for k, (call, t, name, dur) in enumerate(launches):
        calls.append(ms(call, t, t + 0.01, "cuda_runtime"))
        t_dev = max(t_dev, t + 0.05)
        device.append(ms(name, t_dev, t_dev + dur, "copy" if call == "cudaMemcpyAsync" else "kernel"))
        calls[-1].correlation = device[-1].correlation = 100 + k
        t_dev += dur
    device = [iv for k, iv in enumerate(device) if k not in lost]
    return trace.Span(0.020, device, ann + calls)


def _profiled(detect=(True, False)):
    tracked = torch.ones(512, dtype=torch.bool)
    return [(512, tracked, d) for d in detect]


def test_device_ms_sums_every_block_of_a_step():
    run = _run(_spanned(), _profiled())
    # The detect step: two blocks of 0.125 ms; each step: 0.25, 0.5, 0.75 ms.
    total = 2 * 0.125 + 2 * (0.25 + 0.5 + 0.75)
    seconds, steps = spans.device_seconds(run, blaze_blocks.SPAN)
    assert seconds == pytest.approx(total * 1e-3) and steps == run.profiled()
    assert Spec().reader("blaze_block_device_ms")(run) == pytest.approx(total / 2)
    bound = blaze_blocks.bound_seconds(run)
    assert Spec().reader("blaze_block_roofline")(run) == pytest.approx(100 * bound / (total * 1e-3))


def test_bound_is_the_blocks_least_time_at_512():
    """At 512 frames: BlazeFace short range's 11 blocks 0.4761 ms (1.573 GB
    of input and output, 0.4695 ms, and the 72→80 and 80→88 blocks bound
    by their operations), Face Mesh V1's 6 blocks 0.2578 ms (0.8635 GB);
    a detect step bounds both, a tracking step Face Mesh V1 alone."""
    span = trace.Span(0.01, [trace.Interval("k", 0, 0.001, "kernel")])
    tracking = blaze_blocks.bound_seconds(_run(span, _profiled((False,))))
    detect = blaze_blocks.bound_seconds(_run(span, _profiled((True,))))
    assert round(tracking * 1e3, 4) == 0.2578
    assert round((detect - tracking) * 1e3, 4) == 0.4761
    assert 512 * sum(blaze_blocks.block_bytes(*b[:4], *b[4:]) for b in blaze_blocks.blocks(SHORT)) == 1572864000
    assert 512 * sum(blaze_blocks.block_bytes(*b[:4], *b[4:]) for b in blaze_blocks.blocks(V1)) == 863502336
    # Face Mesh V2 has no such block: only BlazeFace on its detect steps.
    v2 = blaze_blocks.bound_seconds(_run(span, _profiled((True, False)), config="face_v2"))
    assert v2 == pytest.approx(detect - tracking)


@pytest.mark.parametrize("lost", [(0,), (1,), (8,)])
def test_device_ms_reads_the_steps_whose_launches_pair(lost):
    """A device record lost in a step (the copy, a block's kernel) leaves
    that step unread; the other step is read with its own bound."""
    run = _run(_spanned(lost), _profiled())
    assert [w is None for _, w in spans.launched(run.span)].count(True) == len(lost)
    seconds, steps = spans.device_seconds(run, blaze_blocks.SPAN)
    first = lost[0] < 8  # launches 0-7 are the first step's
    assert steps == (run.profiled()[1:] if first else run.profiled()[:1])
    assert seconds == pytest.approx((1.5 if first else 1.75) * 1e-3)
    assert Spec().reader("blaze_block_roofline")(run) == pytest.approx(
        100 * blaze_blocks.bound_seconds(run, steps) / seconds)


@pytest.mark.parametrize("name", ["blaze_block_device_ms", "blaze_block_roofline"])
def test_readers_find_nothing_without_the_span_or_pairs(name):
    read = Spec().reader(name)
    assert read(_run(None, [])) is None
    # An older program: kernels, launches and no zaru.net.blaze_block span.
    older = _spanned()
    older.host = [iv for iv in older.host if iv.name != blaze_blocks.SPAN]
    assert read(_run(older, _profiled())) is None
    # Work lost inside each step: no step pairs.
    assert read(_run(_spanned(lost=(0, 8)), _profiled())) is None
    if name == "blaze_block_roofline":
        assert read(_run(_spanned(), _profiled(), kind="cpu")) is None


def test_blocks_are_those_the_program_fuses():
    """The benchmark's walk finds the program's 11 and 6 blocks, and none in
    Face Mesh V2 and the iris model; each block's bytes are its float32
    input and output at the shapes the program runs."""
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.onnx.executor import find_blaze_blocks
    from zaru_tpu_torch.onnx.proto import parse_model

    for f, n in ((SHORT, 11), (V1, 6), (MODELS / "face_landmarks_detector.onnx", 0),
                 (MODELS / "iris_landmark.onnx", 0)):
        program = [(b.c_in, b.c_out) for b in find_blaze_blocks(parse_model(f.read_bytes()))]
        assert program == [b[:2] for b in blaze_blocks.blocks(f)] and len(program) == n
    for f, res in ((SHORT, 128), (V1, 192)):
        net = load_model(f.read_bytes(), torch.device("cpu"))
        with torch.no_grad():
            env = net.activations(torch.zeros(1, 3, res, res))
        for blk, (c_in, c_out, h, w, ho, wo) in zip(net.blaze_blocks, blaze_blocks.blocks(f)):
            assert blaze_blocks.block_bytes(c_in, c_out, h, w, ho, wo) == 4 * (
                env[blk.input].numel() + env[blk.output].numel())


@pytest.mark.parametrize("f", [SHORT, V1])
def test_block_ops_are_the_ports_count_of_the_nodes(f):
    """Each block: the benchmark's operations equal the registered op's
    formula and what ``onnx/analysis.analyze``'s counter counts for the
    network with and without the plan."""
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.onnx.analysis import analyze
    from zaru_tpu_torch.ops.blaze_block import blaze_block_flops, row_floats

    net = load_model(f.read_bytes(), torch.device("cpu"))
    for blk, (c_in, c_out, h, w, ho, wo) in zip(net.blaze_blocks, blaze_blocks.blocks(f)):
        assert blaze_blocks.block_ops(c_in, c_out, ho, wo) == blaze_block_flops(
            (1, c_in, h, w), (row_floats(c_in, c_out),), c_out, blk.stride, blk.pads, blk.relu)
    with_plan = analyze(net).flops
    with net.without_plans("blaze_blocks"):
        assert analyze(net).flops == with_plan


def test_stage_roofline_does_not_read_the_block_kernel():
    """``stage_roofline`` divides by the kernels named ``blaze_stage*``: the
    BlazeBlock kernel's name holds none of the names the accepted readers
    match (nor the bottleneck kernel's or the samplers')."""
    kernels = Spec().reader("stage_roofline").__globals__["KERNELS"]
    name = "blaze_block_kernel"
    assert not any(k in name for k in (*kernels, "bottleneck", "rotated_sample", "letterbox_sample"))
    span = trace.Span(0.01, [trace.Interval(name, 0, 0.001, "kernel")])
    assert readings.kernel_seconds(span, include=kernels) == 0
