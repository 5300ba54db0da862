"""The readers of the program's fused entry blocks
(``benchmark/harness/entry_blocks.py``, ``entry_block_device_ms``,
``entry_block_roofline``) on canned traces, and the benchmark's own walk of
the blocks, their operations and bytes against the program's plan and
``onnx/analysis.analyze``."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from benchmark.harness import entry_blocks, readings, spans, trace
from benchmark.harness.loops import Window
from benchmark.harness.spec import Spec

MODELS = Path(__file__).resolve().parents[2] / "assets" / "onnx"
V2 = MODELS / "face_landmarks_detector.onnx"
IRIS = MODELS / "iris_landmark.onnx"
H100 = "NVIDIA H100 80GB HBM3"
# (C_in, M, C_out, H) of each block, in graph order.
SHAPES = {
    V2: [(16, 16, 32, 128), (32, 32, 64, 64), (64, 64, 128, 32), (128, 64, 128, 16), (128, 64, 128, 8),
         (128, 64, 128, 4)],
    IRIS: [(64, 64, 128, 32), (128, 64, 128, 16), (128, 64, 128, 8), (128, 64, 128, 4), (128, 64, 128, 8),
           (128, 64, 128, 4)],
}


def _run(span, profiled, kind=H100, config="face_v2"):
    window = Window(1.0, [0.01], 0, 0, profiled, {})
    return readings.Run(Spec().config(config), window, span, kind, MODELS)


def _spanned(lost=()):
    """Two steps, times in ms: each copies its gate's flag to the host, then
    runs a network (a span ``zaru.track.net``) that launches a kernel of its
    own and three blocks, each a span ``zaru.net.entry_block`` with one
    launch that runs on the device after the host has moved on. Each launch
    call and its interval share a correlation id. ``lost``: device records
    the profiler lost, by launch index."""
    ms = lambda n, a, b, kind: trace.Interval(n, a * 1e-3, b * 1e-3, kind)  # noqa: E731
    launches, ann, t_dev = [], [], 1.0
    for step in range(2):
        t0 = 10.0 * step
        ann.append(ms("zaru.step", t0, t0 + 9.0, "user_annotation"))
        launches.append(("cudaMemcpyAsync", t0 + 0.2, "Memcpy DtoH", 0.01))
        ann.append(ms("zaru.track.net", t0 + 0.5, t0 + 4.0, "user_annotation"))
        launches.append(("cudaLaunchKernel", t0 + 0.6, "stem", 0.5))
        for k in range(3):
            a = t0 + 1.0 + k
            ann.append(ms(entry_blocks.SPAN, a, a + 0.5, "user_annotation"))
            launches.append(("cudaLaunchKernel", a + 0.1, "entry_block_kernel", 0.25 * (k + 1)))
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
    total = 2 * (0.25 + 0.5 + 0.75)
    seconds, steps = spans.device_seconds(run, entry_blocks.SPAN)
    assert seconds == pytest.approx(total * 1e-3) and steps == run.profiled()
    assert Spec().reader("entry_block_device_ms")(run) == pytest.approx(total / 2)
    bound = entry_blocks.bound_seconds(run)
    assert Spec().reader("entry_block_roofline")(run) == pytest.approx(100 * bound / (total * 1e-3))


def test_bound_is_the_blocks_least_time():
    """Face Mesh V2's six blocks at 512 frames: 0.514 ms (the 16-channel
    block bound by its 805 MB of input and output, 0.240 ms; the 64- and
    128-channel blocks by operations); the iris model's six at 1,024 crops
    (two a stream): 0.332 ms; on every step, detect or not. Face Mesh V1 and
    BlazeFace have none."""
    span = trace.Span(0.01, [trace.Interval("k", 0, 0.001, "kernel")])
    for config, want in (("face_v2", 0.514), ("face_v1_iris", 0.332), ("face_v1", 0.0)):
        for detect in (False, True):
            got = entry_blocks.bound_seconds(_run(span, _profiled((detect,)), config=config))
            assert round(got * 1e3, 3) == want, (config, detect)
    first = entry_blocks.blocks(V2)[0]
    assert 512 * entry_blocks.block_bytes(first[0], first[2], *first[3:]) == 805306368


@pytest.mark.parametrize("lost", [(0,), (2,), (6,)])
def test_device_ms_reads_the_steps_whose_launches_pair(lost):
    """A device record lost in a step (the copy, a block's kernel) leaves
    that step unread; the other step is read with its own bound."""
    run = _run(_spanned(lost), _profiled())
    assert [w is None for _, w in spans.launched(run.span)].count(True) == len(lost)
    seconds, steps = spans.device_seconds(run, entry_blocks.SPAN)
    first = lost[0] < 6  # launches 0-5 are the first step's
    assert steps == (run.profiled()[1:] if first else run.profiled()[:1])
    assert seconds == pytest.approx(1.5e-3)
    assert Spec().reader("entry_block_roofline")(run) == pytest.approx(
        100 * entry_blocks.bound_seconds(run, steps) / seconds)


@pytest.mark.parametrize("name", ["entry_block_device_ms", "entry_block_roofline"])
def test_readers_find_nothing_without_the_span_or_pairs(name):
    read = Spec().reader(name)
    assert read(_run(None, [])) is None
    # An older program: kernels, launches and no zaru.net.entry_block span.
    older = _spanned()
    older.host = [iv for iv in older.host if iv.name != entry_blocks.SPAN]
    assert read(_run(older, _profiled())) is None
    # Work lost inside each step: no step pairs.
    assert read(_run(_spanned(lost=(0, 6)), _profiled())) is None
    if name == "entry_block_roofline":
        assert read(_run(_spanned(), _profiled(), kind="cpu")) is None


def test_blocks_are_those_the_program_fuses():
    """The benchmark's walk finds the program's six blocks in Face Mesh V2
    and in the iris model, at the widths pinned here, and none in Face Mesh
    V1 and BlazeFace; each block's bytes are its float32 input and output at
    the shapes the program runs."""
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.onnx.executor import find_entry_blocks
    from zaru_tpu_torch.onnx.proto import parse_model

    for f in (V2, IRIS, MODELS / "face_landmark.onnx", MODELS / "face_detection_short_range.onnx"):
        program = [(b.c_in, b.m, b.c_out) for b in find_entry_blocks(parse_model(f.read_bytes()))]
        assert program == [b[:3] for b in entry_blocks.blocks(f)]
        assert [(*b[:3], b[3]) for b in entry_blocks.blocks(f)] == SHAPES.get(f, [])
    for f, res in ((V2, 256), (IRIS, 64)):
        net = load_model(f.read_bytes(), torch.device("cpu"))
        with torch.no_grad():
            env = net.activations(torch.zeros(1, 3, res, res))
        for blk, (c_in, m, c_out, h, w, ho, wo) in zip(net.entry_blocks, entry_blocks.blocks(f), strict=True):
            assert entry_blocks.block_bytes(c_in, c_out, h, w, ho, wo) == 4 * (
                env[blk.input].numel() + env[blk.output].numel())


@pytest.mark.parametrize("f", [V2, IRIS])
def test_block_ops_are_the_ports_count_of_the_nodes(f):
    """Each block: the benchmark's operations equal the registered op's
    formula, and ``onnx/analysis.analyze`` counts the network alike with and
    without the plan."""
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.onnx.analysis import analyze
    from zaru_tpu_torch.ops.entry_block import entry_block_flops, row_floats

    net = load_model(f.read_bytes(), torch.device("cpu"))
    for blk, (c_in, m, c_out, h, w, ho, wo) in zip(net.entry_blocks, entry_blocks.blocks(f), strict=True):
        assert entry_blocks.block_ops(c_in, m, c_out, ho, wo) == entry_block_flops(
            (1, c_in, h, w), (row_floats(c_in, m),), blk.m)
    with_plan = analyze(net).flops
    with net.without_plans("entry_blocks"):
        assert analyze(net).flops == with_plan


def test_accepted_readers_do_not_read_the_entry_kernel():
    """``stage_roofline`` divides by the kernels named ``blaze_stage*``, the
    bottleneck and BlazeBlock readers by their own spans: the entry block
    kernel's name holds none of the names the accepted readers match."""
    kernels = Spec().reader("stage_roofline").__globals__["KERNELS"]
    name = "entry_block_kernel"
    assert not any(k in name for k in (*kernels, "bottleneck", "blaze_block", "rotated_sample", "letterbox_sample"))
    span = trace.Span(0.01, [trace.Interval(name, 0, 0.001, "kernel")])
    assert readings.kernel_seconds(span, include=kernels) == 0
