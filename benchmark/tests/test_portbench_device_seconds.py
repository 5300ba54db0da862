"""The six readers of the fused kernels' spans (``bottleneck_*``,
``blaze_block_*``, ``entry_block_*``) read through the one
:func:`benchmark.harness.spans.device_seconds`, which takes the span's name,
and return what they returned when each kernel's module kept its own copy:
the copy is kept here as it was, and both are read on the canned traces of
the readers' own test files."""

from __future__ import annotations

import importlib.util
from bisect import bisect_left, bisect_right
from pathlib import Path

import pytest
import torch

from benchmark.harness import blaze_blocks, bottlenecks, entry_blocks
from benchmark.harness.spans import host_spans, launched
from benchmark.harness.spec import Spec

HERE = Path(__file__).resolve().parent


def _tests(name: str):
    """A sibling test file as a module of its own, for its canned traces."""
    spec = importlib.util.spec_from_file_location(f"portbench_traces_{name}", HERE / f"test_portbench_{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _copy(run, span_name):
    """``device_seconds`` as each of the three modules held it."""
    spans = [iv for iv in host_spans(run, span_name) if iv.name == span_name]
    if not spans or not run.device_busy():
        return None
    pairs = launched(run.span)
    steps = sorted((iv for iv in host_spans(run, "zaru.step") if iv.name == "zaru.step"), key=lambda iv: iv.start)
    if pairs is None or len(steps) != len(run.profiled()):
        return None
    starts = [c.start for c, _ in pairs]

    def inside(iv):
        return [w for _, w in pairs[bisect_left(starts, iv.start):bisect_right(starts, iv.end)]]

    covered = [k for k, st in enumerate(steps) if all(w is not None for w in inside(st))]
    if not covered:
        return None
    seconds = 0.0
    for k in covered:
        st = steps[k]
        for s in spans:
            if st.start <= s.start <= st.end:
                seconds += sum(w.seconds for w in inside(s))
    return seconds, [run.profiled()[k] for k in covered]


def _before(kind: str, module, run):
    """What reader ``kind`` (``device_ms`` or ``roofline``) of ``module``'s
    kernel read through the copy."""
    found = _copy(run, module.SPAN)
    if kind == "device_ms":
        return None if found is None else found[0] / len(found[1]) * 1e3
    if run.peaks is None or found is None or found[0] <= 0:
        return None
    return 100.0 * module.bound_seconds(run, found[1]) / found[0]


def _older(span, name):
    span.host = [iv for iv in span.host if iv.name != name]
    return span


def _runs(kernel: str) -> list:
    """The runs the kernel's own test file reads, on each of its traces."""
    tracked = torch.ones(512, dtype=torch.bool)
    if kernel == "bottleneck":
        t = _tests("bottleneck")
        two = [(512, tracked, False)] * 2
        spans = [t._spanned(), t._spanned(lost=(0,)), t._spanned(lost=(0, 1)), t._spanned(lost=(4,)),
                 t._spanned(extra_launch=True), t._spanned(lost=(4, 13)), t._spanned(lost=(6, 10)),
                 t._spanned(lost=(0, 8), copies=False), _older(t._spanned(), bottlenecks.SPAN)]
        runs = [t._run(s, two) for s in spans] + [t._run(t._spanned(), two, kind="cpu"), t._run(None, [])]
        iris = _tests("iris")
        return runs + [iris._run(iris._spanned(), iris.PROFILED), iris._run(iris._spanned(iris=False), iris.PROFILED)]
    t = _tests(kernel)
    span = blaze_blocks.SPAN if kernel == "blaze_block" else entry_blocks.SPAN
    lost = [(), (0,), (1,), (8,)] if kernel == "blaze_block" else [(), (0,), (2,), (6,)]
    runs = [t._run(t._spanned(lost), t._profiled()) for lost in lost]
    return runs + [t._run(t._spanned(), t._profiled(), kind="cpu"), t._run(_older(t._spanned(), span), t._profiled()),
                   t._run(None, [])]


MODULES = {"bottleneck": bottlenecks, "blaze_block": blaze_blocks, "entry_block": entry_blocks}


@pytest.mark.parametrize("kind", ["device_ms", "roofline"])
@pytest.mark.parametrize("kernel", sorted(MODULES))
def test_each_reader_reads_what_it_read_before(kernel, kind):
    read = Spec().reader(f"{kernel}_{kind}")
    runs = _runs(kernel)
    got = [read(run) for run in runs]
    assert got == [_before(kind, MODULES[kernel], run) for run in runs]
    assert any(v is not None for v in got) and any(v is None for v in got)
