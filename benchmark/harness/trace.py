"""The profiled span of a traced run: ``torch.profiler`` over whole steps
inside the window, reduced to intervals.

:class:`Profiler` starts and stops ``torch.profiler`` (CPU and CUDA
activity) and puts a mark at each end of the span; :meth:`Profiler.span`
reads the Chrome trace the profiler writes into a temporary directory and
returns a :class:`Span`: the span's ends, the device's kernels and copies,
and the host's operations, clipped to the span. Times are seconds from
the span's start.
"""

from __future__ import annotations

import json
import tempfile
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import torch

__all__ = ["Interval", "Profiler", "Span", "union_seconds", "gaps"]

MARK = "benchmark.span_mark"
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "copy"}
HOST_CATS = {"cpu_op", "cuda_runtime", "user_annotation", "cuda_driver"}


@dataclass
class Interval:
    name: str
    start: float
    end: float
    kind: str = ""  # "kernel" or "copy" on the device, the trace category on the host
    correlation: int | None = None  # the trace's id that ties a launch call to its work on the device

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Span:
    seconds: float  # length of the profiled span
    device: list = field(default_factory=list)  # kernels and copies on the card
    host: list = field(default_factory=list)  # host operations (for labelling idle gaps)

    def kernels(self) -> list:
        return [iv for iv in self.device if iv.kind == "kernel"]


def union_seconds(intervals) -> float:
    """Seconds covered by at least one of ``intervals``."""
    total, end = 0.0, float("-inf")
    for iv in sorted(intervals, key=lambda iv: iv.start):
        if iv.end <= end:
            continue
        total += iv.end - max(iv.start, end)
        end = iv.end
    return total


def gaps(intervals, length: float) -> list:
    """The idle stretches ``(start, end)`` of ``[0, length]`` that no
    interval covers."""
    out, cursor = [], 0.0
    for iv in sorted(intervals, key=lambda iv: iv.start):
        if iv.start > cursor:
            out.append((cursor, iv.start))
        cursor = max(cursor, iv.end)
    if cursor < length:
        out.append((cursor, length))
    return out


def _mark():
    with torch.profiler.record_function(MARK):
        pass


class Profiler:
    """``start()`` and ``stop()`` bracket whole steps; the caller has
    drained the device where its steps run ahead of it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self.done = False

    def start(self):
        self._prof.start()
        _mark()

    def stop(self):
        _mark()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # one profiling cycle: nothing is lost
            self._prof.stop()
        self.done = True

    def span(self) -> Span:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self._prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        return parse(events)


def parse(events: list) -> Span:
    """A Chrome trace's complete events (``"ph": "X"``, µs) → the
    :class:`Span` between its first and last mark; each interval keeps its
    event's ``args.correlation``."""
    marks = sorted(e["ts"] for e in events if e.get("ph") == "X" and e.get("name") == MARK)
    if len(marks) < 2:
        raise ValueError("the trace holds no span marks")
    t0, t1 = marks[0], marks[-1]
    span = Span((t1 - t0) * 1e-6)
    for e in events:
        if e.get("ph") != "X" or e.get("name") == MARK:
            continue
        cat = e.get("cat", "")
        start, end = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)
        if end <= start:
            continue
        iv = Interval(e["name"], (start - t0) * 1e-6, (end - t0) * 1e-6,
                      correlation=(e.get("args") or {}).get("correlation"))
        if cat in DEVICE_CATS:
            iv.kind = DEVICE_CATS[cat]
            span.device.append(iv)
        elif cat in HOST_CATS:
            iv.kind = cat
            span.host.append(iv)
    return span
