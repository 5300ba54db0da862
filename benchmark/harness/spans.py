"""What the readers of the program's own spans share.

The program (``zaru_tpu_torch/profiling.py``) names the parts of its step
with spans that exist only while a profiler runs: each is a
``record_function`` range, a ``user_annotation`` host interval of the
:class:`~.trace.Span`. A span's device time is the device work launched
inside it, read from the trace alone: the card runs the kernels and copies
of the step's one stream in the order the host launched them, so the n-th
launch call on the host (a ``cuda_runtime`` or ``cuda_driver`` interval
that launches a kernel, a copy or a memset) pairs with the n-th interval
on the device (the pairing Kineto's correlation ids give, on the card's
traces; the trace's device clock may lead the host's by a few hundred
microseconds, so times cannot pair them). Where the two counts differ the
pairing is unsound and the device readers give nothing; so do all the
readers on a program without the spans (an older checkout).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

from . import trace

__all__ = ["LAUNCHES", "SYNC", "device_ms", "host_spans", "launched", "sync_idle_seconds"]

SYNC = "zaru.sync."  # the host syncs of the step path, one span a sync
LAUNCHES = ("LaunchKernel", "LaunchCooperativeKernel", "Memcpy", "Memset")  # in the calls' names


def host_spans(run, prefix: str) -> list:
    """The program's spans in the profiled span whose name starts with
    ``prefix``."""
    if run.span is None:
        return []
    return [iv for iv in run.span.host if iv.kind == "user_annotation" and iv.name.startswith(prefix)]


def launched(span) -> list | None:
    """``(launch call, device interval)`` of every kernel and copy of
    ``span``, in launch order; None where calls and intervals do not pair."""
    calls = sorted((iv for iv in span.host if iv.kind in ("cuda_runtime", "cuda_driver")
                    and any(w in iv.name for w in LAUNCHES)), key=lambda iv: iv.start)
    work = sorted(span.device, key=lambda iv: iv.start)
    if not work or len(calls) != len(work):
        return None
    return list(zip(calls, work))


def device_ms(run, name: str) -> float | None:
    """Mean device milliseconds of the program's span ``name``: the summed
    time of the kernels and copies launched inside each, over the spans."""
    spans = [iv for iv in host_spans(run, name) if iv.name == name]
    pairs = launched(run.span) if spans and run.device_busy() else None
    if pairs is None:
        return None
    starts = [c.start for c, _ in pairs]
    total = 0.0
    for s in spans:
        total += sum(w.seconds for _, w in pairs[bisect_left(starts, s.start):bisect_right(starts, s.end)])
    return total / len(spans) * 1e3


def sync_idle_seconds(span, syncs) -> float:
    """Device idle that follows the host syncs ``syncs``: for each, the idle
    stretch of ``span`` that holds the sync's end or, where a copy on the
    device covers that end, the first stretch after it; each stretch
    counted once."""
    gaps = trace.gaps(span.device, span.seconds)
    copies = [iv for iv in span.device if iv.kind == "copy"]
    held = set()
    for s in syncs:
        gap = next((g for g in gaps if g[0] <= s.end <= g[1]), None)
        if gap is None and any(c.start <= s.end <= c.end for c in copies):
            gap = next((g for g in gaps if g[0] >= s.end), None)
        if gap is not None:
            held.add(gap)
    return sum(b - a for a, b in held)
