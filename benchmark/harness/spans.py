"""What the readers of the program's own spans share.

The program (``zaru_tpu_torch/profiling.py``) names the parts of its step
with spans that exist only while a profiler runs: each is a
``record_function`` range, a ``user_annotation`` host interval of the
:class:`~.trace.Span`. A span's device time is the device work launched
inside it, read from the trace alone: each launch call on the host (a
``cuda_runtime`` or ``cuda_driver`` interval that launches a kernel, a copy
or a memset) pairs with the interval on the device that carries its
correlation id (Kineto's ``args.correlation``, on both; the trace's device
clock may lead the host's, so times cannot pair them). Where the profiler
lost a call's device record, the program's spans that hold that call are
not read; where none is left, or where the device ran work that no call in
the trace launched, or the trace carries no ids, the device readers give
nothing, as all the readers do on a program without the spans (an older
checkout).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

from . import trace

__all__ = ["LAUNCHES", "SYNC", "device_ms", "device_seconds", "host_spans", "launched", "sync_idle_seconds"]

SYNC = "zaru.sync."  # the host syncs of the step path, one span a sync
LAUNCHES = ("LaunchKernel", "LaunchCooperativeKernel", "Memcpy", "Memset")  # in the calls' names


def host_spans(run, prefix: str) -> list:
    """The program's spans in the profiled span whose name starts with
    ``prefix``."""
    if run.span is None:
        return []
    return [iv for iv in run.span.host if iv.kind == "user_annotation" and iv.name.startswith(prefix)]


def launched(span) -> list | None:
    """``(launch call, device interval or None)`` of every kernel and copy
    launched in ``span``, in launch order, paired by correlation id: None in
    an interval's place where the device record was lost, and None in place
    of the list where the span has no device work, work without an id or
    sharing one, or work whose launch the trace does not hold."""
    work = span.device
    if not work or any(iv.correlation is None for iv in work):
        return None
    by_id = {iv.correlation: iv for iv in work}
    if len(by_id) != len(work):
        return None
    calls = sorted((iv for iv in span.host if iv.kind in ("cuda_runtime", "cuda_driver")
                    and (iv.correlation in by_id or any(w in iv.name for w in LAUNCHES))), key=lambda iv: iv.start)
    if len({c.correlation for c in calls} & by_id.keys()) != len(by_id):
        return None
    return [(c, by_id.get(c.correlation)) for c in calls]


def device_ms(run, name: str) -> float | None:
    """Mean device milliseconds of the program's span ``name``: the summed
    time of the kernels and copies launched inside each, over the spans
    whose every launch paired."""
    spans = [iv for iv in host_spans(run, name) if iv.name == name]
    pairs = launched(run.span) if spans and run.device_busy() else None
    if pairs is None:
        return None
    starts = [c.start for c, _ in pairs]
    total, read = 0.0, 0
    for s in spans:
        inside = [w for _, w in pairs[bisect_left(starts, s.start):bisect_right(starts, s.end)]]
        if all(w is not None for w in inside):
            total += sum(w.seconds for w in inside)
            read += 1
    return total / read * 1e3 if read else None


def device_seconds(run, name: str) -> tuple[float, list] | None:
    """``(seconds, steps)``: the summed device seconds of the work launched
    inside the program's spans ``name`` (one a fused block or chain) in the
    profiled steps whose every launch pairs, and those steps' entries of
    ``run.profiled()``. The profiler can lose the device records of its
    first milliseconds, so a step with an unpaired launch is left out.
    None on a program without the span (an older checkout), where the
    calls do not pair, or where no step pairs."""
    spans = [iv for iv in host_spans(run, name) if iv.name == name]
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
