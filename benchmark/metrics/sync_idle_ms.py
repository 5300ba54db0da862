"""Device idle milliseconds a step after the host syncs: for each
``zaru.sync.*`` span, the idle stretch that holds its end (or the first
after it, where a copy covers the end), over the profiled steps."""

from benchmark.harness.spans import SYNC, host_spans, sync_idle_seconds


def read(run):
    syncs, steps = host_spans(run, SYNC), len(run.profiled())
    if not syncs or not steps or not run.device_busy():
        return None
    return sync_idle_seconds(run.span, syncs) / steps * 1e3
