"""Host syncs a step: the program's ``zaru.sync.*`` spans in the profiled
span over the profiled steps."""

from benchmark.harness.spans import SYNC, host_spans


def read(run):
    syncs, steps = host_spans(run, SYNC), len(run.profiled())
    return len(syncs) / steps if syncs and steps else None
