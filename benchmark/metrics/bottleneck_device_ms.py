"""Device milliseconds a profiled step of the program's fused bottleneck
chains: the kernels launched inside its ``zaru.net.bottleneck`` spans,
summed over the spans and divided by the profiled steps (those whose
launches pair, ``benchmark/harness/bottlenecks.py``)."""

from benchmark.harness.bottlenecks import SPAN
from benchmark.harness.spans import device_seconds


def read(run):
    found = device_seconds(run, SPAN)
    if found is None:
        return None
    seconds, steps = found
    return seconds / len(steps) * 1e3
