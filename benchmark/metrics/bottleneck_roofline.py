"""The fused bottleneck chains' share of their roofline: the least time of
the chains the profiled steps ran (per chain and frame the larger of its
operations over the float32 peak and its input and output bytes over the
memory bandwidth) over the device time of their ``zaru.net.bottleneck``
spans (the steps whose launches pair, ``benchmark/harness/bottlenecks.py``)."""

from benchmark.harness.bottlenecks import SPAN, bound_seconds
from benchmark.harness.spans import device_seconds


def read(run):
    found = device_seconds(run, SPAN) if run.peaks is not None else None
    if found is None or found[0] <= 0:
        return None
    seconds, steps = found
    return 100.0 * bound_seconds(run, steps) / seconds
