"""Device milliseconds a profiled step of the program's fused entry blocks
(the stride-2 residual bottleneck blocks): the kernels launched inside its
``zaru.net.entry_block`` spans, summed over the spans and divided by the
profiled steps (those whose launches pair,
``benchmark/harness/entry_blocks.py``)."""

from benchmark.harness.entry_blocks import SPAN
from benchmark.harness.spans import device_seconds


def read(run):
    found = device_seconds(run, SPAN)
    if found is None:
        return None
    seconds, steps = found
    return seconds / len(steps) * 1e3
