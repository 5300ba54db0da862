"""The fused entry blocks' share of their roofline: the least time of the
stride-2 residual bottleneck blocks that the profiled steps ran (per block
and frame the larger of its operations over the float32 peak and its input
and output bytes over the memory bandwidth) over the device time of their
``zaru.net.entry_block`` spans (the steps whose launches pair,
``benchmark/harness/entry_blocks.py``)."""

from benchmark.harness.entry_blocks import SPAN, bound_seconds
from benchmark.harness.spans import device_seconds


def read(run):
    found = device_seconds(run, SPAN) if run.peaks is not None else None
    if found is None or found[0] <= 0:
        return None
    seconds, steps = found
    return 100.0 * bound_seconds(run, steps) / seconds
