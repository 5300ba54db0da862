"""The stage kernel's share of its roofline: the least time of the
stride-1 BlazeBlock chains the profiled steps ran, over the device time of
the kernels named ``blaze_stage*``."""

from benchmark.harness.readings import kernel_seconds, stage_bound_seconds

KERNELS = ("blaze_stage",)


def read(run):
    if not run.device_busy() or run.peaks is None:
        return None
    spent = kernel_seconds(run.span, include=KERNELS)
    return 100.0 * stage_bound_seconds(run) / spent if spent > 0 else None
