"""Device milliseconds a step in the networks and the small-op tail: every
kernel of the profiled span but the samplers (copies are no kernels)."""

from benchmark.harness.readings import kernel_seconds

SAMPLERS = ("rotated_sample", "letterbox_sample")


def read(run):
    steps = len(run.profiled())
    if not run.device_busy() or not steps:
        return None
    return kernel_seconds(run.span, exclude=SAMPLERS) / steps * 1e3
