"""``step_mfu`` of the one-stream cell."""

from benchmark.harness.readings import network_flops


def read(run):
    if not run.device_busy() or run.peaks is None:
        return None
    return 100.0 * network_flops(run) / (run.span.seconds * run.peaks["f32_flops"])
