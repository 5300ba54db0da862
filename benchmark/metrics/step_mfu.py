"""The whole step's share of the card's float32 peak: the networks'
operations for the frames the profiled steps ran, over the span's length
times the peak."""

from benchmark.harness.readings import network_flops


def read(run):
    if not run.device_busy() or run.peaks is None:
        return None
    return 100.0 * network_flops(run) / (run.span.seconds * run.peaks["f32_flops"])
