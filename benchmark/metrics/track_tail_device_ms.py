"""Device milliseconds of the tracking tail a step: the kernels and
copies launched inside the program's ``zaru.track.tail`` span (decode, 1€
filter, unmap, next ROI)."""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "zaru.track.tail")
