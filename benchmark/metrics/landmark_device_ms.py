"""Device milliseconds of the landmark network a step: the kernels
launched inside the program's ``zaru.track.net`` span (Face Mesh)."""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "zaru.track.net")
