"""Device milliseconds of the detect branch, a detect step: the kernels
and copies launched inside the program's ``zaru.detect`` span (letterbox,
BlazeFace, decode, NMS, unmap)."""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "zaru.detect")
