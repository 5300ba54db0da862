"""Device milliseconds of the iris network a step: the kernels launched
inside the program's ``zaru.iris.net`` span (both eyes of every stream)."""

from benchmark.harness.spans import device_ms


def read(run):
    return device_ms(run, "zaru.iris.net")
