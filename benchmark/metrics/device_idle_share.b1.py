"""``device_idle_share`` of the one-stream cell."""

from benchmark.harness.readings import idle_share


def read(run):
    return idle_share(run)
