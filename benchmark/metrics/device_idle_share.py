"""Per cent of the profiled span with no kernel or copy on the card."""

from benchmark.harness.readings import idle_share


def read(run):
    return idle_share(run)
