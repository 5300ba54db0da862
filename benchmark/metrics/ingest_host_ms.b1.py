"""``ingest_host_ms`` of the one-stream cell: the uploader's host
milliseconds a step."""


def read(run):
    c = run.window.counters
    return c["ingest_s"] / c["steps"] * 1e3 if c.get("steps") else None
