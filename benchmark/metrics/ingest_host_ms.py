"""Host milliseconds a step in the uploader: ``FrameUploader``'s own
``stage_seconds + flush_seconds`` over the window's steps."""


def read(run):
    c = run.window.counters
    return c["ingest_s"] / c["steps"] * 1e3 if c.get("steps") else None
