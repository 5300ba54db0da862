"""Kernel launches on the card a frame: the profiled span's kernel events
over the frames its steps ran."""


def read(run):
    frames = sum(n for n, _ in run.profiled())
    if not run.device_busy() or not frames:
        return None
    return len(run.span.kernels()) / frames
