"""Profiling hooks (zaru_tpu/profiling.py).

- :func:`trace`: ``torch.profiler`` over a block, the CPU and, when a GPU is
  present, the card's kernels; the trace goes into ``log_dir`` as a
  Chrome/Perfetto JSON file (``chrome://tracing``, ui.perfetto.dev). No
  tensorboard package is needed.
- :func:`annotate`: a named range on that timeline.
- :func:`device_timer`: times a block up to the completion of the device
  work it issued.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

__all__ = ["annotate", "device_timer", "trace"]


@contextmanager
def trace(log_dir: str | os.PathLike):
    """Captures a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/trace_<pid>_<ns>.json``; yields the profiler, whose
    ``key_averages()`` sum the kernels' time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named range on the profiler's timeline (``record_function``)."""
    return torch.profiler.record_function(name)


@contextmanager
def device_timer(label: str = "block", sink=print):
    """Times a block including the device work it issued. Yields ``sync``:
    pass it the block's outputs (tensors or trees of them; it returns them
    unchanged), and on exit every device that holds one of them is
    synchronized before the clock is read::

        with device_timer("step") as sync:
            out = sync(step(state, frames))
    """
    pending = []

    def sync(x):
        pending.append(x)
        return x

    start = time.perf_counter()
    try:
        yield sync
    finally:
        devices = {
            t.device for t in pytree.tree_leaves(pending)
            if isinstance(t, torch.Tensor) and t.device.type == "cuda"
        }
        for dev in devices:
            torch.cuda.synchronize(dev)
        sink(f"{label}: {(time.perf_counter() - start) * 1e3:.2f}ms")
