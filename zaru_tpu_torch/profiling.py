"""Profiling hooks (zaru_tpu/profiling.py): the program's spans and counters.

- :func:`trace`: ``torch.profiler`` over a block, the CPU and, when a GPU is
  present, the card's kernels; the trace goes into ``log_dir`` as a
  Chrome/Perfetto JSON file (``chrome://tracing``, ui.perfetto.dev). No
  tensorboard package is needed.
- :func:`span` (and its older name :func:`annotate`): a named range of the
  program. It costs one flag check while no profiler runs; under any
  ``torch.profiler`` profile it is a ``record_function`` range in the same
  trace as the kernels, on the same clock, so a reader of the trace can
  give each span the device work launched inside it.
- :data:`counters`: plain numbers, always on, each update one ``+=``:
  ``steps`` (tracker steps), ``detect_steps`` (steps that ran the detect
  branch), ``host_syncs`` (host syncs of the step path, each also a
  ``zaru.sync.<site>`` span), ``host_copies`` (device copies the ONNX
  executor made of host values it had not copied before),
  ``kernel_builds`` (CUDA sources compiled by ``ops/_build.build_all``),
  ``bottleneck_blocks`` (residual bottleneck blocks run through the
  executor's fused chains, ``ops/bottleneck.fused_bottlenecks``),
  ``blaze_blocks`` (BlazeBlocks with a pooled or channel-padded residual
  run through ``ops/blaze_block.fused_blaze_block``, 11 a BlazeFace short
  range forward, 6 a Face Mesh V1 forward), ``entry_blocks`` (stride-2
  residual bottleneck blocks run through ``ops/entry_block.fused_entry_block``,
  6 a Face Mesh V2 forward, 6 an iris forward), ``eye_crops`` (eye crops the
  iris network ran on, two a stream a step) and ``launches.<kernel>``
  (launches of each hand-written CUDA kernel, counted as the host issues
  them: ``blaze_stage``, ``blaze_stage_nhwc``, ``bottleneck_stage``,
  ``blaze_block``, ``entry_block``, ``letterbox_sample``, ``rotated_sample``,
  ``rgb_to_yuv``; only on a GPU, so 0 on the CPU).
- :func:`reset`: zeroes the counters.

The spans of a tracker step (``pipeline/face_cascade.py``): ``zaru.step``
around ``zaru.detect`` (``.sample``, ``.net``, ``.tail``),
``zaru.track``'s ``.sample``, ``.net`` and ``.tail`` and, with iris,
``zaru.iris``'s ``.sample``, ``.net`` and ``.tail``; ``zaru.sync.<site>``
around each host sync (:func:`sync`); ``zaru.build.kernels`` and
``zaru.build.host_copy`` where the step builds something it keeps;
``zaru.net.bottleneck`` around each fused chain of bottleneck blocks in a
network (``ops/bottleneck.fused_bottlenecks``) and ``zaru.net.blaze_block``
around each fused BlazeBlock (``ops/blaze_block.fused_blaze_block``) and
``zaru.net.entry_block`` around each fused entry block
(``ops/entry_block.fused_entry_block``). The
serve loop adds ``zaru.serve.stage``, ``zaru.serve.flush``,
``zaru.sync.emit`` and ``zaru.serve.gather``.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.autograd.profiler as _profiler

__all__ = ["annotate", "counters", "reset", "span", "sync", "trace"]

counters = {"steps": 0, "detect_steps": 0, "host_syncs": 0, "host_copies": 0, "kernel_builds": 0,
            "bottleneck_blocks": 0, "blaze_blocks": 0, "entry_blocks": 0, "eye_crops": 0, "launches.blaze_stage": 0,
            "launches.blaze_stage_nhwc": 0, "launches.bottleneck_stage": 0, "launches.blaze_block": 0,
            "launches.entry_block": 0, "launches.letterbox_sample": 0, "launches.rotated_sample": 0,
            "launches.rgb_to_yuv": 0}


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


class _Off:
    """The span while no profiler runs: enters and leaves, nothing else
    (a few tens of nanoseconds cheaper than ``contextlib.nullcontext``)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        pass


_OFF = _Off()


def span(name: str):
    """A named range of the program, as a context manager: while no
    profiler runs a shared no-op (one flag check), under a
    ``torch.profiler`` profile ``record_function(name)``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)


annotate = span  # the older name


def sync(name: str):
    """:func:`span` around a host sync of the step path (``name``
    ``zaru.sync.<site>``), counted in ``counters["host_syncs"]``."""
    counters["host_syncs"] += 1
    return span(name)


def reset() -> None:
    """Zeroes :data:`counters`."""
    for key in counters:
        counters[key] = 0
