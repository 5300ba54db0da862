"""One cell, end to end: set-up, the measured window, the check against the
plain reference, and the result's numbers.

:class:`Session` holds what set-up builds once (the program, with the
configuration's gallery installed where it has one, and later the
reference); :meth:`Session.run` makes a seed's frames, warms up, runs the
window and checks it. ``benchmark/run.py`` makes one session and one run;
``benchmark/calibrate.py`` reads many seeds in one session.
"""

from __future__ import annotations

import gc
import importlib
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import check, frames, gallery, loops, program, readings, trace
from .spec import Cell

__all__ = ["Outcome", "Session", "p95_ms", "rate"]

REFERENCE_ROWS = 128  # streams the reference runs at once


def p95_ms(step_s) -> float:
    """The 95th percentile of the steps' times, in milliseconds (linear
    between ranks); every frame of a step sees that step's time."""
    return float(np.percentile(np.asarray(step_s, dtype=np.float64) * 1e3, 95))


def rate(frames_done: int, seconds: float) -> float:
    return frames_done / seconds


@dataclass
class Outcome:
    window: loops.Window
    numbers: dict  # the compared numbers
    lost_after_first: int  # streams not valid after the window's first step
    run: readings.Run  # what the per-layer readers read
    memory_peak_bytes: int
    setup_s: float
    setup_parts: dict  # set-up seconds by phase, the program's build until this session's first run
    check_s: float  # seconds the reference and the comparison took


class Session:
    """A cell's program on ``device``; ``compute_dtype`` switches the
    program's networks to its lower-precision path (the control)."""

    def __init__(self, cell: Cell, root: Path, device, compute_dtype=None, traffic=None):
        self.cell, self.root = cell, Path(root)
        self.device = torch.device(device)
        self.traffic = traffic or cell.traffic
        self.model_dir = self.root / "assets" / "onnx"
        t0 = time.perf_counter()
        self.program = program.build(cell.config, self.device, compute_dtype)
        if "gallery" in cell.config:
            self.program.set_gallery(*gallery.rows(cell.config, self.model_dir))
        self._built_s = time.perf_counter() - t0
        self._uploader = None
        self._bases = {}

    def _frames(self, seed: int):
        t = self.traffic
        made = frames.traffic_frames(t, seed, self.device, self._bases)
        if t["loop"] == "track":
            return made
        host = [f.numpy() for f in made.cpu()]  # pageable host memory, one array a stream
        del made
        return host

    def run(self, seed: int, seconds: float, traced: bool, t_setup0: float, reference=None,
            release: bool = False) -> Outcome:
        """Set-up from ``t_setup0`` on, the window, then the check (with
        ``reference``, else one built now). ``release``: drop the program
        before the reference runs, so the reference sets no peak."""
        t = self.traffic
        dev = self.device
        t_frames = time.perf_counter()
        data = self._frames(seed)
        t_warm = time.perf_counter()
        kept = loops.Kept(seed, t["check_steps"])
        profiler = trace.Profiler() if traced else None
        if t["loop"] == "track":
            loops.warm_track(self.program, data, t)
            t_ready = time.perf_counter()
            window = loops.run_track(self.program, data, t, seconds, kept, profiler)
        else:
            if self._uploader is None:
                self._uploader = loops.uploader(len(data), data[0].shape, dev)
            streams = loops.stream_set(data)
            loops.warm_serve(self.program, streams, self._uploader, t)
            t_ready = time.perf_counter()
            window = loops.run_serve(self.program, streams, self._uploader, t, seconds, kept, profiler)
            streams.close()
        setup_s = t_ready - t_setup0
        parts = {"program": self._built_s, "frames": t_warm - t_frames, "warm_up": t_ready - t_warm}
        parts["start"] = setup_s - sum(parts.values())  # interpreter, imports, CUDA context
        self._built_s = 0.0
        memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        span = profiler.span() if profiler is not None and profiler.done else None
        steps = kept.steps()
        first = steps[0][1]["out"]["valid"]
        lost_after_first = int((~first.reshape(-1)).sum())
        if release:
            self.program = self._uploader = None
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        t_check = time.perf_counter()
        if reference is None:
            module = importlib.import_module(f"benchmark.reference.{self.cell.config['reference']}")
            reference = module.Cascade(self.cell.config, self.model_dir, dev)
        if t["loop"] == "track":
            frames_of = lambda a, b: data[a:b]  # noqa: E731
        else:
            frames_of = lambda a, b: torch.from_numpy(np.stack(data[a:b])).to(dev)  # noqa: E731
        single = t["loop"] == "serve" and t["single"]  # run_frame: exact crops, one unbatched stream
        numbers = check.compare(reference, steps, frames_of, exact=single, single=single, rows=REFERENCE_ROWS,
                                device=dev)
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        run = readings.Run(self.cell.config, window, span, kind, self.model_dir)
        return Outcome(window, numbers, lost_after_first, run, memory_peak, setup_s, parts,
                       time.perf_counter() - t_check)
