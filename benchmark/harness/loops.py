"""The two generic loops a traffic mix names with ``"loop"``.

- ``track``: ``streams`` frames held on the device, ``step_batch`` at the
  production cadence (detection forced on every ``detect_every``-th step
  from the first), outputs left on the device; a step's time is the gap
  between consecutive step completions on the device, read from a CUDA
  event after each step once the window has ended.
- ``serve``: ``streams`` in-memory sources of host frames through the
  program's ``serve_loop`` (``StreamSet`` → ``FrameUploader`` → the gated
  step, or ``run_frame`` when ``single``), outputs read to the host every
  step; a step's time is the loop's period on the host clock, from one
  step's outputs on the host to the next.

Both start the window from a fresh state, so its first step detects every
stream, and keep some steps for the correctness check (:class:`Kept`).
With a :class:`~.trace.Profiler`, a span of whole steps inside the window
is profiled: ``profile.from`` and ``profile.steps`` of the traffic.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Kept", "Window", "run_serve", "run_track", "stream_set", "uploader", "warm_serve", "warm_track"]


class Kept:
    """The steps kept for the check: the first ``always`` steps of the
    window and ``k`` more drawn uniformly from the rest by a reservoir
    seeded from the run's seed, so the window's length need not be known.
    Each record holds references to the step's own tensors: nothing is
    copied inside the window."""

    def __init__(self, seed: int, k: int, always: int = 2):
        self.rng = np.random.Generator(np.random.PCG64([seed, 1]))
        self.k, self.always = k, always
        self.first, self.pool, self.seen = [], [], 0

    def offer(self, t: int, record: dict):
        if t < self.always:
            self.first.append((t, record))
            return
        self.seen += 1
        if len(self.pool) < self.k:
            self.pool.append((t, record))
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.pool[j] = (t, record)

    def steps(self) -> list:
        return sorted(self.first + self.pool, key=lambda tr: tr[0])


@dataclass
class Window:
    seconds: float  # host clock, window start to the end of its last step
    step_s: list  # each step's time
    frames: int  # frames completed (fresh frames in a serve loop)
    attempted: int  # frames offered
    profiled: list = field(default_factory=list)  # (streams, tracking flags in, forced) of each profiled step
    counters: dict = field(default_factory=dict)  # the program's own counters over the window


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_track(program, frames, traffic):
    """Both branches at the cell's shapes: a forced detect step, then
    tracking steps."""
    state = program.init_state(frames.shape[0])
    for t in range(traffic["warmup_steps"]):
        state, _ = program.step_batch(state, frames, t == 0)
    _sync(frames.device)


def run_track(program, frames, traffic, seconds: float, kept: Kept, profiler=None) -> Window:
    dev = frames.device
    B, every = frames.shape[0], traffic["detect_every"]
    p_from, p_steps = traffic["profile"]["from"], traffic["profile"]["steps"]
    cuda = dev.type == "cuda"
    events, host_t, profiled = [], [], []
    state = program.init_state(B)
    _sync(dev)
    t0 = time.perf_counter()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t = 0
    while not (t % every == 0 and time.perf_counter() - t0 >= seconds
               and (profiler is None or profiler.done)):
        if profiler is not None and t == p_from:
            _sync(dev)
            profiler.start()
        forced = t % every == 0
        state_in = state
        state, out = program.step_batch(state, frames, forced)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            host_t.append(time.perf_counter())
        kept.offer(t, {"state_in": state_in, "out": out, "state_out": state, "detect": forced})
        if profiler is not None and p_from <= t < p_from + p_steps:
            profiled.append((B, state_in["tracking"], forced))
        t += 1
        if profiler is not None and t == p_from + p_steps:
            _sync(dev)
            profiler.stop()
    _sync(dev)
    seconds_run = time.perf_counter() - t0
    if cuda:
        marks = [start, *events]
        step_s = [a.elapsed_time(b) * 1e-3 for a, b in zip(marks, marks[1:])]
    else:
        step_s = list(np.diff([t0, *host_t]))
    return Window(seconds_run, step_s, B * t, B * t, profiled)


class _Proxy:
    """The tracker as ``serve_loop`` sees it, passing every call through and
    keeping each step's state and outputs (references, no copies)."""

    def __init__(self, tracker, on_step=None):
        self.tracker, self.on_step, self.t = tracker, on_step, 0

    def init_state(self, batch=None):
        return self.tracker.init_state(batch) if batch else self.tracker.init_state()

    def _step(self, fn, state, frames):
        state_out, out = fn(state, frames)
        if self.on_step is not None:
            self.on_step(self.t, {"state_in": state, "out": out, "state_out": state_out, "detect": False})
        self.t += 1
        return state_out, out

    def run_frames_gated(self, state, frames):
        return self._step(self.tracker.run_frames_gated, state, frames)

    def run_frame(self, state, frame):
        return self._step(self.tracker.run_frame, state, frame)


def stream_set(host_frames):
    """A primed ``StreamSet`` of in-memory sources, each serving its own
    host frame for ever."""
    from zaru_tpu_torch.serve import StreamSet

    streams = StreamSet([(lambda f=f: itertools.repeat(f)) for f in host_frames])
    streams.prime()
    return streams


def uploader(streams: int, shape, device):
    from zaru_tpu_torch.pipeline.ingest import FrameUploader

    return FrameUploader(streams, shape, device=device)


def _serve(program, streams, uploader, traffic, **kw):
    from zaru_tpu_torch.serve import serve_loop

    return serve_loop(program, streams, uploader, single=traffic["single"],
                      decode_wait=traffic["decode_wait"], report_every=1 << 30, **kw)


def warm_serve(program, streams, uploader, traffic):
    _serve(_Proxy(program), streams, uploader, traffic, steps=traffic["warmup_steps"], emit=lambda rec, out: None)
    _sync(uploader.device)


def run_serve(program, streams, uploader, traffic, seconds: float, kept: Kept, profiler=None) -> Window:
    p_from, p_steps = traffic["profile"]["from"], traffic["profile"]["steps"]
    emits, states = [], {}

    def on_step(t, record):
        kept.offer(t, record)
        if profiler is not None and p_from < t <= p_from + p_steps:
            states[t] = record["state_in"]["tracking"]

    def emit(rec, out):
        emits.append(time.perf_counter())
        n = len(emits)  # the steps whose outputs are on the host
        if profiler is not None and n == p_from + 1:
            profiler.start()
        if profiler is not None and n == p_from + p_steps + 1:
            profiler.stop()

    proxy = _Proxy(program, on_step)
    ingest0 = uploader.stage_seconds + uploader.flush_seconds
    drops0 = sum(streams.drops)
    t0 = time.perf_counter()
    stats = _serve(proxy, streams, uploader, traffic, steps=0, soak=seconds, emit=emit)
    seconds_run = time.perf_counter() - t0
    if profiler is not None and len(emits) > p_from and not profiler.done:
        profiler.stop()  # the window ended inside the span
    step_s = list(np.diff([t0, *emits]))
    n = streams.slots
    profiled = [(n, states[t], False) for t in sorted(states)]
    counters = {
        "steps": stats.steps,
        "ingest_s": uploader.stage_seconds + uploader.flush_seconds - ingest0,
        "drops": sum(streams.drops) - drops0,
    }
    return Window(seconds_run, step_s, stats.frames, stats.steps * n, profiled, counters)
