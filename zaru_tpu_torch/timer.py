"""Profiling timers: the port's own copy of zaru_tpu/timer.py (reference:
crates/zaru/src/timer.rs).

`Timer` keeps an EMA-smoothed running average of timed spans (the video
file source times its decodes with one), mirroring the reference's
observability surface (timer.rs:22-98). `FpsCounter` logs FPS plus timer
summaries once per second (timer.rs:112-175).

A span that launches work on the GPU returns before the work ends: read a
result back to the host (or ``torch.cuda.synchronize()``) before the span
closes, or the timer measures the launches only.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

from .filters import Ema, SimpleFilter

log = logging.getLogger(__name__)


class Timer:
    """EMA-averaged span timer (timer.rs:22-98). Displaying the timer resets
    its state, like the reference's `Display` impl."""

    def __init__(self, name: str, alpha: float = 0.3):
        self._name = name
        self._filter = SimpleFilter(Ema(alpha))
        self._ms = None

    @property
    def name(self) -> str:
        return self._name

    @contextmanager
    def measure(self):
        start = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - start) * 1e3
            self._ms = float(self._filter.filter(ms))

    def time(self, f):
        """Times `f()` and returns its result (timer.rs:51)."""
        with self.measure():
            return f()

    def average_ms(self) -> float | None:
        return self._ms

    def __str__(self) -> str:
        ms = self._ms
        self._filter.reset_state()
        self._ms = None
        if ms is None:
            return f"{self._name}: -"
        return f"{self._name}: {ms:.01f}ms"


class FpsCounter:
    """Frames-per-second counter that logs once per second
    (timer.rs:112-175)."""

    def __init__(self, name: str):
        self._name = name
        self._frames = 0
        self._start = time.monotonic()

    def tick(self) -> None:
        self.tick_with(())

    def tick_with(self, timers) -> None:
        self._frames += 1
        now = time.monotonic()
        elapsed = now - self._start
        if elapsed >= 1.0:
            fps = self._frames / elapsed
            extra = " ".join(str(t) for t in timers)
            log.debug("%s: %.1f FPS%s", self._name, fps, f" ({extra})" if extra else "")
            self._frames = 0
            self._start = now
