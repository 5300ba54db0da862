"""What the per-layer readers share: the profiled steps' work, counted by
the benchmark (:mod:`benchmark.work`), and sums over the profiled span.

The networks a step runs: the configuration's ``detector`` on detect steps,
its ``landmarker`` on every step, and each of its further ``networks``
(``{"name", "file", "crops", "steps"}``: ``crops`` forwards a stream,
``steps`` ``"every"`` or ``"detect"``).

A reader gets a :class:`Run` and returns its number, or None where it finds
nothing to read: no traced span, no device activity in it, no kernel of
its kind, or a card whose peaks the table does not hold.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from ..work import networks
from . import trace

__all__ = ["PEAKS", "Run", "idle_share", "kernel_seconds", "network_flops", "stage_bound_seconds"]

# Published peaks (NVIDIA's H100 data sheet, SXM part, dense, at 700 W):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
}


@dataclass
class Run:
    config: dict
    window: object  # loops.Window
    span: trace.Span | None
    device_kind: str
    model_dir: Path

    @property
    def peaks(self) -> dict | None:
        return PEAKS.get(self.device_kind)

    def model(self, part: str) -> str:
        return str(self.model_dir / self.config[part]["file"])

    def networks(self) -> list:
        """``(model file, forwards a stream, detect steps only)`` of each
        network the program runs."""
        found = [(self.model("detector"), 1, True), (self.model("landmarker"), 1, False)]
        for net in self.config.get("networks", []):
            if net["steps"] not in ("every", "detect"):
                raise ValueError(f"network {net['name']!r}: steps is {net['steps']!r}, not 'every' or 'detect'")
            found.append((str(self.model_dir / net["file"]), net["crops"], net["steps"] == "detect"))
        return found

    def over_steps(self, per_frame, profiled=None):
        """``per_frame(model file)`` summed over the forwards of the
        profiled steps (or of ``profiled``, entries of :meth:`profiled`)."""
        nets = self.networks()
        every = sum(crops * per_frame(path) for path, crops, detect_only in nets if not detect_only)
        detect = sum(crops * per_frame(path) for path, crops, detect_only in nets if detect_only)
        steps = self.profiled() if profiled is None else profiled
        return sum(n * (every + (detect if detected else 0)) for n, detected in steps)

    def profiled(self) -> list:
        """``(frames, detected)`` of each profiled step: a step detects when
        it was forced or some stream came in not tracking."""
        return [(n, bool(forced) or not bool(tracking.reshape(-1).all()))
                for n, tracking, forced in self.window.profiled]

    def device_busy(self) -> bool:
        return self.span is not None and bool(self.span.device)


def kernel_seconds(span, include=(), exclude=()) -> float:
    """Summed time of the span's kernels whose name holds one of
    ``include`` (every kernel when empty) and none of ``exclude``."""
    return sum(iv.seconds for iv in span.kernels()
               if (not include or any(p in iv.name for p in include))
               and not any(p in iv.name for p in exclude))


def idle_share(run: Run) -> float | None:
    """Per cent of the span with no kernel or copy on the card."""
    if not run.device_busy():
        return None
    return 100.0 * (1.0 - trace.union_seconds(run.span.device) / run.span.seconds)


def network_flops(run: Run) -> int:
    """The networks' operations for the frames the profiled steps ran."""
    return run.over_steps(networks.flops)


def stage_bound_seconds(run: Run) -> float:
    """The least time the profiled steps' stride-1 BlazeBlock chains could
    take: per chain and frame, the larger of its operations over the
    float32 peak and its input read once plus its output written once
    (float32) over the memory bandwidth."""
    p = run.peaks

    def per_frame(path):
        total = 0.0
        for c, h, w, blocks in networks.stage_chains(path):
            ops = blocks * networks.block_ops(c, h, w)
            nbytes = 2 * 4 * c * h * w
            total += max(ops / p["f32_flops"], nbytes / p["bytes_per_s"])
        return total

    return run.over_steps(per_frame)
