"""A run's result line: ``correct``, ``attempted``, ``failed``, the metrics,
the device, with a trace the ``breakdown``, and last the compared numbers
beside their limits (``checks``)."""

from __future__ import annotations

from pathlib import Path

import torch

from . import check, trace
from .cell import Session, p95_ms, rate
from .spec import Cell, Spec

__all__ = ["breakdown", "end_to_end", "per_layer", "result"]

TOP = 10


def end_to_end(outcome) -> dict:
    w = outcome.window
    return {
        "frames_per_s": rate(w.frames, w.seconds),
        "frame_ms_p95": p95_ms(w.step_s),
        "setup_s": outcome.setup_s,
    }


def per_layer(cell: Cell, outcome, spec: Spec) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(outcome.run)
        if value is not None:
            out[m["name"]] = value
    return out


def _label(span, start: float, end: float) -> str:
    """What the host was doing in an idle stretch of the device: the
    innermost host operation that covers its midpoint."""
    mid = 0.5 * (start + end)
    covering = [iv for iv in span.host if iv.start <= mid <= iv.end]
    if not covering:
        return "host: Python between traced ops"
    return "host: " + min(covering, key=lambda iv: iv.seconds).name


def breakdown(span) -> dict:
    """The device operations that took most time, and the longest idle
    stretches of the span, each named by what the host was doing."""
    by_name = {}
    for iv in span.device:
        by_name[iv.name] = by_name.get(iv.name, 0.0) + iv.seconds
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(trace.gaps(span.device, span.seconds), key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[_label(span, a, b), b - a] for a, b in idle]}


def result(cell: Cell, root, seed: int, seconds: float, traced: bool, t_start: float, device,
           compute_dtype=None, traffic=None) -> tuple[dict, dict]:
    """Runs ``cell`` once → (the result line as a dict, the checks)."""
    spec = Spec(root)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    session = Session(cell, Path(root), dev, compute_dtype, traffic)
    outcome = session.run(seed, seconds, traced, t_start, release=True)
    correct, checks = check.judge(outcome.numbers, cell.limits)
    names = {m["name"] for m in cell.end_to_end}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = per_layer(cell, outcome, spec) if traced else {
        k: v for k, v in end_to_end(outcome).items() if k in names}
    w = outcome.window
    out = {
        "correct": correct,
        "attempted": w.attempted,
        "failed": w.attempted - w.frames,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": outcome.run.device_kind,
            "count": cell.chips,
            "memory_peak_bytes": outcome.memory_peak_bytes,
        },
    }
    span = outcome.run.span
    if traced and span is not None and span.device:
        out["device"]["busy_s"] = trace.union_seconds(span.device)
        out["device"]["window_s"] = span.seconds
        out["breakdown"] = breakdown(span)
    out["streams_lost_after_first_step"] = outcome.lost_after_first
    out["setup_parts_s"] = outcome.setup_parts
    out["check_s"] = outcome.check_s
    out["checks"] = checks
    return out, checks
