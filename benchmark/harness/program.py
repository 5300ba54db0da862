"""The system under test, built from a configuration's ``program`` and
``tracker`` sections: the port's tracker with its detector and landmark
network, each named by its dotted path in ``zaru_tpu_torch``, and the
tracker's further keyword arguments from ``program.options`` (for example
``{"iris": true}``), passed through as they stand.

``program.wrap`` (``{"class": dotted path, "options": {...}}``), where a
configuration has it, names a class that wraps the tracker (for example an
identifier of the tracked faces): the system under test is then
``cls(tracker, compute_dtype=..., device=..., **options)``. Either way the
loops drive what :func:`build` returns through its ``init_state`` and
``step_batch``."""

from __future__ import annotations

import importlib

import torch

__all__ = ["build", "control_dtype"]


def _load(dotted: str):
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(module), name)


def control_dtype(config: dict):
    """The program's own lower-precision path, the control of ``correct``."""
    return getattr(torch, config["program"]["control_dtype"])


def build(config: dict, device, compute_dtype=None):
    """The tracker of ``config`` on ``device``, in its ``program.wrap``
    where the configuration names one; ``compute_dtype`` switches the
    networks' bodies to that precision (None: the configuration's
    float32)."""
    tracker = _tracker(config, device, compute_dtype)
    wrap = config["program"].get("wrap")
    if wrap is None:
        return tracker
    return _load(wrap["class"])(tracker, compute_dtype=compute_dtype, device=device, **wrap.get("options", {}))


def _tracker(config: dict, device, compute_dtype):
    p, t = config["program"], config["tracker"]
    f = t["one_euro"]
    return _load(p["tracker"])(
        _load(p["detector"])(compute_dtype, device=device),
        _load(p["landmarker"])(compute_dtype, device=device),
        detection_threshold=t["detection_threshold"],
        loss_threshold=t["loss_threshold"],
        roi_padding=t["roi_padding"],
        smooth=_load(p["filter"])(f["min_cutoff"], f["beta"], f["d_cutoff"]),
        frame_rate=t["frame_rate"],
        device=device,
        **p.get("options", {}),
    )
