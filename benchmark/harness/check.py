"""The comparison that decides ``correct``.

Each kept step of the window (its state in, its outputs and its state out,
all the program's own) is run again by the plain reference from the same
state in and the same frames, in blocks of streams, once the window has
closed. The gate's choice is the program's rule read from that state:
detect when the step was forced or some stream was not tracking.

Numbers read, each the largest over the kept steps; a cell compares those
its limits file (``benchmark/limits/<cell>.json``) lists, each against its
limit:

- ``landmarks_px``: landmark coordinates, image pixels;
- ``roi_px``: the corners of the next ROI (output and state), image pixels;
- ``confidence``: the face flag after its sigmoid;
- ``filter_dx``: the 1€ filter's derivative state, network pixels a second;
- ``flags``: mismatched booleans (``valid``, the state's ``tracking`` and
  the filter's ``init``), held to 0.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NUMBERS", "compare", "judge"]

NUMBERS = ("landmarks_px", "roi_px", "confidence", "filter_dx", "flags")


def _corners(roi):
    """``[B,5]`` rotated rects → ``[B,4,2]`` corners."""
    half = roi[:, 2:4, None] * 0.5 * torch.tensor([[-1.0, 1.0, 1.0, -1.0], [-1.0, -1.0, 1.0, 1.0]],
                                                  device=roi.device)
    c, s = torch.cos(roi[:, 4:5]), torch.sin(roi[:, 4:5])
    x = c * half[:, 0] - s * half[:, 1]
    y = s * half[:, 0] + c * half[:, 1]
    return torch.stack([x, y], dim=-1) + roi[:, None, 0:2]


def _batched(tree):
    if isinstance(tree, dict):
        return {k: _batched(v) for k, v in tree.items()}
    return tree[None]


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def compare(reference, kept: list, frames_of, exact: bool, single: bool, rows: int, device) -> dict:
    """The numbers over the kept steps ``[(t, record), ...]``; ``frames_of(a,
    b)`` gives streams ``a:b`` of the frames as a device tensor."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for _t, rec in kept:
        s_in, out, s_out = rec["state_in"], rec["out"], rec["state_out"]
        if single:
            s_in, out, s_out = _batched(s_in), _batched(out), _batched(s_out)
        tracking = s_in["tracking"].to(device)
        detect = bool(rec["detect"]) or not bool(tracking.all())
        for a in range(0, tracking.shape[0], rows):
            b = min(a + rows, tracking.shape[0])
            part = {"roi": s_in["roi"][a:b].to(device), "tracking": tracking[a:b],
                    "filter": {k: v[a:b].to(device) for k, v in s_in["filter"].items()}}
            r_state, r_out = reference.step(part, frames_of(a, b), detect, exact)
            o = {k: v[a:b].to(device) for k, v in out.items()}
            f = {k: v[a:b].to(device) for k, v in s_out["filter"].items()}
            numbers = {
                "landmarks_px": _gap(o["landmarks"], r_out["landmarks"]),
                "roi_px": max(_gap(_corners(o["roi"]), _corners(r_out["roi"])),
                              _gap(_corners(s_out["roi"][a:b].to(device)), _corners(r_state["roi"]))),
                "confidence": _gap(o["confidence"], r_out["confidence"]),
                "filter_dx": _gap(f["dx"], r_state["filter"]["dx"]),
                "flags": float(int((o["valid"] != r_out["valid"]).sum())
                               + int((s_out["tracking"][a:b].to(device) != r_state["tracking"]).sum())
                               + int((f["init"] != r_state["filter"]["init"]).sum())),
            }
            for k, v in numbers.items():
                worst[k] = v if np.isnan(v) else max(worst[k], v)
    return worst


def judge(numbers: dict, limits: dict | None) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers ``limits``
    lists: correct when each is within its limit (a NaN never is); without
    limits nothing is correct."""
    if not limits:
        return False, {k: {"value": v, "limit": None} for k, v in numbers.items()}
    checks = {k: {"value": numbers[k], "limit": lim["limit"]} for k, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
