"""The comparison that decides ``correct``.

Each kept step of the window (its state in, its outputs and its state out,
all the program's own) is run again by the plain reference from the same
state in and the same frames, in blocks of streams, once the window has
closed. The gate's choice is the program's rule read from that state:
detect when the step was forced or some stream was not tracking.

Numbers read, each the largest over the kept steps (:data:`NUMBERS`: each
name, the outputs both sides have to give for it, and how it is read from
the program's and the reference's outputs and state out); a cell compares
those its limits file (``benchmark/limits/<cell>.json``) lists, each
against its limit:

- ``landmarks_px``: landmark coordinates, image pixels;
- ``roi_px``: the corners of the next ROI (output and state), image pixels;
- ``confidence``: the face flag after its sigmoid;
- ``filter_dx``: the 1€ filter's derivative state, network pixels a second;
- ``flags``: mismatched booleans (``valid``, the state's ``tracking`` and
  the filter's ``init``), held to 0;
- ``eyes_px``: the eyes' landmark coordinates (``eyes``), image pixels;
  read only where both sides give ``eyes``;
- ``embedding``: the largest absolute difference of any component of the
  unit embeddings (``embedding [B,D]``) of every stream the step embeds;
  read only where both sides give ``embedding``;
- ``identity``: mismatched gallery rows (``identity [B]``, -1 for none) of
  the streams valid on both sides, counted only where the reference's
  decision is clear: where its ``identity_margin`` (the smaller of half the
  gap between its best and second-best distance and the distance from its
  best to the threshold; ``inf`` with fewer than two rows) exceeds the
  stream's ``‖e_program − e_reference‖₂`` by more than
  :data:`DISTANCE_ROUNDING`. No distance moves by more than that norm, so
  a flip outside the margin is a fault, not rounding. Held to 0; read only
  where both sides give ``identity`` and ``embedding`` and the reference
  its margin.

A limits file that names a number the cell's outputs cannot give is an
error, not a 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

__all__ = ["DISTANCE_ROUNDING", "NUMBERS", "Number", "compare", "judge"]

# What float32 rounding can move a distance between unit embeddings of 128
# or so components, on either side, beyond the embeddings' own gap: about
# 1e-6 in practice and 3e-5 at worst (a sum of D squares rounded D times);
# far below a real flip's margin.
DISTANCE_ROUNDING = 1e-4


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


@dataclass(frozen=True)
class Number:
    needs: tuple  # the outputs both sides have to give
    read: Callable  # (program, reference) → float; each side {"out": ..., "state": ...}, one block of streams
    reference_needs: tuple = ()  # the outputs the reference alone has to give


def _out_gap(key):
    return lambda p, r: _gap(p["out"][key], r["out"][key])


def _roi(p, r) -> float:
    return max(_gap(_corners(p["out"]["roi"]), _corners(r["out"]["roi"])),
               _gap(_corners(p["state"]["roi"]), _corners(r["state"]["roi"])))


def _flags(p, r) -> float:
    return float(int((p["out"]["valid"] != r["out"]["valid"]).sum())
                 + int((p["state"]["tracking"] != r["state"]["tracking"]).sum())
                 + int((p["state"]["filter"]["init"] != r["state"]["filter"]["init"]).sum()))


def _identity(p, r) -> float:
    po, ro = p["out"], r["out"]
    gap = torch.linalg.vector_norm(po["embedding"].float() - ro["embedding"].float(), dim=-1)
    clear = ro["identity_margin"] > gap + DISTANCE_ROUNDING
    flipped = po["identity"].long() != ro["identity"].long()
    return float(int((flipped & po["valid"] & ro["valid"] & clear).sum()))


NUMBERS = {
    "landmarks_px": Number(("landmarks",), _out_gap("landmarks")),
    "roi_px": Number(("roi",), _roi),
    "confidence": Number(("confidence",), _out_gap("confidence")),
    "filter_dx": Number((), lambda p, r: _gap(p["state"]["filter"]["dx"], r["state"]["filter"]["dx"])),
    "flags": Number(("valid",), _flags),
    "eyes_px": Number(("eyes",), _out_gap("eyes")),
    "embedding": Number(("embedding",), _out_gap("embedding")),
    "identity": Number(("identity", "embedding", "valid"), _identity, ("identity_margin",)),
}


def compare(reference, kept: list, frames_of, exact: bool, single: bool, rows: int, device) -> dict:
    """The numbers over the kept steps ``[(t, record), ...]`` that both
    sides' outputs give; ``frames_of(a, b)`` gives streams ``a:b`` of the
    frames as a device tensor."""
    worst = {}
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
            program = {"out": {k: v[a:b].to(device) for k, v in out.items()},
                       "state": {"roi": s_out["roi"][a:b].to(device), "tracking": s_out["tracking"][a:b].to(device),
                                 "filter": {k: v[a:b].to(device) for k, v in s_out["filter"].items()}}}
            ref = {"out": r_out, "state": r_state}
            for k, number in NUMBERS.items():
                if all(n in program["out"] and n in r_out for n in number.needs) \
                        and all(n in r_out for n in number.reference_needs):
                    v = number.read(program, ref)
                    worst[k] = v if np.isnan(v) else max(worst.get(k, 0.0), v)
    return worst


def judge(numbers: dict, limits: dict | None) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers ``limits``
    lists: correct when each is within its limit (a NaN never is); without
    limits nothing is correct."""
    if not limits:
        return False, {k: {"value": v, "limit": None} for k, v in numbers.items()}
    missing = [k for k in limits if k not in numbers]
    if missing:
        raise KeyError(f"the limits name {', '.join(missing)}, which this cell's outputs do not give")
    checks = {k: {"value": numbers[k], "limit": lim["limit"]} for k, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
