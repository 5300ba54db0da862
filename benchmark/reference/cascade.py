"""The plain reference of the face cascade: one tracker step for a batch of
streams, in float32 PyTorch, from the model files and a configuration's
numbers alone.

A step (``Cascade.step``):

- **gate**: a step detects when it is forced or some stream is not
  tracking; tracked streams keep their carried ROI either way;
- **detect**: the letterbox view of the whole frame at the detector's
  aspect (or, ``exact``, the same view through the exact rotated sampler),
  BlazeFace, SSD decode over the anchors, weighted non-maximum suppression
  keeping the best detection, its box back in the image → the seed ROI of
  each lost stream (angle 0);
- **track**: the ROI grown to the landmark network's aspect, the rotated
  crop (prescaled, or ``exact``), the landmark network, the landmarks and
  the face flag decoded, the 1€ filter in network pixels (reset for freshly
  seeded streams), the landmarks rotated back into the image, the next ROI
  as their rotated bounding box at the eye-corner angle, grown by the
  padding; a stream whose face flag falls below the loss threshold, or that
  no detection found, is no longer tracking.

State: ``roi [B,5]`` (cx, cy, w, h, radians), ``tracking [B]``, and the
filter's ``x``, ``dx``, ``init`` ``[B,N,3]``. Outputs: ``landmarks [B,N,3]``
in image pixels, ``confidence [B]``, ``roi [B,5]``, ``valid [B]``.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from . import samplers
from .graph import Graph
from .samplers import div

__all__ = ["Cascade"]


# --- geometry: rects [...,4] (cx, cy, w, h), rotated rects [...,5] ---------

def _grow_to_aspect(rect, aspect: float):
    w, h = rect[..., 2], rect[..., 3]
    target_w = h * aspect
    wide = target_w >= w
    return torch.stack([rect[..., 0], rect[..., 1], torch.where(wide, target_w, w),
                        torch.where(wide, h, div(w, aspect))], dim=-1)


def _grow_rel(rect, amount: float):
    return torch.cat([rect[..., 0:2], rect[..., 2:4] + rect[..., 2:4] * (2.0 * amount)], dim=-1)


def _rotate_cw(pt, rad):
    c, s = torch.cos(rad), torch.sin(rad)
    x, y = pt[..., 0], pt[..., 1]
    return torch.stack([c * x + s * y, -s * x + c * y], dim=-1)


def _rotate_ccw(pt, rad):
    c, s = torch.cos(rad), torch.sin(rad)
    x, y = pt[..., 0], pt[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def _transform_out(rrect, pt):
    center = rrect[..., 2:4] * 0.5
    return _rotate_ccw(pt - center, rrect[..., 4]) + center + (rrect[..., 0:2] - center)


def _bounding(rad, points):
    rot = _rotate_cw(points, rad[..., None])
    mn, mx = torch.amin(rot, dim=-2), torch.amax(rot, dim=-2)
    center = _rotate_ccw((mn + mx) * 0.5, rad)
    size = mx - mn
    return torch.stack([center[..., 0], center[..., 1], size[..., 0], size[..., 1], rad], dim=-1)


def _iou(a, b):
    a_tl, b_tl = a[..., 0:2] - a[..., 2:4] * 0.5, b[..., 0:2] - b[..., 2:4] * 0.5
    lo = torch.maximum(a_tl, b_tl)
    hi = torch.minimum(a_tl + a[..., 2:4], b_tl + b[..., 2:4])
    wh = hi - lo
    empty = (wh[..., 0] < 0) | (wh[..., 1] < 0)
    inter = torch.where(empty, torch.zeros_like(wh[..., 0]), wh[..., 0] * wh[..., 1])
    return inter / (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter)


def _anchors(layers) -> np.ndarray:
    """SSD anchor centres in 0..1: ``[boxes per cell, width, height]`` per
    layer, x fastest, each cell's boxes together."""
    rows = []
    for per_cell, w, h in layers:
        ys, xs = np.mgrid[0:h, 0:w]
        cell = np.stack([(xs.ravel() + 0.5) / w, (ys.ravel() + 0.5) / h], axis=-1)
        rows.append(np.repeat(cell, per_cell, axis=0))
    return np.concatenate(rows).astype(np.float32)


class _Filter:
    """The 1€ filter on tensors, one step of ``elapsed`` seconds."""

    def __init__(self, min_cutoff: float, beta: float, d_cutoff: float):
        self.min_cutoff, self.beta, self.d_cutoff = min_cutoff, beta, d_cutoff

    @staticmethod
    def _alpha(t_e, cutoff):
        r = 2.0 * math.pi * cutoff * t_e
        return r / (r + 1.0)

    def __call__(self, state, value, elapsed: float):
        a_d = self._alpha(elapsed, self.d_cutoff)
        dx = div(value - state["x"], elapsed)
        dx_hat = a_d * dx + (1.0 - a_d) * state["dx"]
        a = self._alpha(elapsed, self.min_cutoff + self.beta * torch.abs(dx_hat))
        x_hat = a * value + (1.0 - a) * state["x"]
        out = torch.where(state["init"], x_hat, value)
        return {"x": out, "dx": torch.where(state["init"], dx_hat, torch.zeros_like(dx_hat)),
                "init": torch.ones_like(state["init"])}, out


class Cascade:
    """The reference cascade of a configuration (its ``detector``,
    ``landmarker`` and ``tracker`` sections) on ``device``; the networks are
    read from ``model_dir``."""

    def __init__(self, config: dict, model_dir: str | Path, device="cpu"):
        det, lm, tr = config["detector"], config["landmarker"], config["tracker"]
        self.device = torch.device(device)
        self.det_net = Graph(Path(model_dir) / det["file"], self.device)
        self.lm_net = Graph(Path(model_dir) / lm["file"], self.device)
        self.det_w, self.det_h = det["input"]
        self.lm_w, self.lm_h = lm["input"]
        self.det_range = det["color_range"]
        self.lm_range = lm["color_range"]
        self.num_landmarks = lm["num_landmarks"]
        self.eye_corners = lm["eye_corners"]
        self.anchors = torch.from_numpy(_anchors(det["anchors"])).to(self.device)
        self.det_thresh = tr["detection_threshold"]
        self.loss_thresh = tr["loss_threshold"]
        self.iou_thresh = tr["nms_iou_threshold"]
        self.padding = tr["roi_padding"]
        self.prescale_m = tr["prescale_m"]
        self.elapsed = 1.0 / tr["frame_rate"]
        f = tr["one_euro"]
        self.filter = _Filter(f["min_cutoff"], f["beta"], f["d_cutoff"])

    @staticmethod
    def _aspect(w: int, h: int) -> float:
        return float(np.float32(w) / np.float32(h))

    # --- detect ---------------------------------------------------------

    def detect(self, frames, exact: bool):
        """``frames [B,H,W,4] u8`` → (rois [B,5], found [B])."""
        B, H, W, _ = frames.shape
        full = torch.tensor([W / 2.0, H / 2.0, float(W), float(H)], dtype=torch.float32, device=frames.device)
        fit = _grow_to_aspect(full, self._aspect(self.det_w, self.det_h))
        rects = torch.cat([fit, torch.zeros(1, dtype=torch.float32, device=frames.device)]).expand(B, 5)
        sample = samplers.rotated_exact if exact else samplers.letterbox
        x = sample(frames, rects.contiguous(), self.det_w, self.det_h, *self.det_range)
        raw_boxes, raw_conf = self.det_net(x)
        n = self.anchors.shape[0]
        conf = torch.sigmoid(raw_conf.reshape(B, n))
        conf = torch.where(conf >= self.det_thresh, conf, 0.0)
        anchor_px = torch.stack([self.anchors[:, 0] * float(self.det_w),
                                 self.anchors[:, 1] * float(self.det_h)], dim=-1)
        bp = raw_boxes.reshape(B, n, -1)
        boxes = torch.cat([bp[..., 0:2] + anchor_px, bp[..., 2:4]], dim=-1)
        # Weighted NMS, first output slot: the best detection's box averaged
        # with every detection overlapping it, weighted by confidence.
        seed = torch.argmax(conf, dim=-1, keepdim=True)
        found = torch.gather(conf, -1, seed)[:, 0] > 0.0
        seed_box = torch.gather(boxes, -2, seed[..., None].expand(B, 1, 4))
        over = (_iou(seed_box, boxes) >= self.iou_thresh) & (conf > 0.0)
        w = torch.where(over, conf, 0.0)
        divisor = torch.clamp_min(torch.sum(w, dim=-1), 1e-20)
        box = torch.sum(w[..., None] * boxes, dim=-2) / divisor[..., None]
        box = box * found.to(box.dtype)[:, None]
        # Back into the image through the letterbox fit.
        scale = div(fit[2:3], float(self.det_w))
        top_left = fit[0:2] - fit[2:4] * 0.5
        rect = torch.cat([box[:, 0:2] * scale + top_left, box[:, 2:4] * scale], dim=-1)
        return torch.cat([rect, torch.zeros_like(rect[:, :1])], dim=-1), found

    # --- track ----------------------------------------------------------

    def track(self, fstate, frames, rois, founds, seeded, exact: bool):
        view = torch.cat([_grow_to_aspect(rois[:, 0:4], self._aspect(self.lm_w, self.lm_h)), rois[:, 4:5]], dim=-1)
        if exact:
            x = samplers.rotated_exact(frames, view, self.lm_w, self.lm_h, *self.lm_range)
        else:
            x = samplers.rotated_prescaled(frames, view, self.lm_w, self.lm_h, *self.lm_range, self.prescale_m)
        outputs = self.lm_net(x)
        B = x.shape[0]
        coords = outputs[0].reshape(B, -1, 3)[:, : self.num_landmarks]
        conf = torch.sigmoid(outputs[1].reshape(B))
        fstate = {k: torch.where(seeded.reshape(-1, 1, 1), torch.zeros_like(s), s) for k, s in fstate.items()}
        fstate, coords = self.filter(fstate, coords, self.elapsed)
        scale = div(view[:, 2:3], float(self.lm_w))[:, None, :]
        xy_view = coords[..., 0:2] * scale
        pos = torch.cat([_transform_out(view[:, None, :], xy_view), coords[..., 2:3] * scale], dim=-1)
        left, right = self.eye_corners
        ltr = xy_view[:, right] - xy_view[:, left]
        angle = view[:, 4] + torch.atan2(ltr[..., 1], ltr[..., 0])
        box = _bounding(angle, pos[..., 0:2])
        new_roi = torch.cat([_grow_rel(box[..., 0:4], self.padding), box[..., 4:5]], dim=-1)
        valid = (conf >= self.loss_thresh) & founds
        state = {"roi": new_roi, "tracking": valid, "filter": fstate}
        return state, {"landmarks": pos, "confidence": conf, "roi": new_roi, "valid": valid}

    # --- step -----------------------------------------------------------

    @torch.inference_mode()
    def step(self, state: dict, frames, detect: bool, exact: bool = False):
        """One step from ``state`` for ``frames [B,H,W,4] u8``; ``detect``
        is the gate's choice (forced, or some stream of the whole batch not
        tracking), which the caller makes over the whole batch when it
        runs the reference in blocks of streams."""
        roi, tr = state["roi"], state["tracking"]
        if detect:
            det_rois, det_found = self.detect(frames, exact)
            rois, founds, seeded = torch.where(tr[:, None], roi, det_rois), tr | det_found, ~tr
        else:
            rois, founds, seeded = roi, torch.ones_like(tr), torch.zeros_like(tr)
        return self.track(state["filter"], frames, rois, founds, seeded, exact)
