"""The plain reference of the face cascade with MediaPipe Iris (Ablavatski
et al., arXiv 2006.11341): the cascade's step
(:class:`benchmark.reference.cascade.Cascade`), then both eyes of every
stream refined by the iris network, in float32 PyTorch from the model files
and a configuration's numbers alone (its ``iris`` section; the model file
from its ``networks`` entry named ``iris``).

From the step's filtered landmarks in image pixels (``out["landmarks"]``):

- **angle**: ``atan2`` of landmark ``angle_from[1]`` minus landmark
  ``angle_from[0]`` (the eyes' outer corners, 263 and 33);
- **eye rects**: for each eye, the rotated bounding box at that angle of its
  four landmarks (``left_eye``, ``right_eye``: bottom, the two corners,
  top), grown by ``grow`` of its size on each side, then fit to the iris
  network's aspect;
- **crops**: each rect's view at the network's ``input`` size, colour-mapped
  to ``color_range``, through the prescale grid of side ``prescale_m``
  (:func:`~benchmark.reference.samplers.rotated_prescaled`; ``exact``: the
  exact sampler); an eye flagged in ``mirror`` (the right) is flipped left
  to right, since the network reads left eyes;
- **network**: the iris model on the ``2B`` crops, left eye first;
- **decode**: the points of each of ``outputs`` in order (the 5 iris points,
  then the 71 eye-contour and brow points), x of a mirrored crop taken back
  as ``width - x``, then out of the crop into the image through its rect (z
  scaled as x and y) → ``eyes [B,2,76,3]``.

Departures from MediaPipe's published iris pipeline, all the port's own:

- the eye rect is the bounding box of four mesh landmarks grown by 0.8 on
  each side, at the angle of the line between the two eyes' outer corners;
  MediaPipe's ROI comes from each eye's two corners alone (33/133,
  362/263), rotated to that eye's own corner line and scaled to a square;
- the crop is nearest-neighbour, through an integer-stride prescale grid,
  black outside the frame; MediaPipe's image-to-tensor step interpolates;
- the eyes are computed for every stream on every step, tracked or not, and
  neither smoothed nor written back into the mesh (MediaPipe refines the
  mesh's eye landmarks with the iris model's contour).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import cascade, samplers
from .cascade import _bounding, _grow_rel, _grow_to_aspect, _transform_out
from .graph import Graph
from .samplers import div

__all__ = ["Cascade", "network_file"]


def network_file(config: dict, name: str) -> str:
    """The model file of the configuration's further network ``name`` (its
    ``networks`` entry, which the work counts read too)."""
    return next(net["file"] for net in config["networks"] if net["name"] == name)


class Cascade(cascade.Cascade):
    """The reference cascade of a configuration, and its ``iris`` section's
    eyes, on ``device``; the networks are read from ``model_dir``."""

    def __init__(self, config: dict, model_dir: str | Path, device="cpu"):
        super().__init__(config, model_dir, device)
        ir = config["iris"]
        self.eye_net = Graph(Path(model_dir) / network_file(config, "iris"), self.device)
        self.eye_w, self.eye_h = ir["input"]
        self.eye_range = ir["color_range"]
        self.eye_prescale_m = ir["prescale_m"]
        self.eye_angle = ir["angle_from"]
        self.eye_points = [ir["left_eye"], ir["right_eye"]]
        self.eye_grow = ir["grow"]
        self.mirror = ir["mirror"]
        self.eye_outputs = ir["outputs"]

    def eye_rects(self, landmarks):
        """``landmarks [B,N,3]`` in image pixels → eye view rects ``[B,2,5]``,
        left eye first."""
        a, b = self.eye_angle
        v = landmarks[:, b, 0:2] - landmarks[:, a, 0:2]
        angle = torch.atan2(v[..., 1], v[..., 0])
        rects = []
        for points in self.eye_points:
            box = _bounding(angle, landmarks[:, points, 0:2])
            grown = _grow_rel(box[..., 0:4], self.eye_grow)
            fit = _grow_to_aspect(grown, self._aspect(self.eye_w, self.eye_h))
            rects.append(torch.cat([fit, box[..., 4:5]], dim=-1))
        return torch.stack(rects, dim=1)

    def eye_crops(self, frames, rects, exact: bool):
        """``frames [B,H,W,4] u8``, ``rects [B,2,5]`` → ``[B,2,3,h,w]``, the
        mirrored eyes flipped left to right."""
        crops = []
        for k, flip in enumerate(self.mirror):
            view = rects[:, k].contiguous()
            if exact:
                x = samplers.rotated_exact(frames, view, self.eye_w, self.eye_h, *self.eye_range)
            else:
                x = samplers.rotated_prescaled(frames, view, self.eye_w, self.eye_h, *self.eye_range,
                                               self.eye_prescale_m)
            crops.append(x.flip(-1) if flip else x)
        return torch.stack(crops, dim=1)

    def eyes(self, crops, rects):
        """The iris network on ``crops [B,2,3,h,w]`` of ``rects [B,2,5]`` →
        ``[B,2,P,3]`` in image pixels (``P`` the points of every output)."""
        B = crops.shape[0]
        n = 2 * B
        outputs = dict(zip(self.eye_net.output_names, self.eye_net(crops.reshape(n, *crops.shape[2:]))))
        coords = torch.cat([outputs[name].reshape(n, points, 3) for name, points in self.eye_outputs], dim=1)
        flip = torch.tensor(self.mirror, dtype=torch.bool, device=coords.device).repeat(B)
        x = torch.where(flip[:, None], float(np.float32(self.eye_w)) - coords[..., 0], coords[..., 0])
        view = rects.reshape(n, 5)
        scale = div(view[:, 2:3], float(self.eye_w))[:, None, :]
        xy = _transform_out(view[:, None, :], torch.stack([x, coords[..., 1]], dim=-1) * scale)
        pos = torch.cat([xy, coords[..., 2:3] * scale], dim=-1)
        return pos.reshape(B, 2, -1, 3)

    @torch.inference_mode()
    def step(self, state: dict, frames, detect: bool, exact: bool = False):
        """The cascade's step, and ``out["eyes"] [B,2,76,3]`` from its
        landmarks."""
        r_state, out = super().step(state, frames, detect, exact)
        rects = self.eye_rects(out["landmarks"])
        out["eyes"] = self.eyes(self.eye_crops(frames, rects, exact), rects)
        return r_state, out
