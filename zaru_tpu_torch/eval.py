"""The equivariance sweep: end-to-end accuracy in pixels
(zaru_tpu/eval.py).

Each transform of the sweep (rotations, zooms, a shift, a combination) is a
rotated view of a fixture photo materialised at the photo's size by the
exact sampler (:func:`warp_image`). A runner finds landmarks on the photo
and on the warped frame; the warped frame's landmarks go back through the
exact inverse map (:func:`map_points_back`), and their distance to the
photo's is the deviation: mean, p95 and max in pixels per transform. The
identity transform reproduces the photo, so its deviation is 0 unless the
pipeline is not deterministic.

The runners are those of the JAX package: ``face_mesh``, ``face_mesh_v2``
and ``iris`` run ``FaceTracker(smooth=None).run_frame`` three times (the
fused single-stream cascade, whose crops the exact sampler takes and whose
CNNs run the stage kernel at batch 1); ``multipie68_peppa`` and
``multipie68_onnx`` run the host engines, a short-range
:class:`~zaru_tpu_torch.detection.Detector` seeding an
:class:`~zaru_tpu_torch.landmark.Estimator`; ``hand`` runs
``MultiHandTracker(max_hands=1).run_frame`` three times and finds no hand
on the fixture photos (n/a).

Run it::

    python -m zaru_tpu_torch eval [--models face_mesh,iris,...] [--input PHOTO] [--json OUT] [--device cpu]

``--device`` is ``cuda`` unless named. An input ending in ``.npy`` is a
decoded ``[H,W,4] u8`` frame (for a machine without a JPEG decoder).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from ._device import resolve_device
from .ops.sampling import sample_view_rgba
from .rect import rrect_transform_out

__all__ = [
    "DEFAULT_TRANSFORMS",
    "RUNNERS",
    "Transform",
    "evaluate_runner",
    "main",
    "map_points_back",
    "runner",
    "summarize",
    "transform_rrect",
    "warp_image",
]


@dataclass(frozen=True)
class Transform:
    """A known view transform: rotate by ``angle_deg`` about the (shifted)
    image centre, zoom by ``scale``, translate by ``shift`` px."""

    name: str
    angle_deg: float = 0.0
    scale: float = 1.0
    shift: tuple[float, float] = (0.0, 0.0)


DEFAULT_TRANSFORMS = (
    Transform("identity"),
    Transform("rot+10", angle_deg=10.0),
    Transform("rot-10", angle_deg=-10.0),
    Transform("rot+25", angle_deg=25.0),
    Transform("scale0.85", scale=0.85),
    Transform("scale1.15", scale=1.15),
    Transform("shift+24+16", shift=(24.0, 16.0)),
    Transform("rot-12_s0.9_shift", angle_deg=-12.0, scale=0.9, shift=(-18.0, 10.0)),
)


def transform_rrect(height: int, width: int, t: Transform) -> np.ndarray:
    """The rotated view rect ``[cx, cy, w, h, θ]`` (root coordinates) whose
    materialisation at (width, height) realises ``t``."""
    return np.array(
        [width / 2.0 + t.shift[0], height / 2.0 + t.shift[1], width / t.scale, height / t.scale,
         np.deg2rad(t.angle_deg)],
        np.float32,
    )


def warp_image(image_u8: np.ndarray, rrect: np.ndarray, device=None) -> np.ndarray:
    """The view ``rrect`` of ``image_u8 [H,W,4]`` materialised at the
    source's size by the exact sampler on ``device``, as a host array."""
    dev = resolve_device(device)
    h, w = image_u8.shape[:2]
    out = sample_view_rgba(torch.from_numpy(np.ascontiguousarray(image_u8)).to(dev),
                           torch.from_numpy(np.asarray(rrect, np.float32)).to(dev), w, h)
    return out.cpu().numpy()


def map_points_back(pts_xy: np.ndarray, rrect: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Landmark xy found on the warped frame, mapped back to source
    coordinates through the exact inverse of the warp's continuous map."""
    out_h, out_w = out_hw
    ratio = np.array([rrect[2] / out_w, rrect[3] / out_h], np.float32)
    return rrect_transform_out(np.asarray(rrect, np.float32), np.asarray(pts_xy, np.float32) * ratio)


# --------------------------------------------------------------------------
# Runners: frame [H,W,4] u8 (host) -> (points [N,2], valid).
# --------------------------------------------------------------------------

RUNNERS: dict[str, type] = {}


def runner(name):
    def deco(cls):
        cls.name = name
        RUNNERS[name] = cls
        return cls

    return deco


class _FusedFaceRunner:
    """``FaceTracker`` (detect → rotated-ROI crop → landmark → unmap) with
    smoothing off, so each frame stands alone; ``run_frame`` runs ``settle``
    times so the ROI converges as on a steady stream."""

    iris = False
    settle = 3

    def __init__(self, device=None):
        from .pipeline import FaceTracker

        self.device = resolve_device(device)
        kwargs = {"smooth": None, "iris": self.iris, "device": self.device}
        landmarker = self.landmarker()
        if landmarker is not None:
            kwargs["landmarker"] = landmarker
        self.tracker = FaceTracker(**kwargs)

    def landmarker(self):
        return None

    def points(self, out) -> np.ndarray:
        return out["landmarks"].cpu().numpy()[:, :2]

    def __call__(self, frame: np.ndarray):
        state = self.tracker.init_state()
        frame = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        for _ in range(self.settle):
            state, out = self.tracker.run_frame(state, frame)
        return self.points(out), bool(out["valid"])


@runner("face_mesh")
class FaceMeshRunner(_FusedFaceRunner):
    """Face Mesh V1, 468 points."""


@runner("face_mesh_v2")
class FaceMeshV2Runner(_FusedFaceRunner):
    """Face Mesh V2, 478 points."""

    def landmarker(self):
        from .face.landmark.mediapipe import FaceMeshV2

        return FaceMeshV2(device=self.device)


@runner("iris")
class IrisRunner(_FusedFaceRunner):
    """The iris cascade: the 2×76 eye and iris landmarks are compared."""

    iris = True

    def points(self, out) -> np.ndarray:
        return out["eyes"].cpu().numpy().reshape(-1, 3)[:, :2]


class _HostEstimatorRunner:
    """The host engines: the short-range BlazeFace ``Detector`` seeds a
    grown ROI, the ``Estimator`` runs the landmark network on that view, and
    the landmarks map back through the view's rotated rect."""

    grow = 0.3  # landmark.DEFAULT_ROI_PADDING

    def network(self):
        raise NotImplementedError

    def __init__(self, device=None):
        from .detection import Detector
        from .face.detection import ShortRangeNetwork
        from .landmark import Estimator

        self.device = resolve_device(device)
        self.detector = Detector(ShortRangeNetwork(device=self.device))
        self.estimator = Estimator(self.network())

    def __call__(self, frame: np.ndarray):
        from .image import Image

        img = Image(frame, self.device)
        dets = [d for _cls, d in self.detector.detect(img).all_detections()]
        if not dets:
            return np.zeros((0, 2), np.float32), False
        det = max(dets, key=lambda d: d.confidence())
        view = img.view(det.bounding_rect().grow_rel(self.grow))
        est = self.estimator.estimate(view)
        pos = est.landmarks_mut().positions()[:, :2]
        return rrect_transform_out(view.view_rect.array, pos), True


@runner("multipie68_peppa")
class PeppaRunner(_HostEstimatorRunner):
    """68-point ``PeppaFacialLandmark``."""

    def network(self):
        from .face.landmark.multipie68 import PeppaFacialLandmark

        return PeppaFacialLandmark(device=self.device)


@runner("multipie68_onnx")
class FaceOnnxRunner(_HostEstimatorRunner):
    """68-point ``FaceOnnx``."""

    def network(self):
        from .face.landmark.multipie68 import FaceOnnx

        return FaceOnnx(device=self.device)


@runner("hand")
class HandRunner:
    """``MultiHandTracker(max_hands=1)`` (palm detection → 21-point
    landmarks). The fixture photos show no hand, so it reports n/a there;
    point ``--input`` at a hand photo for a number."""

    settle = 3

    def __init__(self, device=None):
        from .pipeline import MultiHandTracker

        self.device = resolve_device(device)
        self.tracker = MultiHandTracker(max_hands=1, device=self.device)

    def __call__(self, frame: np.ndarray):
        state = self.tracker.init_state()
        frame = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        for _ in range(self.settle):
            state, out = self.tracker.run_frame(state, frame)
        valid = out["valid"].cpu().numpy().reshape(-1)
        if not valid.any():
            return np.zeros((0, 2), np.float32), False
        slot = int(np.argmax(valid))
        lms = out["landmarks"].cpu().numpy().reshape(valid.size, -1, 3)
        return lms[slot, :, :2], True


# --------------------------------------------------------------------------
# The sweep.
# --------------------------------------------------------------------------


def evaluate_runner(run, frame: np.ndarray, transforms=DEFAULT_TRANSFORMS, device=None):
    """One runner on one frame: a row per transform, ``{"transform",
    "valid", "mean_px", "p95_px", "max_px"}``; the frames are warped on
    ``device``."""
    h, w = frame.shape[:2]
    base_pts, base_ok = run(frame)
    if not base_ok:
        return [{"transform": "base", "valid": False}]
    rows = []
    for t in transforms:
        rrect = transform_rrect(h, w, t)
        pts, ok = run(warp_image(frame, rrect, device))
        row = {"transform": t.name, "valid": bool(ok)}
        if ok and len(pts) == len(base_pts):
            dev = np.linalg.norm(map_points_back(pts, rrect, (h, w)) - base_pts, axis=-1)
            row.update(mean_px=float(dev.mean()), p95_px=float(np.percentile(dev, 95)), max_px=float(dev.max()))
        rows.append(row)
    return rows


def summarize(rows) -> dict:
    """The sweep's aggregate, the identity left out (it is exact by
    construction)."""
    live = [r for r in rows if r.get("valid") and "mean_px" in r and r["transform"] != "identity"]
    if not live:
        return {"valid_transforms": 0}
    return {
        "valid_transforms": len(live),
        "mean_px": float(np.mean([r["mean_px"] for r in live])),
        "p95_px": float(np.max([r["p95_px"] for r in live])),
        "max_px": float(np.max([r["max_px"] for r in live])),
    }


def main(argv=None) -> int:
    import argparse

    from .assets import fixture_path
    from .image import Image

    parser = argparse.ArgumentParser(prog="zaru_tpu_torch eval", description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", default=",".join(RUNNERS), help=f"comma-separated subset of: {','.join(RUNNERS)}")
    parser.add_argument("--input", action="append",
                        help="input photo(s), or .npy RGBA u8 arrays [H,W,4]; default: both fixture photos")
    parser.add_argument("--json", help="write every per-transform row here")
    parser.add_argument("--device", default=None, help="torch device (default cuda; raises without a GPU)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    inputs = args.input or [str(fixture_path("sad_linus.jpg")), str(fixture_path("sad_linus_cropped.jpg"))]
    names = [n.strip() for n in args.models.split(",")]
    unknown = [n for n in names if n not in RUNNERS]
    if unknown:
        raise SystemExit(f"unknown model(s) {unknown}; valid: {', '.join(sorted(RUNNERS))}")
    # Distinct report keys even when two inputs share a basename.
    basenames = [p.rsplit("/", 1)[-1] for p in inputs]
    labels = [b if basenames.count(b) == 1 else p for b, p in zip(basenames, inputs)]
    frames = [np.load(path) if path.endswith(".npy") else Image.load(path, device="cpu").to_numpy()
              for path in inputs]
    report = {}
    for name in names:
        run = RUNNERS[name](device=device)
        for frame, label in zip(frames, labels):
            rows = evaluate_runner(run, frame, device=device)
            agg = summarize(rows)
            key = f"{name}:{label}"
            report[key] = {"rows": rows, "summary": agg}
            if agg.get("valid_transforms"):
                print(f"{key}: mean {agg['mean_px']:.3f} px, p95 {agg['p95_px']:.3f} px, "
                      f"max {agg['max_px']:.3f} px over {agg['valid_transforms']} transforms")
            else:
                print(f"{key}: n/a (nothing detected on this input)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
