"""Batch-gated face detect → crop → landmark → smooth cascade
(zaru_tpu/pipeline/face_cascade.py:62 ``FaceTracker``).

One step over a batch of streams (``step_batch``, face_cascade.py:452):

- **Detect**, only when some stream is lost or the caller forces it
  (``_detect_batch`` :197): letterbox every frame to 128×128 (the letterbox
  kernel), BlazeFace, SSD decode, weighted NMS with one output → seed ROI.
- **Track**, every step (``_track_batch`` :250, ``_track_tail`` :285):
  aspect-fit view rect, rotated 192×192 crop (the rotated-ROI kernel), Face
  Mesh, decode, 1€ smoothing in network coordinates, landmarks back to the
  image, next ROI from the rotated landmark bbox plus padding.
- **Iris**, every step with ``iris=True`` (``_iris_batch`` :394): two eye
  rects from the landmarks, rotated 64×64 crops on a 256-pixel prescale
  grid, right eyes mirrored, the iris network on the ``2B`` crops, 76
  landmarks per eye back in the image (``eyes [B,2,76,3]``).

The two CNNs' BlazeBlock chains run through the stage kernel
(``onnx/executor.py``); the iris network's blocks are bottlenecks and run
op by op.

The batch gate: in JAX the detect-or-keep choice is a device-side
``lax.cond`` (face_cascade.py:509). Here it is one host read of one bool per
step (``all streams tracking and not forced``), which waits for the previous
step's tracking flags; capturing the two branches as CUDA graphs is left
for later. With ``redetect_bucket=K`` an unforced detect step detects only
the first K lost streams (``_detect_bucket`` :216). Not ported yet: the
single-stream ``step``/``run_frame`` and ``scan_video``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..detection import nms_average_device
from ..face.detection import ShortRangeNetwork
from ..face.eye import EyeLandmarks, EyeNetwork
from ..face.landmark.mediapipe import FaceMeshV1, LandmarkIdx
from ..filters import OneEuroFilter
from ..geometry import rect_grow_rel, rrect_bounding, signed_angle_to_x
from . import _ops

__all__ = ["FaceTracker"]


class FaceTracker:
    """Batched face tracking cascade on ``device`` (``cuda`` unless named).

    ``params``: optional ``{"det": {...}, "lm": {...}[, "eye": {...}]}``
    ONNX-initializer dicts (see :func:`zaru_tpu_torch.weights.params_from_jax`)
    replacing the weights loaded from the ONNX files. ``iris``: also refine
    both eyes every step. ``redetect_bucket``: detect at most this many lost
    streams on an unforced detect step.
    """

    EYE_PRESCALE_M = 256  # the eye crops' prescale grid (face_cascade.py:397-402)

    def __init__(
        self,
        *,
        detection_threshold: float = 0.5,
        loss_threshold: float = 0.5,
        roi_padding: float = 0.3,
        smooth: OneEuroFilter | None = OneEuroFilter(min_cutoff=1.0, beta=0.5),
        frame_rate: float = 30.0,
        iris: bool = False,
        redetect_bucket: int | None = None,
        params: dict | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.detector = ShortRangeNetwork(device=self.device)
        self.landmarker = FaceMeshV1(device=self.device)
        self.det_cnn = self.detector.cnn()
        self.lm_cnn = self.landmarker.cnn()
        self.iris = iris
        if iris:
            self.eye_cnn = EyeNetwork(device=self.device).cnn()
        if params is not None:
            self.det_cnn.net.load_params(params["det"])
            self.lm_cnn.net.load_params(params["lm"])
            if iris and "eye" in params:
                self.eye_cnn.net.load_params(params["eye"])
        self.redetect_bucket = redetect_bucket
        self.detection_threshold = detection_threshold
        self.loss_threshold = loss_threshold
        self.roi_padding = roi_padding
        self.smooth = smooth
        self.elapsed = 1.0 / frame_rate
        self.num_landmarks = FaceMeshV1.NUM_LANDMARKS

    def init_state(self, batch: int) -> dict:
        """Fresh (not tracking) state for ``batch`` streams."""
        dev = self.device
        filt = (
            self.smooth.init_state((batch, self.num_landmarks, 3), dev) if self.smooth else {}
        )
        return {
            "roi": torch.zeros((batch, 5), dtype=torch.float32, device=dev),
            "tracking": torch.zeros(batch, dtype=torch.bool, device=dev),
            "filter": filt,
        }

    def _detect_batch(self, frames):
        """Letterbox + BlazeFace + decode + NMS for every stream → (rois
        [B,5], founds [B])."""
        res = self.det_cnn.input_resolution()
        fit, fit_rrect = _ops.full_frame_fit(frames, res)
        b = frames.shape[0]
        outputs = self.det_cnn.apply_views_letterbox(frames, fit_rrect.expand(b, 5).contiguous())
        boxes, conf, kps, angles = self.detector.decode_device(outputs, self.detection_threshold)
        valid, _conf, avg_box, _kp, _angle = nms_average_device(boxes, conf, kps, angles, max_out=1)
        rect = _ops.unmap_center_size(avg_box[:, 0], fit, res)
        rois = torch.cat([rect, torch.zeros_like(rect[:, :1])], dim=-1)
        return rois, valid[:, 0]

    def _detect_bucket(self, state, frames):
        """Detection for the first K lost streams only (K =
        ``redetect_bucket``): a stable sort on the tracking flags brings the
        lost streams to the front, their K frames are detected as one batch,
        and the results are scattered back; tracked streams keep their ROIs.
        → (rois [B,5], founds [B], seeded [B])."""
        tr = state["tracking"]
        k = min(int(self.redetect_bucket), tr.shape[0])
        idx = torch.sort(tr.to(torch.uint8), stable=True).indices[:k]  # lost first
        sel = ~tr[idx]  # bucket slots that really are lost
        rois_k, found_k = self._detect_batch(frames[idx])
        apply = sel & found_k
        rois = state["roi"].index_copy(
            0, idx, torch.where(apply[:, None], rois_k, state["roi"][idx])
        )
        founds = tr.index_copy(0, idx, tr[idx] | apply)
        seeded = torch.zeros_like(tr).index_copy(0, idx, sel)
        return rois, founds, seeded

    def _track_batch(self, state, frames, rois, seeded):
        """Rotated crops + Face Mesh for every stream, then the tail (and
        the eyes, with ``iris``)."""
        res = self.lm_cnn.input_resolution()
        view_rects = _ops.aspect_view_rect(rois, res)
        outputs = self.lm_cnn.apply_views_fast(frames, view_rects)
        new_state, out = self._track_tail(state, outputs, view_rects, seeded)
        if self.iris:
            out["eyes"] = self._iris_batch(frames, out["landmarks"])
        return new_state, out

    def _track_tail(self, state, outputs, view_rects, seeded):
        """Decode → smooth → unmap → ROI update, batched."""
        res = self.lm_cnn.input_resolution()
        coords, conf = self.landmarker.decode_device(outputs)
        coords = coords[:, : self.num_landmarks]
        fstate = state["filter"]
        if self.smooth:
            # Freshly seeded streams restart their filter.
            fstate = {
                k: torch.where(seeded.reshape(-1, 1, 1), torch.zeros_like(s), s)
                for k, s in fstate.items()
            }
            fstate, coords = self.smooth.apply(fstate, coords, self.elapsed)
        xy_view, pos = _ops.landmarks_to_image(coords, view_rects, res)
        ltr = (
            xy_view[:, LandmarkIdx.RIGHT_EYE_OUTER_CORNER]
            - xy_view[:, LandmarkIdx.LEFT_EYE_OUTER_CORNER]
        )
        angle = view_rects[:, 4] + signed_angle_to_x(ltr)
        new_roi = _ops.padded_roi(pos[..., 0:2], angle, self.roi_padding)
        tracking = conf >= self.loss_threshold
        new_state = {"roi": new_roi, "tracking": tracking, "filter": fstate}
        out = {"landmarks": pos, "confidence": conf, "roi": new_roi, "valid": tracking}
        return new_state, out

    # Iris refinement (face_cascade.py:337-418).
    _LEFT_EYE = [
        LandmarkIdx.LEFT_EYE_BOTTOM, LandmarkIdx.LEFT_EYE_OUTER_CORNER,
        LandmarkIdx.LEFT_EYE_INNER_CORNER, LandmarkIdx.LEFT_EYE_TOP,
    ]
    _RIGHT_EYE = [
        LandmarkIdx.RIGHT_EYE_BOTTOM, LandmarkIdx.RIGHT_EYE_INNER_CORNER,
        LandmarkIdx.RIGHT_EYE_OUTER_CORNER, LandmarkIdx.RIGHT_EYE_TOP,
    ]
    EYE_GROW = 0.8

    def _eye_view_rects(self, pos):
        """Landmarks ``[B,468,3]`` in image coords → aspect-fit eye view
        rects ``[B,2,5]``, left eye first (:351)."""
        res = self.eye_cnn.input_resolution()
        angle = signed_angle_to_x(
            pos[:, LandmarkIdx.RIGHT_EYE_OUTER_CORNER, :2]
            - pos[:, LandmarkIdx.LEFT_EYE_OUTER_CORNER, :2]
        )

        def one(idx):
            r = rrect_bounding(angle, pos[:, idx, :2])
            r = torch.cat([rect_grow_rel(r[:, 0:4], self.EYE_GROW), r[:, 4:5]], dim=-1)
            return _ops.aspect_view_rect(r, res)

        return torch.stack([one(self._LEFT_EYE), one(self._RIGHT_EYE)], dim=1)

    def _iris_decode(self, outputs, view_rects, flip):
        """``(eye [N,...,213], iris [N,...,15])`` → ``[N,76,3]`` image-coord
        landmarks, iris centre first (:369); ``flip [N]`` un-mirrors right
        eyes."""
        res = self.eye_cnn.input_resolution()
        n = view_rects.shape[0]
        coords = torch.cat([outputs[1].reshape(n, 5, 3), outputs[0].reshape(n, 71, 3)], dim=1)
        x = torch.where(flip[:, None], float(np.float32(res.width)) - coords[..., 0], coords[..., 0])
        coords = torch.cat([x[..., None], coords[..., 1:]], dim=-1)
        _xy_view, pos = _ops.landmarks_to_image(coords, view_rects, res)
        return pos

    def _iris_batch(self, frames, pos):
        """Both eyes of every stream → ``[B,2,76,3]`` (:394)."""
        return self._iris_views(frames, self._eye_view_rects(pos))

    def _iris_views(self, frames, rects):
        """Eye view rects ``[B,2,5]`` → ``[B,2,76,3]``: the eye crops through
        the rotated-ROI kernel, right eyes mirrored by the sampler, ``[B,2]``
        flattened to ``[2B]`` around the iris network."""
        outputs = self.eye_cnn.apply_views_fast(
            frames, rects, prescale_m=self.EYE_PRESCALE_M, mirror=(False, True)
        )
        b = rects.shape[0]
        flips = torch.tensor([False, True], device=rects.device).repeat(b)
        eyes = self._iris_decode(outputs, rects.reshape(2 * b, 5), flips)
        return eyes.reshape(b, 2, EyeLandmarks.NUM_LANDMARKS, 3)

    @torch.inference_mode()
    def step_batch(self, state: dict, frames, force_detect: bool = False):
        """One step for ``frames [B,H,W,4] u8`` on the tracker's device →
        ``(new_state, outputs)``; outputs hold ``landmarks [B,468,3]`` in
        image coords, ``confidence [B]``, ``roi [B,5]``, ``valid [B]`` and,
        with ``iris``, ``eyes [B,2,76,3]``.

        Detection runs for every stream when some stream is lost or
        ``force_detect`` is set (the redetect cadence); tracked streams keep
        their carried ROIs either way. With ``redetect_bucket``, a detect
        step that is not forced detects only the first K lost streams."""
        tr = state["tracking"]
        if not force_detect and bool(tr.all()):
            rois, founds, seeded = state["roi"], torch.ones_like(tr), torch.zeros_like(tr)
        elif self.redetect_bucket and not force_detect:
            rois, founds, seeded = self._detect_bucket(state, frames)
        else:
            det_rois, det_founds = self._detect_batch(frames)
            rois = torch.where(tr[:, None], state["roi"], det_rois)
            founds, seeded = tr | det_founds, ~tr
        new_state, out = self._track_batch(state, frames, rois, seeded)
        new_state["tracking"] = new_state["tracking"] & founds
        out["valid"] = out["valid"] & founds
        return new_state, out

    def run_frames_gated(self, state: dict, frames):
        """The serving step: :meth:`step_batch` without forced detection."""
        return self.step_batch(state, frames)
