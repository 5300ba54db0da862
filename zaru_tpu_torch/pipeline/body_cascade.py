"""Fixed-slot body-pose tracking (zaru_tpu/pipeline/body_cascade.py:50
``BodyTracker``): the multi-object machinery configured for pose detection
→ 39-point pose landmarks.

A detection seeds its ROI from keypoints, not the box (``_candidate_rois``
:88): a square centred on the hips with half-side the distance to the
scale point, grown by 1.25, at the detection's angle. Between detections
the ROI is the landmark bbox padded by 0.3, rotated by the shoulders → hips
midline against +Y (``_pose_residual_angle`` :37). The gated step's 256×256
crops go through the rotated-ROI kernel on the 256-pixel grid at any angle
(JAX's ``sampler_opts`` ``prescale_m=256``; its ``band_p``, ``col_split``
and ``square_views`` choose the TPU kernel's blocking, and the port's
sampler is bit-exact to JAX's at these shapes, tests/test_torch_samplers.py),
and the detector's 224×224 input through the letterbox kernel. The outputs
name the confidence ``pose_flag`` and the extras ``visibility`` and
``presence``, and add ``pose_landmarks`` (the first 33 points).
``compute_dtype=torch.bfloat16`` runs both default networks' bodies in
bf16.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..body.detection import Keypoint, PoseNetwork
from ..body.landmark import NUM_POSE, LandmarkIdx, LiteNetwork as PoseLite
from ..geometry import rect_grow_rel
from . import _ops
from .multi_object import MultiObjectTracker

__all__ = ["BodyTracker"]

ROI_PADDING = 0.3
GROW_BY = 1.25  # alignment-point square -> landmark ROI (MediaPipe pose)
PRESCALE_M = 256  # the body crops' prescale grid (body_cascade.py:82-85)


def _pose_residual_angle(xy_view):
    """Body rotation against upright, in view coords ``[N,39,2]`` → ``[N]``:
    the clockwise angle aligning the shoulder-midpoint → hip-midpoint vector
    with +Y."""
    mid_shoulder = (xy_view[:, LandmarkIdx.LEFT_SHOULDER] + xy_view[:, LandmarkIdx.RIGHT_SHOULDER]) * 0.5
    mid_hip = (xy_view[:, LandmarkIdx.LEFT_HIP] + xy_view[:, LandmarkIdx.RIGHT_HIP]) * 0.5
    rel = mid_hip - mid_shoulder
    return torch.atan2(-rel[..., 0], rel[..., 1])


class BodyTracker(MultiObjectTracker):
    """Up to ``max_bodies`` bodies per stream, on ``device`` (``cuda``
    unless named)."""

    def __init__(
        self,
        detector: PoseNetwork | None = None,
        landmarker: PoseLite | None = None,
        *,
        max_bodies: int = 1,
        detect_interval: int = 9,
        detection_threshold: float = 0.5,
        presence_threshold: float = 0.5,
        iou_thresh: float = 0.3,
        compute_dtype=None,
        redetect_bucket: int | None = None,
        params: dict | None = None,
        device=None,
    ):
        device = resolve_device(device)
        super().__init__(
            detector or PoseNetwork(compute_dtype, device=device),
            landmarker or PoseLite(compute_dtype, device=device),
            residual_angle=_pose_residual_angle,
            grow_by=GROW_BY,
            roi_padding=ROI_PADDING,
            max_objects=max_bodies,
            detect_interval=detect_interval,
            detection_threshold=detection_threshold,
            presence_threshold=presence_threshold,
            iou_thresh=iou_thresh,
            fast_sampler=True,
            prescale_m=PRESCALE_M,
            redetect_bucket=redetect_bucket,
            params=params,
            device=device,
        )

    def _candidate_rois(self, avg_box, avg_kps, avg_angle, fit, res):
        """Square ROIs ``[B,S,5]`` from the hips and scale-point keypoints
        ``avg_kps [B,S,4,2]`` (in image coords), instead of the box."""
        hips = _ops.unmap_points(avg_kps[..., Keypoint.HIPS, :], fit, res)
        scale_pt = _ops.unmap_points(avg_kps[..., Keypoint.SCALE_POINT, :], fit, res)
        side = 2.0 * torch.linalg.vector_norm(scale_pt - hips, dim=-1, keepdim=True)
        # rect_grow_rel(a) scales the size by (1 + 2a); grow_by is the total
        # scale factor applied to the alignment square.
        rect = rect_grow_rel(torch.cat([hips, side, side], dim=-1), (self.grow_by - 1.0) / 2.0)
        return torch.cat([rect, avg_angle[..., None]], dim=-1)

    def _finalize_out(self, out):
        out = dict(out)
        out["pose_flag"] = out.pop("confidence")
        out["visibility"] = out.pop("extra0")
        out["presence"] = out.pop("extra1")
        out["pose_landmarks"] = out["landmarks"][..., :NUM_POSE, :]
        return out
