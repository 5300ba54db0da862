"""Fixed-slot multi-hand tracking (zaru_tpu/pipeline/hand_cascade.py:41
``MultiHandTracker``): the multi-object machinery configured for palm
detection → 21-point hand landmarks.

The palm box is grown 1.5× into the hand ROI, the landmark bbox is padded
by 0.4, the residual angle is the wrist → middle-finger MCP rotation against
fingers-up, and the gated step's 224×224 crops go through the rotated-ROI
kernel on the 256-pixel grid at any angle (hands turn ±180°): bit-exact for
views whose rotated bbox fits 256 px, integer stride beyond; with
``fast_sampler=False`` through the exact sampler. The outputs name the
confidence ``presence`` and the landmarker's extra ``handedness``.

``compute_dtype=torch.bfloat16`` runs both default networks' bodies in
bf16 (see ``MultiHandTracker``).
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..hand.detection import LiteNetwork as PalmLite
from ..hand.landmark import LandmarkIdx, LiteNetwork as HandLite
from .multi_object import MultiObjectTracker

__all__ = ["MultiHandTracker"]

ROI_PADDING = 0.4
GROW_BY = 1.5  # palm -> hand
PRESCALE_M = 256  # the hand crops' prescale grid (hand_cascade.py:83-86)


def _palm_residual_angle(xy_view):
    """Palm rotation against fingers-up, in view coords ``[N,21,2]`` →
    ``[N]``."""
    rel = xy_view[:, LandmarkIdx.WRIST] - xy_view[:, LandmarkIdx.MIDDLE_FINGER_MCP]
    return torch.atan2(-rel[..., 0], rel[..., 1])


class MultiHandTracker(MultiObjectTracker):
    """Up to ``max_hands`` hands per stream, on ``device`` (``cuda`` unless
    named).

    ``compute_dtype=torch.bfloat16`` runs the default palm detector's and
    hand landmarker's bodies in bf16. Caution (zaru_tpu/pipeline/
    hand_cascade.py:59-63): JAX measured the landmarks up to ~21 px from
    f32 on crops unlike the training data (presence up to 0.04); the default
    stays f32, so validate on real hands before turning it on."""

    def __init__(
        self,
        detector: PalmLite | None = None,
        landmarker: HandLite | None = None,
        *,
        max_hands: int = 4,
        detect_interval: int = 9,
        detection_threshold: float = 0.5,
        presence_threshold: float = 0.5,
        iou_thresh: float = 0.3,
        fast_sampler: bool = True,
        compute_dtype=None,
        redetect_bucket: int | None = None,
        params: dict | None = None,
        device=None,
    ):
        device = resolve_device(device)
        super().__init__(
            detector or PalmLite(compute_dtype, device=device),
            landmarker or HandLite(compute_dtype, device=device),
            residual_angle=_palm_residual_angle,
            grow_by=GROW_BY,
            roi_padding=ROI_PADDING,
            max_objects=max_hands,
            detect_interval=detect_interval,
            detection_threshold=detection_threshold,
            presence_threshold=presence_threshold,
            iou_thresh=iou_thresh,
            fast_sampler=fast_sampler,
            prescale_m=PRESCALE_M,
            redetect_bucket=redetect_bucket,
            params=params,
            device=device,
        )

    def _finalize_out(self, out):
        out = dict(out)
        out["presence"] = out.pop("confidence")
        out["handedness"] = out.pop("extra0")
        return out
