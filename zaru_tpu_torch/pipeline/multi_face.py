"""Fixed-slot multi-face tracking (zaru_tpu/pipeline/multi_face.py:30
``MultiFaceTracker``): the multi-object machinery configured for BlazeFace
short-range → Face Mesh V1.

The detection box is the ROI as it is (``grow_by=0.0``), the landmark
bbox is padded by 0.3, the residual angle comes from the outer eye corners,
and the gated step's 192×192 crops go through the rotated-ROI kernel on the
512-pixel grid at any angle. Both CNNs' BlazeBlock chains run through the
stage kernel.
"""

from __future__ import annotations

from .._device import resolve_device
from ..face.detection import ShortRangeNetwork
from ..face.landmark.mediapipe import FaceMeshV1, LandmarkIdx
from ..geometry import signed_angle_to_x
from .multi_object import MultiObjectTracker

__all__ = ["MultiFaceTracker"]


def _face_residual_angle(xy_view):
    """Face rotation from the outer eye corners, in view coords
    ``[N,468,2]`` → ``[N]``."""
    return signed_angle_to_x(
        xy_view[:, LandmarkIdx.RIGHT_EYE_OUTER_CORNER] - xy_view[:, LandmarkIdx.LEFT_EYE_OUTER_CORNER]
    )


class MultiFaceTracker(MultiObjectTracker):
    """Up to ``max_faces`` faces per stream, on ``device`` (``cuda`` unless
    named)."""

    def __init__(
        self,
        detector: ShortRangeNetwork | None = None,
        landmarker: FaceMeshV1 | None = None,
        *,
        max_faces: int = 4,
        detect_interval: int = 9,
        detection_threshold: float = 0.5,
        loss_threshold: float = 0.5,
        iou_thresh: float = 0.3,
        redetect_bucket: int | None = None,
        params: dict | None = None,
        device=None,
    ):
        device = resolve_device(device)
        super().__init__(
            detector or ShortRangeNetwork(device=device),
            landmarker or FaceMeshV1(device=device),
            residual_angle=_face_residual_angle,
            grow_by=0.0,
            roi_padding=0.3,
            max_objects=max_faces,
            detect_interval=detect_interval,
            detection_threshold=detection_threshold,
            presence_threshold=loss_threshold,
            iou_thresh=iou_thresh,
            fast_sampler=True,
            redetect_bucket=redetect_bucket,
            params=params,
            device=device,
        )
