"""Face landmark models (zaru_tpu/face/landmark)."""

from . import mediapipe, multipie68

__all__ = ["mediapipe", "multipie68"]
