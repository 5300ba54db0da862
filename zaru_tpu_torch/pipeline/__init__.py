"""Fused pipelines (zaru_tpu/pipeline)."""

from .face_cascade import FaceTracker
from .hand_cascade import MultiHandTracker
from .multi_face import MultiFaceTracker
from .multi_object import MultiObjectTracker

__all__ = ["FaceTracker", "MultiFaceTracker", "MultiHandTracker", "MultiObjectTracker"]
