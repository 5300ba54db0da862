"""Fused pipelines (zaru_tpu/pipeline)."""

from .body_cascade import BodyTracker
from .face_cascade import FaceTracker
from .hand_cascade import MultiHandTracker
from .multi_face import MultiFaceTracker
from .multi_object import MultiObjectTracker

__all__ = ["BodyTracker", "FaceTracker", "MultiFaceTracker", "MultiHandTracker", "MultiObjectTracker"]
