"""Fused pipelines (zaru_tpu/pipeline)."""

from .face_cascade import FaceTracker

__all__ = ["FaceTracker"]
