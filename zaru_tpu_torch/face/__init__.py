"""Face models (zaru_tpu/face): detection, landmarks, eye/iris tracking,
recognition and identification."""

from . import detection, eye, identify, landmark, recognition

__all__ = ["detection", "eye", "identify", "landmark", "recognition"]
