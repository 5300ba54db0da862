"""Video inputs (zaru_tpu/video): animated images and video files. The
webcam and HTTP camera sources are not ported."""

from . import anim, file
from .anim import Animation
from .file import VideoFile

__all__ = ["anim", "file", "Animation", "VideoFile"]
