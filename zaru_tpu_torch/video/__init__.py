"""Video inputs (zaru_tpu/video): V4L2 webcams (through the port's native
layer), HTTP MJPEG cameras, animated images and video files. Frames decode
on the host into images on the device the caller names."""

from . import anim, file, httpcam, webcam
from .anim import Animation
from .file import VideoFile
from .httpcam import HttpCam
from .webcam import ParamPreference, Webcam, WebcamOptions

__all__ = [
    "anim", "file", "httpcam", "webcam", "Animation", "HttpCam", "ParamPreference", "VideoFile", "Webcam",
    "WebcamOptions",
]
