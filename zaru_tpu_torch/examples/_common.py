"""Shared helpers for the examples (examples/_common.py): the ``--device``
option and a frame source that falls back from a file to the webcam to the
bundled photo, so every example also runs headless.

An image argument ending in ``.npy`` is an ``[H, W, 3|4]`` uint8 array, as
``eval --input`` reads it, so a machine without an image decoder can feed
an example.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from zaru_tpu_torch._device import resolve_device
from zaru_tpu_torch.assets import fixture_path
from zaru_tpu_torch.image import Image

__all__ = ["example_device", "frame_source", "load_image", "take_device"]


def take_device(argv: list) -> str | None:
    """Removes ``--device D`` (or ``--device=D``) from ``argv`` in place and
    returns ``D``, or None when it is not there."""
    for i, arg in enumerate(argv):
        if arg == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device needs a value (cuda, cuda:1, cpu, ...)")
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if arg.startswith("--device="):
            del argv[i]
            return arg.split("=", 1)[1]
    return None


def example_device(argv: list | None = None) -> torch.device:
    """The device named by ``--device`` in ``argv`` (``sys.argv`` unless
    given; the option is taken out of it), ``cuda`` unless named. Without
    a GPU, ``cuda`` raises (``resolve_device``), as the CLI's ``--device``
    does."""
    return resolve_device(take_device(sys.argv if argv is None else argv))


def load_image(path, device) -> Image:
    """An image file (or a ``.npy`` uint8 array) as an image on ``device``."""
    if str(path).endswith(".npy"):
        return Image.from_array(np.load(path), device)
    return Image.load(path, device)


def frame_source(device, argv: list | None = None, loop_static: int = 30):
    """Yields frames on ``device``: from a file given on the command line,
    else the webcam, else the bundled photo (repeated ``loop_static``
    times, or ``ZARU_TPU_EXAMPLE_FRAMES`` for quick runs). ``--device`` is
    taken out of ``argv`` before the file is read from it."""
    loop_static = int(os.environ.get("ZARU_TPU_EXAMPLE_FRAMES", loop_static))
    argv = list(sys.argv[1:] if argv is None else argv)
    take_device(argv)
    if argv:
        img = load_image(argv[0], device)
        for _ in range(loop_static):
            yield img
        return
    try:
        from zaru_tpu_torch.video.webcam import Webcam, WebcamOptions

        cam = Webcam.open(WebcamOptions(), device=device)
    except RuntimeError:
        # No usable camera: loop the photo. Only a failure to open falls
        # back; a read error mid-stream must surface.
        img = Image.load(fixture_path("sad_linus.jpg"), device)
        for _ in range(loop_static):
            yield img
        return
    try:
        while True:
            yield cam.read()
    finally:
        cam.close()
