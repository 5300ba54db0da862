"""Plays an animated image.

Usage: python -m zaru_tpu_torch.examples.animation <gif/apng> [--device D]
"""

import sys
import time

from zaru_tpu_torch import gui
from zaru_tpu_torch._device import resolve_device
from zaru_tpu_torch.examples._common import take_device
from zaru_tpu_torch.video.anim import Animation


def main():
    device = take_device(sys.argv)
    if len(sys.argv) < 2:
        print("usage: animation <file> [--device D]")
        return 2
    device = resolve_device(device)
    anim = Animation.from_path(sys.argv[1], device)
    for frame in anim.frames():
        gui.show_image("animation", frame.image_view())
        time.sleep(frame.duration())


if __name__ == "__main__":
    gui.run(main)
