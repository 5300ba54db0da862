"""HTTP MJPEG camera viewer.

Usage: python -m zaru_tpu_torch.examples.httpcam http://<camera>/stream [--device D]
"""

import sys

from zaru_tpu_torch import gui
from zaru_tpu_torch._device import resolve_device
from zaru_tpu_torch.examples._common import take_device
from zaru_tpu_torch.timer import FpsCounter
from zaru_tpu_torch.video.httpcam import HttpCam


def main():
    device = take_device(sys.argv)
    if len(sys.argv) < 2:
        print("usage: httpcam <url> [--device D]")
        return 2
    cam = HttpCam(sys.argv[1], device=resolve_device(device))
    fps = FpsCounter("httpcam")
    while True:
        image = cam.read()
        gui.show_image("httpcam", image)
        fps.tick_with(cam.timers())


if __name__ == "__main__":
    gui.run(main)
