"""Webcam viewer.

Usage: python -m zaru_tpu_torch.examples.webcam [--device D]
"""

from zaru_tpu_torch import gui
from zaru_tpu_torch.examples._common import example_device
from zaru_tpu_torch.timer import FpsCounter
from zaru_tpu_torch.video.webcam import Webcam, WebcamOptions


def main():
    device = example_device()
    cam = Webcam.open(WebcamOptions(), device=device)
    print(f"opened webcam: {cam.resolution()} @ {cam.fps():.0f} fps")
    fps = FpsCounter("webcam")
    while True:
        image = cam.read()
        gui.show_image("webcam", image)
        fps.tick_with(cam.timers())


if __name__ == "__main__":
    gui.run(main)
