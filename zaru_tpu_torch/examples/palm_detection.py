"""Palm detection demo."""

from zaru_tpu_torch import gui
from zaru_tpu_torch.detection import Detector
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.hand.detection import LiteNetwork
from zaru_tpu_torch.image.draw import Canvas, marker, rotated_rect
from zaru_tpu_torch.rect import RotatedRect
from zaru_tpu_torch.timer import FpsCounter


def main():
    device = example_device()
    detector = Detector(LiteNetwork(device=device))
    fps = FpsCounter("palm detection")
    for image in frame_source(device):
        canvas = Canvas(image)
        for det in detector.detect(image):
            rotated_rect(canvas, RotatedRect.new(det.bounding_rect(), det.angle()))
            for kp in det.keypoints():
                marker(canvas, kp)
        gui.show_image("palm detection", canvas.flush())
        fps.tick_with(detector.timers())


if __name__ == "__main__":
    gui.run(main)
