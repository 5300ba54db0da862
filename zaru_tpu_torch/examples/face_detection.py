"""Face detection demo."""

from zaru_tpu_torch import gui
from zaru_tpu_torch.color import Color
from zaru_tpu_torch.detection import Detector
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.face.detection import ShortRangeNetwork
from zaru_tpu_torch.image.draw import Canvas, marker, rotated_rect, text
from zaru_tpu_torch.rect import RotatedRect
from zaru_tpu_torch.timer import FpsCounter


def main():
    device = example_device()
    detector = Detector(ShortRangeNetwork(device=device))
    fps = FpsCounter("face detection")
    for image in frame_source(device):
        canvas = Canvas(image)
        for det in detector.detect(image):
            rotated_rect(
                canvas,
                RotatedRect.new(det.bounding_rect(), det.angle()),
                color=Color.from_rgb8(170, 0, 0),
            )
            for kp in det.keypoints():
                marker(canvas, kp)
            text(
                canvas,
                det.bounding_rect().center(),
                f"conf={det.confidence():.2f}",
                color=Color.GREEN if det.confidence() > 0.8 else Color.YELLOW,
            )
        gui.show_image("face detection", canvas.flush())
        fps.tick_with(detector.timers())


if __name__ == "__main__":
    gui.run(main)
