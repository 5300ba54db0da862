"""Multi-hand tracking demo on the host engines (``HandTracker``)."""

from zaru_tpu_torch import gui
from zaru_tpu_torch.color import Color
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.hand.landmark import CONNECTIVITY
from zaru_tpu_torch.hand.tracking import HandTracker
from zaru_tpu_torch.image.draw import Canvas, line, marker, text
from zaru_tpu_torch.timer import FpsCounter


def main():
    device = example_device()
    tracker = HandTracker(device=device)
    fps = FpsCounter("hand tracking")
    for image in frame_source(device):
        tracker.track(image)
        canvas = Canvas(image)
        for hand in tracker.hands():
            lm = hand.landmark_result
            pos = lm.landmarks.positions()
            for a, b in CONNECTIVITY:
                line(canvas, pos[int(a)][:2], pos[int(b)][:2])
            for p in pos:
                marker(canvas, p[:2], size=3)
            text(
                canvas,
                lm.palm_center()[:2],
                f"#{hand.id.value} {lm.handedness().value}",
                color=Color.CYAN,
            )
        gui.show_image("hand tracking", canvas.flush())
        fps.tick()


if __name__ == "__main__":
    gui.run(main)
