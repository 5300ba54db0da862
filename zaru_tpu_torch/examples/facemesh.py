"""Face mesh tracking demo: Face Mesh V1 tracked from frame to frame,
short-range detection when the face is lost."""

from zaru_tpu_torch import gui
from zaru_tpu_torch.color import Color
from zaru_tpu_torch.detection import Detector
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.face.detection import ShortRangeNetwork
from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV1
from zaru_tpu_torch.image.draw import Canvas, marker, rect
from zaru_tpu_torch.landmark import Estimator, LandmarkTracker
from zaru_tpu_torch.timer import FpsCounter


def main():
    device = example_device()
    detector = Detector(ShortRangeNetwork(device=device))
    tracker = LandmarkTracker(Estimator(FaceMeshV1(device=device)))
    fps = FpsCounter("facemesh")

    for image in frame_source(device):
        canvas = Canvas(image)
        result = tracker.track(image)
        if result is not None:
            for p in result.estimate().landmarks_mut().positions():
                marker(canvas, p[:2], size=2)
        else:
            detections = list(detector.detect(image))
            best = max(detections, key=lambda d: d.confidence(), default=None)
            if best is not None:
                tracker.set_roi(best.bounding_rect())
                rect(canvas, best.bounding_rect(), color=Color.BLUE)
        gui.show_image("facemesh", canvas.flush())
        fps.tick_with(list(detector.timers()) + list(tracker.timers()))


if __name__ == "__main__":
    gui.run(main)
