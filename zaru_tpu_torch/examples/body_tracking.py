"""Body landmark tracking demo.

Needs the ``pose_*`` model blobs, which are missing upstream (drop them
into ``assets/onnx/`` or a directory named by ``ZARU_TPU_MODELS``).
"""

from zaru_tpu_torch import gui
from zaru_tpu_torch.body.detection import PoseNetwork
from zaru_tpu_torch.body.landmark import COARSE_CONNECTIVITY, LiteNetwork
from zaru_tpu_torch.detection import Detector
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.image.draw import Canvas, line, marker
from zaru_tpu_torch.landmark import Estimator, LandmarkTracker


def main():
    device = example_device()
    detector = Detector(PoseNetwork(device=device))
    tracker = LandmarkTracker(Estimator(LiteNetwork(device=device)))

    for image in frame_source(device):
        canvas = Canvas(image)
        result = tracker.track(image)
        if result is None:
            dets = list(detector.detect(image))
            if dets:
                best = max(dets, key=lambda d: d.confidence())
                tracker.set_roi(best.bounding_rect().grow_rel(0.5))
        else:
            lm = result.estimate()
            pos = lm.landmarks_mut().positions()
            for a, b in COARSE_CONNECTIVITY:
                line(canvas, pos[int(a)][:2], pos[int(b)][:2])
            for p in lm.pose_landmarks():
                marker(canvas, p[:2], size=5)
        gui.show_image("body tracking", canvas.flush())


if __name__ == "__main__":
    gui.run(main)
