"""Iris/eye tracking demo: face mesh → eye crops → iris landmarks."""

import numpy as np

from zaru_tpu_torch import gui
from zaru_tpu_torch.color import Color
from zaru_tpu_torch.detection import Detector
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.face.detection import ShortRangeNetwork
from zaru_tpu_torch.face.eye import EyeNetwork
from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV1
from zaru_tpu_torch.image import Image
from zaru_tpu_torch.image.draw import Canvas, marker
from zaru_tpu_torch.landmark import Estimator, LandmarkTracker
from zaru_tpu_torch.resolution import Resolution


def main():
    device = example_device()
    detector = Detector(ShortRangeNetwork(device=device))
    tracker = LandmarkTracker(Estimator(FaceMeshV1(device=device)))
    eye_est = Estimator(EyeNetwork(device=device))

    for image in frame_source(device):
        canvas = Canvas(image)
        result = tracker.track(image)
        if result is None:
            dets = list(detector.detect(image))
            if dets:
                tracker.set_roi(max(dets, key=lambda d: d.confidence()).bounding_rect())
            gui.show_image("eye tracking", canvas.flush())
            continue

        mesh = result.estimate()
        for eye_rect, flip in ((mesh.left_eye(), False), (mesh.right_eye(), True)):
            # Grow to the network's square aspect before materialising, so
            # the crop carries real pixels (a non-square crop would make the
            # estimator's aspect growth read black bands instead).
            grown = eye_rect.grow_rel(0.8).grow_to_fit_aspect(1.0)
            crop = image.view(grown).to_image()
            if flip:
                arr = crop.to_numpy()[:, ::-1]
                lms = eye_est.estimate(Image(np.ascontiguousarray(arr), device))
                lms.flip_horizontal_in_place(Resolution(arr.shape[1], arr.shape[0]))
            else:
                lms = eye_est.estimate(crop)
            # Crop coordinates → image coordinates through the rotated view.
            center = grown.transform_out(lms.iris_center()[:2])
            marker(canvas, center, size=4, color=Color.CYAN)
            for p in lms.eye_contour()[:16]:
                marker(canvas, grown.transform_out(p[:2]), size=1, color=Color.MAGENTA)
        gui.show_image("eye tracking", canvas.flush())


if __name__ == "__main__":
    gui.run(main)
