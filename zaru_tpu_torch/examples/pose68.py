"""Head-pose estimation from 68 landmarks through PnP (DLT)."""

import numpy as np

from zaru_tpu_torch import gui
from zaru_tpu_torch.detection import Detector
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.face.detection import ShortRangeNetwork
from zaru_tpu_torch.face.landmark.multipie68 import FaceOnnx, reference_positions
from zaru_tpu_torch.image.draw import Canvas, marker, quaternion
from zaru_tpu_torch.landmark import Estimator
from zaru_tpu_torch.pnp import Dlt
from zaru_tpu_torch.procrustes import AnalysisResult


def _quat_from_matrix(m):
    res = AnalysisResult(m, 1.0, np.zeros(3), np.zeros(3), np.zeros(3))
    return res.rotation_quaternion()


def main():
    device = example_device()
    detector = Detector(ShortRangeNetwork(device=device))
    estimator = Estimator(FaceOnnx(device=device))
    dlt = Dlt(reference_positions())

    for image in frame_source(device):
        canvas = Canvas(image)
        dets = list(detector.detect(image))
        if dets:
            det = dets[0]
            crop = (
                det.bounding_rect()
                .grow_rel(0.15)
                .grow_to_fit_aspect(estimator.input_resolution().aspect_ratio())
            )
            lms = estimator.estimate(image.view(crop))
            pos = lms.landmarks_mut().positions()
            for p in pos:
                marker(canvas, p[:2] + crop.top_left(), size=2)
            out = dlt.solve(np.stack([pos[:, 0], -pos[:, 1]], axis=-1))
            q = _quat_from_matrix(out.rotation_matrix)
            center = pos.mean(axis=0)[:2] + crop.top_left()
            quaternion(canvas, center, q, axis_length=40.0)
        gui.show_image("pose68", canvas.flush())


if __name__ == "__main__":
    gui.run(main)
