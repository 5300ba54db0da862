"""68-point facial landmark demo."""

from zaru_tpu_torch import gui
from zaru_tpu_torch.color import Color
from zaru_tpu_torch.detection import Detector
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.face.detection import ShortRangeNetwork
from zaru_tpu_torch.face.landmark.multipie68 import FaceOnnx
from zaru_tpu_torch.image.draw import Canvas, marker, rect
from zaru_tpu_torch.landmark import Estimator


def main():
    device = example_device()
    detector = Detector(ShortRangeNetwork(device=device))
    estimator = Estimator(FaceOnnx(device=device))
    for image in frame_source(device):
        canvas = Canvas(image)
        for det in detector.detect(image):
            crop_rect = (
                det.bounding_rect()
                .grow_rel(0.15)
                .grow_to_fit_aspect(estimator.input_resolution().aspect_ratio())
            )
            rect(canvas, crop_rect, color=Color.RED)
            lms = estimator.estimate(image.view(crop_rect))
            for p in lms.landmarks_mut().positions():
                # Positions are in view coordinates; offset to the image's.
                marker(canvas, p[:2] + crop_rect.top_left(), size=2, color=Color.RED)
        gui.show_image("facemarks68", canvas.flush())


if __name__ == "__main__":
    gui.run(main)
