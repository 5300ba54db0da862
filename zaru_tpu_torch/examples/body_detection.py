"""Body detection demo.

Needs ``pose_detection.onnx``, which is missing upstream (drop it into
``assets/onnx/`` or a directory named by ``ZARU_TPU_MODELS``).
"""

from zaru_tpu_torch import gui
from zaru_tpu_torch.body.detection import PoseNetwork
from zaru_tpu_torch.detection import Detector
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.image.draw import Canvas, marker, rect


def main():
    device = example_device()
    detector = Detector(PoseNetwork(device=device))
    for image in frame_source(device):
        canvas = Canvas(image)
        for det in detector.detect(image):
            rect(canvas, det.bounding_rect())
            for kp in det.keypoints():
                marker(canvas, kp)
        gui.show_image("body detection", canvas.flush())


if __name__ == "__main__":
    gui.run(main)
