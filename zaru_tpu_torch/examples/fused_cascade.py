"""The whole detect → track → smooth cascade (plus optional iris
refinement) for one stream through ``FaceTracker.run_frame``. Pass
``--iris`` to add the eye/iris stage."""

import sys

from zaru_tpu_torch import gui
from zaru_tpu_torch.color import Color
from zaru_tpu_torch.examples._common import example_device, frame_source
from zaru_tpu_torch.image.draw import Canvas, marker
from zaru_tpu_torch.pipeline import FaceTracker
from zaru_tpu_torch.timer import FpsCounter


def main():
    device = example_device()
    iris = "--iris" in sys.argv[1:]
    if iris:
        sys.argv.remove("--iris")  # frame_source parses the remaining argv
    tracker = FaceTracker(iris=iris, device=device)
    state = tracker.init_state()
    fps = FpsCounter("fused cascade")

    for image in frame_source(device):
        state, out = tracker.run_frame(state, image.data)
        canvas = Canvas(image)
        if bool(out["valid"]):
            for p in out["landmarks"].cpu().numpy():
                marker(canvas, p[:2], size=2)
            if iris:
                for eye in out["eyes"].cpu().numpy():
                    marker(canvas, eye[0, :2], size=4, color=Color.CYAN)
        gui.show_image("fused cascade", canvas.flush())
        fps.tick()


if __name__ == "__main__":
    gui.run(main)
