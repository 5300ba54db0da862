"""Loads and displays an image file.

Usage: python -m zaru_tpu_torch.examples.load_image [<file>] [--device D]
"""

import sys

from zaru_tpu_torch import gui
from zaru_tpu_torch.assets import fixture_path
from zaru_tpu_torch.examples._common import example_device, load_image


def main():
    device = example_device()
    path = sys.argv[1] if len(sys.argv) > 1 else fixture_path("sad_linus.jpg")
    image = load_image(path, device)
    print(f"loaded {path}: {image}")
    gui.show_image("image", image)


if __name__ == "__main__":
    gui.run(main)
