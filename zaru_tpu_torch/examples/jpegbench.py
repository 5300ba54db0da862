"""JPEG decode speed by backend (examples/jpegbench.py; reference
examples/jpegbench.rs) on the port's decoders, on the host.

A backend that is not there gives a ``skipped`` line naming it, never a
number from another backend: ``image.decode`` falls back to cv2 when a
backend's module cannot be imported, so each one is checked first, and the
native backend raises ``NativeUnavailable`` where its build cannot run.
Decoding runs on the host; ``--device`` is taken out of the arguments and
not used.

Usage: python -m zaru_tpu_torch.examples.jpegbench [file.jpg [iterations]]
"""

import os
import sys
import time

from zaru_tpu_torch.assets import fixture_path
from zaru_tpu_torch.examples._common import take_device
from zaru_tpu_torch.image import decode as idec


def _missing(backend: str) -> str | None:
    """Why ``backend`` cannot decode here, or None."""
    if backend in ("cv2", "pil"):
        try:
            __import__("cv2" if backend == "cv2" else "PIL")
        except ImportError:
            return f"{'OpenCV' if backend == 'cv2' else 'PIL'} not installed"
    return None


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    take_device(argv)
    path = argv[0] if argv else fixture_path("sad_linus.jpg")
    iters = int(argv[1]) if len(argv) > 1 else 50
    with open(path, "rb") as f:
        data = f.read()

    saved = os.environ.get("ZARU_TPU_JPEG_BACKEND")
    try:
        for backend in ("cv2", "pil", "native"):
            missing = _missing(backend)
            if missing:
                print(f"{backend:>7}: skipped ({missing})")
                continue
            os.environ["ZARU_TPU_JPEG_BACKEND"] = backend
            try:
                idec.decode_jpeg(data)  # warm-up and availability check
            except RuntimeError as e:  # NativeUnavailable is one
                print(f"{backend:>7}: skipped ({e})")
                continue
            t0 = time.perf_counter()
            for _ in range(iters):
                rgb = idec.decode_jpeg(data)
            dt = (time.perf_counter() - t0) / iters
            mp = rgb.shape[0] * rgb.shape[1] / 1e6
            print(f"{backend:>7}: {dt * 1e3:7.2f} ms/frame  ({mp / dt:6.1f} MP/s)")
    finally:
        if saved is None:
            os.environ.pop("ZARU_TPU_JPEG_BACKEND", None)
        else:
            os.environ["ZARU_TPU_JPEG_BACKEND"] = saved


if __name__ == "__main__":
    main()
