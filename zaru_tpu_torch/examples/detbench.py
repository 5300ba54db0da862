"""The detect branch's stages (examples/detbench.py) on the port.

- ``letterbox-exact`` the full-frame letterbox to the detector's input
  through the exact sampler (``ops/sampling.view_to_tensor_core``);
- ``letterbox-fast``  the same view through the rotated-ROI kernel;
- ``letterbox-takes`` the same view through the letterbox kernel, the
  detect path's own (equal to ``letterbox-exact`` at angle 0);
- ``det-cnn``         BlazeFace on pre-sampled inputs;
- ``detect-roi``      the whole detection with exact sampling: JAX's
  per-stream ``_detect_roi`` under ``vmap`` is the port's batched
  ``_detect_batch(frames, exact=True)``;
- ``track-batch``     the landmark half (``_track_batch``, the kernel's
  crops), for reference.

Samples are taken in the layout BlazeFace reads (planar). Each window is
``ZARU_TPU_DB_SCAN`` calls and ends in a read to the host; a line per stage
gives the best of ``ZARU_TPU_DB_WINDOWS``.

Usage: python -m zaru_tpu_torch.examples.detbench [batch] [--device D]   (default 128)
"""

import os
import sys
import time

import torch

from zaru_tpu_torch.bench_programs import tile_frames
from zaru_tpu_torch.examples._common import example_device, make_bench_frame

SCAN_STEPS = int(os.environ.get("ZARU_TPU_DB_SCAN", "16"))
WINDOWS = int(os.environ.get("ZARU_TPU_DB_WINDOWS", "4"))


@torch.inference_mode()
def main(argv=None):
    from zaru_tpu_torch.ops.sampling import view_to_tensor_core
    from zaru_tpu_torch.pipeline import FaceTracker, _ops

    argv = list(sys.argv[1:] if argv is None else argv)
    device = example_device(argv)
    batch = int(argv[0]) if argv else 128
    frame = make_bench_frame()
    print(f"device: {device}; batch={batch}, scan={SCAN_STEPS}, windows={WINDOWS}", file=sys.stderr)

    tracker = FaceTracker(device=device)
    det_cnn = tracker.det_cnn
    res = det_cnn.input_resolution()
    frames = tile_frames(frame, batch, device)
    state, out = tracker.run_frames(tracker.init_state(batch), frames)
    assert bool(out["valid"].all())
    rois = out["roi"]
    _fit, fit_rrect = _ops.full_frame_fit(frames, res)
    rrs = fit_rrect.expand(batch, 5).contiguous()
    w, h, lo, hi, layout = res.width, res.height, det_cnn.mapper.lo, det_cnn.mapper.hi, det_cnn.layout
    ones, zeros = torch.ones_like(state["tracking"]), torch.zeros_like(state["tracking"])
    xs_det = det_cnn.sample_views_letterbox(frames, rrs, layout)

    paths = {
        "letterbox-exact": lambda: view_to_tensor_core(frames, rrs, w, h, lo, hi, layout),
        "letterbox-fast": lambda: det_cnn.sample_views_fast(frames, rrs, layout=layout),
        "letterbox-takes": lambda: det_cnn.sample_views_letterbox(frames, rrs, layout),
        "det-cnn": lambda: det_cnn.apply_samples(xs_det)[0],
        "detect-roi": lambda: tracker._detect_batch(frames, exact=True)[0],
        "track-batch": lambda: tracker._track_batch(state, frames, rois, ones, zeros, exact=False,
                                                    eyes_exact=False)[1]["confidence"],
    }
    for name, fn in paths.items():
        def run(fn=fn):
            return float(torch.stack([fn().sum() for _ in range(SCAN_STEPS)]).sum())

        run()  # first window
        best = float("inf")
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            run()
            best = min(best, (time.perf_counter() - t0) / SCAN_STEPS)
        print(f"batch {batch:4d}  {name:16s} {best * 1e3:8.2f} ms/step")


if __name__ == "__main__":
    main()
