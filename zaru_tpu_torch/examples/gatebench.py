"""The batched cascade's paths (examples/gatebench.py) on the port: the
cost of the batch-level detection gate.

- ``vmap``           the ungated step (``run_frames``, JAX's
                     ``vmap(step)``): exact crops, and a detection for
                     every stream whenever one is lost;
- ``gated``          ``step_batch``: detection only when some stream is
                     lost, crops through the rotated-ROI kernel;
- ``gated-worst``    the gated step with stream 0 lost after every step
                     (detection for every stream every step);
- ``landmark-only``  the landmark half alone (``_track_batch``, the kernel's
                     crops): the gated step's floor;
- ``landmark-exact`` the same with the exact sampler (JAX's per-stream
                     ``_track`` under ``vmap``: ``_track_batch(exact=True)``).

Usage: python -m zaru_tpu_torch.examples.gatebench [batch ...] [--device D]
(default 8 128). One line per (batch, path): frames/s, the best of
``ZARU_TPU_GATE_WINDOWS`` windows of ``ZARU_TPU_GATE_SCAN`` steps, each window
ending in a read to the host.
"""

import os
import sys
import time

import torch

from zaru_tpu_torch.bench_programs import tile_frames
from zaru_tpu_torch.examples._common import example_device, lose_stream0, make_bench_frame

SCAN_STEPS = int(os.environ.get("ZARU_TPU_GATE_SCAN", "32"))
WINDOWS = int(os.environ.get("ZARU_TPU_GATE_WINDOWS", "4"))


@torch.inference_mode()
def main(argv=None):
    from zaru_tpu_torch.pipeline import FaceTracker

    argv = list(sys.argv[1:] if argv is None else argv)
    device = example_device(argv)
    batches = [int(a) for a in argv] or [8, 128]
    frame = make_bench_frame()
    print(f"device: {device}; scan={SCAN_STEPS}, windows={WINDOWS}", file=sys.stderr)

    for batch in batches:
        tracker = FaceTracker(device=device)
        frames = tile_frames(frame, batch, device)
        state, out = tracker.run_frames(tracker.init_state(batch), frames)  # establish tracking
        assert bool(out["valid"].all()), "tracking not established"
        ones, zeros = torch.ones_like(state["tracking"]), torch.zeros_like(state["tracking"])

        def scan_of(step_fn, init):
            def run(st, frames):
                confs = []
                for _ in range(SCAN_STEPS):
                    st, out = step_fn(st, frames)
                    confs.append(out["confidence"].sum())
                return float(torch.stack(confs).sum())

            return run, init

        def landmark_only_step(st, frames):
            return tracker._track_batch(st, frames, st["roi"], ones, zeros, exact=False, eyes_exact=False)

        def landmark_only_exact_step(st, frames):
            return tracker._track_batch(st, frames, st["roi"], ones, zeros, exact=True, eyes_exact=True)

        def gated_worst_step(st, frames):
            st2, out = tracker.step_batch(st, frames)
            return lose_stream0(st2), out  # stream 0 lost again: every step detects

        paths = {
            "vmap": scan_of(tracker.run_frames, state),
            "gated": scan_of(tracker.step_batch, state),
            "gated-worst": scan_of(gated_worst_step, lose_stream0(state)),
            "landmark-only": scan_of(landmark_only_step, state),
            "landmark-exact": scan_of(landmark_only_exact_step, state),
        }
        for name, (run, init) in paths.items():
            run(init, frames)  # first window
            best = 0.0
            for _ in range(WINDOWS):
                t0 = time.perf_counter()
                run(init, frames)
                best = max(best, batch * SCAN_STEPS / (time.perf_counter() - t0))
            print(f"batch {batch:4d}  {name:14s} {best:12.0f} fps")


if __name__ == "__main__":
    main()
