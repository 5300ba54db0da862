"""Iris-cascade cadence (examples/irisbench.py) on the port: the production
cadence (detection forced every 9th step) with both eyes refined every step
(``FaceTracker(iris=True)``), at batch 128 unless given. The program is
``bench_programs.build_cascade_scan``; each window ends in a read to the
host. One JSON record, appended to ``out.jsonl`` and printed.

Usage: python -m zaru_tpu_torch.examples.irisbench [batch [out.jsonl]] [--device D]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

from zaru_tpu_torch.bench_programs import build_cascade_scan, tile_frames
from zaru_tpu_torch.examples._common import bench_log as log
from zaru_tpu_torch.examples._common import example_device, make_bench_frame

STEPS = 16
WINDOWS = 5


@torch.inference_mode()
def main(argv=None):
    from zaru_tpu_torch.pipeline import FaceTracker

    argv = list(sys.argv[1:] if argv is None else argv)
    device = example_device(argv)
    batch = int(argv[0]) if argv else 128
    out_path = argv[1] if len(argv) > 1 else os.path.join(tempfile.gettempdir(), "irisbench.jsonl")
    log(f"on {device}, batch {batch}")

    frames = tile_frames(make_bench_frame(), batch, device)
    tracker = FaceTracker(iris=True, device=device)
    run_scan = build_cascade_scan(tracker, STEPS, 9)

    t0 = time.perf_counter()
    state, confs = run_scan(tracker.init_state(batch), frames)
    confs = confs.cpu()
    log(f"first window {time.perf_counter() - t0:.1f}s conf {float(confs[-1].min()):.2f}")
    best = float("inf")
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        _s, confs = run_scan(state, frames)
        confs = confs.cpu()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"window {dt * 1e3:.0f} ms ({batch * STEPS / dt:.0f} fps)")
    rec = {
        "bench": "iris_cascade", "batch": batch,
        "ms_per_step": round(best / STEPS * 1e3, 2),
        "fps": round(batch * STEPS / best),
        "tracked": float(confs[-1].min()),
        "t": round(time.time()),
    }
    with open(out_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
