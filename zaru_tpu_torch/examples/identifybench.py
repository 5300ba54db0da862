"""The identification step's device cost (examples/identifybench.py) on the
port: ``StreamIdentifier`` (track + 112² crops + MobileFaceNet + 1:N
gallery match, every stream each step) against the bare face cascade at
batch B with a G-row gallery of random embeddings. Each window ends in a
read to the host.

Usage: python -m zaru_tpu_torch.examples.identifybench [batch [gallery_rows]] [--device D]
(default 128 512; ``ZARU_TPU_IDB_SCAN`` steps a window, ``ZARU_TPU_IDB_WINDOWS``
windows)
"""

import os
import sys
import time

import numpy as np
import torch

from zaru_tpu_torch.bench_programs import tile_frames
from zaru_tpu_torch.examples._common import example_device, make_bench_frame

SCAN_STEPS = int(os.environ.get("ZARU_TPU_IDB_SCAN", "8"))
WINDOWS = int(os.environ.get("ZARU_TPU_IDB_WINDOWS", "4"))


@torch.inference_mode()
def main(argv=None):
    from zaru_tpu_torch.face.identify import StreamIdentifier

    argv = list(sys.argv[1:] if argv is None else argv)
    device = example_device(argv)
    batch = int(argv[0]) if argv else 128
    gallery_rows = int(argv[1]) if len(argv) > 1 else 512
    frame = make_bench_frame()
    print(f"device: {device}; batch={batch}, gallery={gallery_rows}, scan={SCAN_STEPS}", file=sys.stderr)

    sid = StreamIdentifier(device=device)
    rng = np.random.default_rng(7)
    sid.set_gallery([f"id{i}" for i in range(gallery_rows)], rng.normal(size=(gallery_rows, 128)).astype(np.float32))
    frames = tile_frames(frame, batch, device)
    state, out = sid.run_frames(sid.init_state(batch), frames)
    assert bool(out["valid"].all()), "tracking not established"

    arms = {
        "identify": sid.step,
        "track-only": sid.tracker.step_batch,
    }
    for name, step in arms.items():
        def run(st, frames, _step=step):
            sums = []
            for _ in range(SCAN_STEPS):
                st, out = _step(st, frames)
                sums.append(out["confidence"].sum())
            return float(torch.stack(sums).sum())

        t0 = time.perf_counter()
        run(state, frames)
        print(f"[{name}] first window: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        best = float("inf")
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            run(state, frames)
            best = min(best, (time.perf_counter() - t0) / SCAN_STEPS)
        print(f"batch {batch:3d} G={gallery_rows}  {name:10s} {best * 1e3:8.2f} ms/step ({batch / best:.0f} fps)")


if __name__ == "__main__":
    main()
