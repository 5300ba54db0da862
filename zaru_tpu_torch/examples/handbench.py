"""The multi-hand cascade's cost split (examples/handbench.py) on the port,
at 64 streams x 4 slots unless given. The photo has no hand, so every slot
holds a seeded hand-sized rotated ROI (the step's cost depends on shapes,
not content) and ``presence_threshold=0`` keeps the slots alive; detection
then runs only on the interval cadence, so ``gated`` is the steady state.

- ``gated``        the gated step, every slot tracking
- ``sample-slots`` the rotated-ROI kernel on the ``[B,S,5]`` slot views
- ``lm-cnn``       the hand landmark CNN on pre-sampled crops, one flat
                   ``[B·S]`` batch as the step runs it
- ``detect``       the batched palm-detect branch (letterbox + CNN + NMS)
- ``track-slots``  sampler + CNN + decode + next ROI (``_track_slots_batch``)

Usage: python -m zaru_tpu_torch.examples.handbench [batch [slots [arms]]] [--device D]
(default 64 4; ``arms`` a comma-separated subset; ``ZARU_TPU_HB_SCAN`` steps a
window, ``ZARU_TPU_HB_WINDOWS`` windows, each ending in a read to the host)
"""

import os
import sys

import torch

from zaru_tpu_torch.bench_programs import tile_frames
from zaru_tpu_torch.examples._common import example_device, make_bench_frame, run_slot_arms, slot_rois

SCAN_STEPS = int(os.environ.get("ZARU_TPU_HB_SCAN", "8"))
WINDOWS = int(os.environ.get("ZARU_TPU_HB_WINDOWS", "4"))


@torch.inference_mode()
def main(argv=None):
    from zaru_tpu_torch.pipeline import MultiHandTracker, _ops

    argv = list(sys.argv[1:] if argv is None else argv)
    device = example_device(argv)
    batch = int(argv[0]) if argv else 64
    slots = int(argv[1]) if len(argv) > 1 else 4
    frame = make_bench_frame()
    print(f"device: {device}; batch={batch}x{slots}, scan={SCAN_STEPS}, windows={WINDOWS}", file=sys.stderr)

    tracker = MultiHandTracker(max_hands=slots, presence_threshold=0.0, device=device)
    frames = tile_frames(frame, batch, device)
    lm_cnn = tracker.lm_cnn
    rois_np = slot_rois(batch, slots, 180, 320)

    def paths_of(state):
        rois = state["rois"]
        view_rects = _ops.aspect_view_rect(rois, lm_cnn.input_resolution())
        xs0 = lm_cnn.sample_views_fast(frames, view_rects, tracker.prescale_m, lm_cnn.layout)

        def gated(frames, st):
            st, out = tracker.step_batch(st, frames)
            return out["presence"], st

        def sample_slots(frames, rrs):
            return lm_cnn.sample_views_fast(frames, rrs, tracker.prescale_m, lm_cnn.layout), rrs

        def lm_cnn_only(frames, xs):
            return lm_cnn.apply_samples(xs)[0], xs

        def detect(frames, carry):
            cand_rois, _cand_valid = tracker._detect_batch(frames)
            return cand_rois, carry

        def track_slots(frames, rrs):
            _new_rois, conf, _extras, _pos = tracker._track_slots_batch(frames, rrs)
            return conf, rrs

        return {"gated": (gated, state), "sample-slots": (sample_slots, view_rects),
                "lm-cnn": (lm_cnn_only, xs0), "detect": (detect, None), "track-slots": (track_slots, rois)}

    run_slot_arms(tracker, frames, rois_np, paths_of, argv, SCAN_STEPS, WINDOWS,
                  lambda name, best: f"batch {batch:3d}x{slots}  {name:14s} {best * 1e3:8.2f} ms/step "
                                     f"({batch / best:.0f} fps)")


if __name__ == "__main__":
    main()
