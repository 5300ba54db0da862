"""The multi-face cascade's steady state (examples/multifacebench.py) on the
port: ``MultiFaceTracker`` with every slot holding a synthetic face-sized
rotated ROI (the step's cost depends on shapes, not content) and
``loss_threshold=0`` keeping the slots alive, off the detect cadence.

Arms: ``gated`` (the gated step), ``sample-slots`` (the rotated-ROI kernel
on the ``[B,S,5]`` slot views), ``lm-cnn`` (Face Mesh V1 on pre-sampled
crops, one flat ``[B·S]`` batch as the step runs it: JAX's arm keeps a
nested ``vmap`` as the record of a slow XLA lowering, which has no
counterpart in eager torch) and ``track-slots`` (``_track_slots_batch``:
sampler, CNN, decode, next ROI). JAX's ``ZARU_TPU_MFB_ROLLED`` A/B sets the
TPU sampler's blocking and is not ported.

Usage: python -m zaru_tpu_torch.examples.multifacebench [batch [slots [arms]]] [--device D]
(default 64 4; ``arms`` a comma-separated subset; ``ZARU_TPU_MFB_SCAN`` steps a
window, ``ZARU_TPU_MFB_WINDOWS`` windows, each ending in a read to the host)
"""

import os
import sys

import torch

from zaru_tpu_torch.bench_programs import tile_frames
from zaru_tpu_torch.examples._common import example_device, make_bench_frame, run_slot_arms, slot_rois

SCAN_STEPS = int(os.environ.get("ZARU_TPU_MFB_SCAN", "8"))
WINDOWS = int(os.environ.get("ZARU_TPU_MFB_WINDOWS", "4"))


@torch.inference_mode()
def main(argv=None):
    from zaru_tpu_torch.pipeline import MultiFaceTracker, _ops

    argv = list(sys.argv[1:] if argv is None else argv)
    device = example_device(argv)
    batch = int(argv[0]) if argv else 64
    slots = int(argv[1]) if len(argv) > 1 else 4
    frame = make_bench_frame()
    print(f"device: {device}; batch={batch}x{slots}, scan={SCAN_STEPS}, windows={WINDOWS}", file=sys.stderr)

    tracker = MultiFaceTracker(max_faces=slots, loss_threshold=0.0, device=device)
    frames = tile_frames(frame, batch, device)
    lm_cnn = tracker.lm_cnn
    rois_np = slot_rois(batch, slots, 200, 500)

    def paths_of(state):
        rois = state["rois"]
        view_rects = _ops.aspect_view_rect(rois, lm_cnn.input_resolution())
        xs0 = lm_cnn.sample_views_fast(frames, view_rects, tracker.prescale_m, lm_cnn.layout)

        def gated(frames, st):
            st, out = tracker.step_batch(st, frames)
            return out["confidence"], st

        def sample_slots(frames, rrs):
            return lm_cnn.sample_views_fast(frames, rrs, tracker.prescale_m, lm_cnn.layout), rrs

        def lm_cnn_only(frames, xs):
            return lm_cnn.apply_samples(xs)[0], xs

        def track_slots(frames, rrs):
            _new_rois, conf, _extras, _pos = tracker._track_slots_batch(frames, rrs)
            return conf, rrs

        return {"gated": (gated, state), "sample-slots": (sample_slots, view_rects),
                "lm-cnn": (lm_cnn_only, xs0), "track-slots": (track_slots, rois)}

    run_slot_arms(tracker, frames, rois_np, paths_of, argv, SCAN_STEPS, WINDOWS,
                  lambda name, best: f"batch {batch:3d}x{slots}  {name:13s} {best * 1e3:8.2f} ms/step "
                                     f"({batch / best:.0f} fps, {batch * slots / best:.0f} faces/s)")


if __name__ == "__main__":
    main()
