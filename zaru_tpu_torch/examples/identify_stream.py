"""Batched stream identification demo.

Enrolls faces from images (name = file stem), then tracks and identifies
every stream of a batch each frame in one step
(``face.identify.StreamIdentifier``): the gated cascade, rotated 112×112
crops, one batched MobileFaceNet pass and the gallery match on the device.

Usage:
  python -m zaru_tpu_torch.examples.identify_stream <enroll-img> [<enroll-img> ...]
      [--stream IMG] [--batch N] [--frames N] [--device D]

Defaults: enrolls the cropped photo, streams the full photo (the same
person: expect a match at a unit-sphere distance of about 0.4).
"""

import argparse
import sys
import time
from pathlib import Path

import torch

from zaru_tpu_torch import gui
from zaru_tpu_torch.assets import fixture_path
from zaru_tpu_torch.examples._common import example_device, load_image
from zaru_tpu_torch.face.identify import FaceIdentifier, StreamIdentifier


def main():
    device = example_device()
    ap = argparse.ArgumentParser()
    ap.add_argument("enroll", nargs="*", help="images to enroll (name = stem)")
    ap.add_argument("--stream", help="image to run as the stream frames")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()

    enroll = args.enroll or [str(fixture_path("sad_linus_cropped.jpg"))]
    stream = args.stream or str(fixture_path("sad_linus.jpg"))

    ident = FaceIdentifier(device=device)
    for p in enroll:
        ok = ident.enroll(Path(p).stem, load_image(p, device))
        print(f"enroll {Path(p).stem}: {'ok' if ok else 'NO FACE'}")
    if not len(ident):
        print("nothing enrolled", file=sys.stderr)
        return 1

    sid = StreamIdentifier(device=device)
    sid.adopt(ident)
    frames = torch.stack([load_image(stream, device).data] * args.batch)
    state = sid.init_state(batch=args.batch)

    for t in range(args.frames):
        t0 = time.perf_counter()
        state, out = sid.run_frames(state, frames)
        idents = out["identity"].cpu().numpy()
        dists = out["identity_distance"].cpu().numpy()
        dt = time.perf_counter() - t0
        names = [sid.names[i] if i >= 0 else "<unknown>" for i in idents]
        print(f"frame {t}: {list(zip(names, dists.round(3).tolist()))} "
              f"({dt * 1e3:.1f} ms)")
    return 0


if __name__ == "__main__":
    gui.run(main)
