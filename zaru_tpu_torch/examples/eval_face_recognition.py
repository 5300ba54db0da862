"""Face recognition evaluation.

Usage: python -m zaru_tpu_torch.examples.eval_face_recognition <dir-with-person-subdirs> [--device D]

Each subdirectory holds images of one person; prints intra- and
inter-person embedding distances and the verification accuracy at the
best threshold.
"""

import itertools
import sys
from pathlib import Path

import numpy as np

from zaru_tpu_torch import gui
from zaru_tpu_torch._device import resolve_device
from zaru_tpu_torch.detection import Detector
from zaru_tpu_torch.examples._common import load_image, take_device
from zaru_tpu_torch.face.detection import ShortRangeNetwork
from zaru_tpu_torch.face.recognition import Embedder, embedding_distance


def main():
    device = take_device(sys.argv)
    if len(sys.argv) < 2:
        print("usage: eval_face_recognition <dir> [--device D]")
        return 2
    device = resolve_device(device)
    root = Path(sys.argv[1])
    detector = Detector(ShortRangeNetwork(device=device))
    embedder = Embedder(device=device)

    embeddings: dict[str, list[np.ndarray]] = {}
    for person_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        for img_path in sorted(person_dir.iterdir()):
            image = load_image(img_path, device)
            dets = list(detector.detect(image))
            if not dets:
                print(f"skip {img_path}: no face")
                continue
            det = max(dets, key=lambda d: d.confidence())
            crop = det.bounding_rect().grow_rel(0.2)
            emb = embedder.embed(image.view(crop))
            embeddings.setdefault(person_dir.name, []).append(emb)

    intra, inter = [], []
    people = list(embeddings)
    for person, embs in embeddings.items():
        for a, b in itertools.combinations(embs, 2):
            intra.append(embedding_distance(a, b))
    for pa, pb in itertools.combinations(people, 2):
        for a in embeddings[pa]:
            for b in embeddings[pb]:
                inter.append(embedding_distance(a, b))

    print(f"intra-person distance: mean {np.mean(intra):.3f}" if intra else "no intra pairs")
    print(f"inter-person distance: mean {np.mean(inter):.3f}" if inter else "no inter pairs")
    if intra and inter:
        # Select and report the balanced accuracy (mean of TPR and TNR):
        # with imbalanced pair counts the pooled accuracy's optimum is
        # another threshold.
        ia, ie = np.array(intra), np.array(inter)
        thresholds = np.linspace(0, max(inter), 200)

        def balanced(t):
            return ((ia < t).mean() + (ie >= t).mean()) / 2.0

        best = max(thresholds, key=balanced)
        print(
            f"best threshold {best:.3f}: balanced accuracy "
            f"{balanced(best):.3f} (TPR {(ia < best).mean():.3f}, "
            f"TNR {(ie >= best).mean():.3f})"
        )


if __name__ == "__main__":
    gui.run(main)
