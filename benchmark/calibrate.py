"""Reads a cell's compared numbers over many seeds in one process, for the
limits that decide ``correct`` (``benchmark/limits/<cell>.json``).

    python3 benchmark/calibrate.py --workload face_v1.track_b512 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3 --out cal.jsonl

The program is built once in float32 and run on each of ``--seeds`` (the
sound readings, whose largest is a limit's lower reading), then once more
with its own lower-precision path (``program.control_dtype`` of the
configuration, bfloat16) on each of ``--control-seeds`` (the control, whose
smallest is the upper reading). Each run is a short window at the cell's
own load, checked against the reference as in ``run.py``. One JSON line a
run goes to ``--out`` and to standard output. Not run by the benchmark's
own runs.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import program
    from benchmark.harness.cell import Session, p95_ms, rate
    from benchmark.harness.spec import Spec

    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    cell = Spec(ROOT).cell(args.workload)
    module = importlib.import_module(f"benchmark.reference.{cell.config['reference']}")
    reference = module.Cascade(cell.config, ROOT / "assets" / "onnx", "cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as sink:
        for kind, seeds, dtype in (("sound", args.seeds, None),
                                   ("control", args.control_seeds, program.control_dtype(cell.config))):
            seeds = [int(s) for s in seeds.split(",") if s]
            if not seeds:
                continue
            session = Session(cell, ROOT, "cuda", dtype)
            for seed in seeds:
                t0 = time.perf_counter()
                o = session.run(seed, args.seconds, False, t0, reference=reference)
                line = {"workload": cell.name, "kind": kind, "seed": seed, "numbers": o.numbers,
                        "lost_after_first": o.lost_after_first, "steps": len(o.window.step_s),
                        "frames_per_s": rate(o.window.frames, o.window.seconds),
                        "frame_ms_p95": p95_ms(o.window.step_s), "seconds": time.perf_counter() - t0}
                print(json.dumps(line), flush=True)
                sink.write(json.dumps(line) + "\n")
            del session
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
