"""Runs one cell of the benchmark of ``zaru_tpu_torch`` once and prints its
result as the last line of standard output.

    python3 benchmark/run.py --workload face_v1.track_b512 --seed 7 --seconds 30 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``,
the program (``zaru_tpu_torch``) and its models (``assets/onnx``), on a
machine with as many CUDA devices as the cell asks for. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones,
read from a profiled span of whole steps inside the window. Every run
checks the window's outputs against the plain reference
(``benchmark/reference``) and prints each compared number beside its
limit, last on standard error and last in the result's line.

Exit codes: 0 with a result; 2 without the CUDA devices the cell needs; 3
when JAX or the JAX package was loaded; any other failure raises.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "zaru_tpu"}  # top-level module names, compared whole


def _caches():
    """Every kernel and build cache at a fixed path inside the checkout (the
    program builds its CUDA libraries into ``zaru_tpu_torch/_build``)."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def loaded_forbidden() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.report import result
    from benchmark.harness.spec import Spec

    cell = Spec(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    out, checks = result(cell, ROOT, args.seed, args.seconds, bool(args.trace), T_START, "cuda")
    bad = loaded_forbidden()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
