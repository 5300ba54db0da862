"""Shared helpers for the examples (examples/_common.py): the ``--device``
option and a frame source that falls back from a file to the webcam to the
bundled photo, so every example also runs headless; and the measurement
scripts' protocol: the bench frame, window timing that ends each window in
a read to the host, and JSONL records.

An image argument ending in ``.npy`` is an ``[H, W, 3|4]`` uint8 array, as
``eval --input`` reads it, so a machine without an image decoder can feed
an example.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from zaru_tpu_torch._device import resolve_device
from zaru_tpu_torch.assets import fixture_path
from zaru_tpu_torch.image import Image

__all__ = [
    "bench_log", "example_device", "frame_source", "load_image", "lose_stream0", "make_bench_frame", "make_emit",
    "run_slot_arms", "slot_rois", "take_device", "timed_windows", "timed_windows_stats",
]


def take_device(argv: list) -> str | None:
    """Removes ``--device D`` (or ``--device=D``) from ``argv`` in place and
    returns ``D``, or None when it is not there."""
    for i, arg in enumerate(argv):
        if arg == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device needs a value (cuda, cuda:1, cpu, ...)")
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if arg.startswith("--device="):
            del argv[i]
            return arg.split("=", 1)[1]
    return None


def example_device(argv: list | None = None) -> torch.device:
    """The device named by ``--device`` in ``argv`` (``sys.argv`` unless
    given; the option is taken out of it), ``cuda`` unless named. Without
    a GPU, ``cuda`` raises (``resolve_device``), as the CLI's ``--device``
    does."""
    return resolve_device(take_device(sys.argv if argv is None else argv))


def load_image(path, device) -> Image:
    """An image file (or a ``.npy`` uint8 array) as an image on ``device``."""
    if str(path).endswith(".npy"):
        return Image.from_array(np.load(path), device)
    return Image.load(path, device)


def frame_source(device, argv: list | None = None, loop_static: int = 30):
    """Yields frames on ``device``: from a file given on the command line,
    else the webcam, else the bundled photo (repeated ``loop_static``
    times, or ``ZARU_TPU_EXAMPLE_FRAMES`` for quick runs). ``--device`` is
    taken out of ``argv`` before the file is read from it."""
    loop_static = int(os.environ.get("ZARU_TPU_EXAMPLE_FRAMES", loop_static))
    argv = list(sys.argv[1:] if argv is None else argv)
    take_device(argv)
    if argv:
        img = load_image(argv[0], device)
        for _ in range(loop_static):
            yield img
        return
    try:
        from zaru_tpu_torch.video.webcam import Webcam, WebcamOptions

        cam = Webcam.open(WebcamOptions(), device=device)
    except RuntimeError:
        # No usable camera: loop the photo. Only a failure to open falls
        # back; a read error mid-stream must surface.
        img = Image.load(fixture_path("sad_linus.jpg"), device)
        for _ in range(loop_static):
            yield img
        return
    try:
        while True:
            yield cam.read()
    finally:
        cam.close()


# --- the measurement scripts' protocol ----------------------------------


def bench_log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_emit(out_path):
    """A JSONL appender: each record, with its wall-clock second ``t``, goes
    to ``out_path`` and to stderr, so a run that dies still leaves data."""

    def emit(rec):
        rec = dict(rec, t=round(time.time()))
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        bench_log("RESULT", json.dumps(rec))

    return emit


def make_bench_frame() -> np.ndarray:
    """The bench frame, the one recipe every measurement script times:
    :func:`zaru_tpu_torch.bench_programs.make_1080p_frame`."""
    from zaru_tpu_torch.bench_programs import make_1080p_frame

    return make_1080p_frame()


def lose_stream0(state: dict) -> dict:
    """A tracker state with stream 0 marked lost (the gate's worst case:
    the next step detects every stream)."""
    tracking = state["tracking"].clone()
    tracking[0] = False
    return dict(state, tracking=tracking)


def _readback(x):
    """The first tensor leaf of ``x`` (nested dicts, lists and tuples; dicts
    in insertion order) read to the host: the read waits for the work queued
    before it on the device."""
    while isinstance(x, (dict, list, tuple)):
        x = next(iter(x.values())) if isinstance(x, dict) else x[0]
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def timed_windows_stats(fn, *args, n=4, label=""):
    """``n`` timed calls of ``fn(*args)`` after one untimed call (the
    kernels' build, cuDNN's choice of algorithm, the first launch), each
    ending in a read of its result's first tensor leaf to the host →
    ``{"best", "median", "spread", "n"}`` seconds."""
    t0 = time.perf_counter()
    _readback(fn(*args))
    bench_log(f"[{label}] first call: {time.perf_counter() - t0:.1f}s")
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        _readback(fn(*args))
        dt = time.perf_counter() - t0
        samples.append(dt)
        bench_log(f"[{label}] window {dt * 1e3:.1f} ms")
    return {
        "best": min(samples),
        "median": float(np.median(samples)),
        "spread": max(samples) - min(samples),
        "n": len(samples),
    }


def timed_windows(fn, *args, n=4, label=""):
    """The best of ``n`` windows, in seconds (:func:`timed_windows_stats`)."""
    return timed_windows_stats(fn, *args, n=n, label=label)["best"]


def slot_rois(batch, slots, size_lo, size_hi):
    """Seeded rotated ROIs ``[B,S,5]`` spread over the 1080p frame, sides
    of ``size_lo``-``size_hi`` px (the slots of the multi-object benches)."""
    rng = np.random.default_rng(3)
    return np.stack([
        np.stack([
            rng.uniform(300, 1600, slots), rng.uniform(200, 900, slots),
            rng.uniform(size_lo, size_hi, slots), rng.uniform(size_lo, size_hi, slots),
            rng.uniform(-3.0, 3.0, slots),
        ], axis=-1)
        for _ in range(batch)
    ]).astype(np.float32)


def run_slot_arms(tracker, frames, rois_np, paths_of, argv, steps, windows, line):
    """The steady state on the seeded slots ``rois_np [B,S,5]``: builds the
    arms (``paths_of(state) -> {name: (fn(frames, carry) -> (out, carry),
    carry0)}``), keeps the ones ``argv[2]`` names, and prints
    ``line(name, best seconds a step)`` for each, the best of ``windows``
    windows of ``steps`` steps."""
    batch, slots = rois_np.shape[:2]
    device = frames.device
    state = dict(
        tracker.init_state(batch),
        rois=torch.from_numpy(rois_np).to(device),
        active=torch.ones((batch, slots), dtype=torch.bool, device=device),
        frame=torch.ones((batch,), dtype=torch.int32, device=device),  # off the detect cadence
    )
    paths = paths_of(state)
    if len(argv) > 2:
        wanted = set(argv[2].split(","))
        unknown = wanted - set(paths)
        if unknown:
            sys.exit(f"unknown arms {sorted(unknown)}; have {sorted(paths)}")
        paths = {k: v for k, v in paths.items() if k in wanted}
    for name, (fn, carry0) in paths.items():
        def run(fn=fn, carry0=carry0):
            carry, sums = carry0, []
            for _ in range(steps):
                outv, carry = fn(frames, carry)
                sums.append(outv.sum())
            return float(torch.stack(sums).sum())

        t0 = time.perf_counter()
        run()
        print(f"[{name}] first window: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        best = float("inf")
        for _ in range(windows):
            t0 = time.perf_counter()
            run()
            best = min(best, (time.perf_counter() - t0) / steps)
        print(line(name, best))
