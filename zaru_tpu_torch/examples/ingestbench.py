"""Host ingest (examples/ingestbench.py) on the port: JPEG decode and its
scaling over threads, the host → device upload, and the decode → upload →
cascade loop at batch 8.

- ``decode`` runs on the host. Its input is the bench frame encoded at
  quality 90 with OpenCV, as JAX's; without an encoder, or for a decoder
  that is not there, the section writes a ``skipped`` record naming what is
  missing and no number from another backend;
- ``upload``: ``pipeline.ingest.measure_ingest_bandwidth`` at batches 8 and
  32 (page-locked host buffers, one copy a batch; ``link`` is ``pcie`` on a
  GPU, ``local`` on the CPU);
- ``e2e``: ``DecodePool`` → ``FrameUploader`` → the gated cascade
  (``run_frames_gated``), batch 8, six iterations after one warm-up; it
  needs the encoder and the native decoder, else a ``skipped`` record.

Usage: python -m zaru_tpu_torch.examples.ingestbench [out.jsonl] [sections...] [--device D]
  sections ∈ {decode, upload, e2e} (default: all)
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from zaru_tpu_torch._device import resolve_device
from zaru_tpu_torch.examples._common import bench_log as log
from zaru_tpu_torch.examples._common import make_bench_frame, make_emit, take_device


def make_1080p_jpeg(quality=90) -> bytes:
    """The bench frame as JPEG bytes, encoded by OpenCV (ImportError
    without it)."""
    import cv2

    frame = make_bench_frame()[..., :3]
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(frame, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return enc.tobytes()


def _backend_missing(backend: str, blob: bytes) -> str | None:
    """Why ``backend`` cannot decode ``blob`` here, or None (``image.decode``
    would fall back to cv2 for a module it cannot import: checked first)."""
    from zaru_tpu_torch.image.decode import decode_jpeg

    if backend == "cv2":
        try:
            import cv2  # noqa: F401
        except ImportError:
            return "OpenCV not installed"
    os.environ["ZARU_TPU_JPEG_BACKEND"] = backend
    try:
        decode_jpeg(blob)
    except RuntimeError as e:  # NativeUnavailable is one
        return str(e)
    return None


def _sections(out, which, device, blob, missing):
    emit = make_emit(out)
    if "decode" in which:
        from zaru_tpu_torch.image.decode import DecodePool, decode_jpeg

        for backend in ("cv2", "native"):
            why = missing or _backend_missing(backend, blob)
            if why:
                emit({"bench": "decode_1thread", "backend": backend, "skipped": why})
                continue
            os.environ["ZARU_TPU_JPEG_BACKEND"] = backend
            n = 40
            t0 = time.perf_counter()
            for _ in range(n):
                decode_jpeg(blob)
            dt = time.perf_counter() - t0
            emit({"bench": "decode_1thread", "backend": backend,
                  "ms_per_frame": round(dt / n * 1e3, 2), "fps": round(n / dt, 1)})

        # Thread-pool scaling on the native backend (libjpeg releases the
        # interpreter lock while it decodes).
        why = missing or _backend_missing("native", blob)
        ncpu = os.cpu_count() or 1
        if why:
            emit({"bench": "decode_pool", "backend": "native", "skipped": why})
        else:
            os.environ["ZARU_TPU_JPEG_BACKEND"] = "native"
            for threads in sorted({2, 4, min(8, max(2, ncpu)), ncpu}):
                if threads > max(2 * ncpu, 4):
                    break
                pool = DecodePool(threads)
                blobs = [blob] * (threads * 10)
                pool.decode_batch(blobs)  # a full warm round: first-touch allocations
                best = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    pool.decode_batch(blobs)
                    best = min(best, time.perf_counter() - t0)
                pool.close()
                emit({"bench": "decode_pool", "threads": threads, "fps": round(len(blobs) / best, 1), "ncpu": ncpu})

    link = "pcie" if device is not None and device.type == "cuda" else "local"
    if "upload" in which:
        from zaru_tpu_torch.pipeline.ingest import measure_ingest_bandwidth

        for batch in (8, 32):
            r = measure_ingest_bandwidth(batch=batch, iters=6, device=device)
            emit({"bench": "upload", "batch": batch, "link": link,
                  "gbytes_per_s": round(r["gbytes_per_s"], 3),
                  "frames_per_s": round(r["frames_per_s"], 1)})

    if "e2e" in which:
        why = missing or _backend_missing("native", blob)
        if why:
            emit({"bench": "e2e_ingest_cascade", "batch": 8, "link": link, "skipped": why})
            return
        from zaru_tpu_torch.image.decode import DecodePool
        from zaru_tpu_torch.pipeline import FaceTracker
        from zaru_tpu_torch.pipeline.ingest import FrameUploader

        B = 8
        pool = DecodePool(8)
        up = FrameUploader(batch=B, shape=(1080, 1920, 4), device=device)
        tracker = FaceTracker(device=device)
        state = tracker.init_state(B)
        alpha = np.full((1080, 1920, 1), 255, np.uint8)

        def stage_batch():
            t0 = time.perf_counter()
            frames = pool.decode_batch([blob] * B)
            t_dec = time.perf_counter() - t0
            for i, f in enumerate(frames):
                up.stage(i, np.concatenate([f, alpha], axis=-1))
            return t_dec

        stage_batch()  # warm: the first upload and step
        state, out = tracker.run_frames_gated(state, up.flush())
        out["confidence"].cpu()
        iters = 6
        t_dec_total = 0.0
        t0 = time.perf_counter()
        for _ in range(iters):
            t_dec_total += stage_batch()
            state, out = tracker.run_frames_gated(state, up.flush())
            conf = out["confidence"].cpu()
        dt = time.perf_counter() - t0
        pool.close()
        emit({
            "bench": "e2e_ingest_cascade", "batch": B, "link": link,
            "fps": round(B * iters / dt, 1),
            "decode_ms_per_batch": round(t_dec_total / iters * 1e3, 1),
            "tracked": float(conf.min()),
        })


@torch.inference_mode()
def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    named = take_device(argv)
    out = argv[0] if argv else os.path.join(tempfile.gettempdir(), "ingestbench.jsonl")
    which = set(argv[1:]) or {"decode", "upload", "e2e"}
    # The device sections need the device (cuda unless named); decoding does not.
    device = resolve_device(named) if which & {"upload", "e2e"} else None
    try:
        blob, missing = make_1080p_jpeg(), None
        log(f"1080p jpeg: {len(blob) / 1024:.0f} KiB")
    except ImportError as e:
        blob, missing = None, f"no JPEG encoder ({e})"
        log(f"1080p jpeg: {missing}")
    saved = os.environ.get("ZARU_TPU_JPEG_BACKEND")
    try:
        _sections(out, which, device, blob, missing)
    finally:
        if saved is None:
            os.environ.pop("ZARU_TPU_JPEG_BACKEND", None)
        else:
            os.environ["ZARU_TPU_JPEG_BACKEND"] = saved
    log("done")


if __name__ == "__main__":
    main()
