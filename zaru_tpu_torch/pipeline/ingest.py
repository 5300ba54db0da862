"""Host → device frame ingest (zaru_tpu/pipeline/ingest.py:28
``FrameUploader``, :73 ``measure_ingest_bandwidth``).

Frames travel as uint8 RGBA (4 B/px; the samplers map colour on the
device), batched into one contiguous ``[B,H,W,4]`` transfer a step. The
uploader is double-buffered, so the host fills batch N+1 while batch N
crosses the bus and the device steps on it:

- **staging**: two host tensors ``[B,H,W,4] u8``, page-locked on CUDA
  (``pin_memory=True``), so the copy engine reads them directly and the
  copy can run while the host works;
- **copies**: ``flush()`` starts a ``non_blocking`` host → device copy of
  the staged batch on the uploader's own CUDA stream, into one of two
  device buffers allocated once, records an event on that stream, and makes
  the caller's current stream wait on the event before it returns the
  device buffer;
- **fences**: ``stage()`` into a staging buffer whose copy may still run
  first waits on that copy's event (on the host); a copy into a device
  buffer first waits (on the copy stream) for the work the caller queued
  on it before the previous flush, so a step still reading batch N is not
  overwritten by batch N+2. The JAX uploader leaned on the serve loop's
  per-step host read for the first fence (ingest.py:52-67); this one fences
  with the events themselves.

A returned device batch stays valid until the flush after next. On the
CPU the same calls copy between plain tensors.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["FrameUploader", "measure_ingest_bandwidth"]


class FrameUploader:
    """Double-buffered batched frame uploader onto ``device`` (``cuda``
    unless named).

    Usage::

        up = FrameUploader(batch=8, shape=(1080, 1920, 4))
        up.stage(i, frame_np)     # fill slots of the staging batch
        frames = up.flush()       # async upload; returns the device batch

    ``stage_seconds`` and ``flush_seconds`` sum the host time spent in each
    call (the host copy into staging, and starting the upload).
    """

    def __init__(self, batch: int, shape: tuple[int, int, int], device=None):
        self.batch = batch
        self.shape = tuple(shape)
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        full = (batch, *self.shape)
        self._staging = [torch.zeros(full, dtype=torch.uint8, pin_memory=cuda) for _ in range(2)]
        self._staging_np = [t.numpy() for t in self._staging]
        self._dev = [torch.empty(full, dtype=torch.uint8, device=self.device) for _ in range(2)]
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        # copied[k]: the copy out of staging k and into device buffer k
        # ended; consumed[k]: the work queued on the caller's stream before
        # the flush that followed buffer k's (the step that read it) ended.
        self._copied = [None, None]
        self._consumed = [None, None]
        self._cur = 0
        self._fenced = False
        self.stage_seconds = 0.0
        self.flush_seconds = 0.0

    def stage(self, slot: int, frame) -> None:
        """Copies ``frame [H,W,4] u8`` (numpy) into slot ``slot`` of the
        staging batch."""
        t0 = time.perf_counter()
        k = self._cur
        if not self._fenced:
            if self._copied[k] is not None:
                self._copied[k].synchronize()
            self._fenced = True
        np.copyto(self._staging_np[k][slot], frame)
        self.stage_seconds += time.perf_counter() - t0

    def flush(self) -> torch.Tensor:
        """Starts the upload of the staged batch and returns its device
        buffer ``[B,H,W,4] u8``; work the caller queues on its current
        stream after this call sees the whole batch."""
        t0 = time.perf_counter()
        k = self._cur
        dev, staging = self._dev[k], self._staging[k]
        if self._stream is None:
            dev.copy_(staging)
        else:
            caller = torch.cuda.current_stream(self.device)
            # The step that read device buffer k^1 was queued before this
            # call: a later flush into k^1 waits for it.
            self._consumed[k ^ 1] = caller.record_event()
            with torch.cuda.stream(self._stream):
                if self._consumed[k] is not None:
                    self._stream.wait_event(self._consumed[k])
                dev.copy_(staging, non_blocking=True)
                self._copied[k] = self._stream.record_event()
            caller.wait_event(self._copied[k])
        self._cur ^= 1
        self._fenced = False
        self.flush_seconds += time.perf_counter() - t0
        return dev


def measure_ingest_bandwidth(batch: int = 8, shape=(1080, 1920, 4), iters: int = 20, device=None) -> dict:
    """Sustained host → device upload rate of uint8 frame batches from
    page-locked host memory onto ``device`` (``cuda`` unless named):
    ``{"gbytes_per_s", "frames_per_s"}``.

    Each upload is followed by a device → host read of a small reduction
    over the uploaded bytes, which cannot end before the copy has, so the
    clock stops when the data is on the device (not when the copy was
    queued)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    full = (batch, *shape)
    bufs = []
    for _ in range(2):
        buf = torch.empty(full, dtype=torch.uint8, pin_memory=dev.type == "cuda")
        buf.copy_(torch.randint(0, 256, full, generator=gen, dtype=torch.uint8))
        bufs.append(buf)

    def touch(x):
        return int(x[:, ::97, ::97].to(torch.int32).sum())

    touch(bufs[0].to(dev, non_blocking=True))  # warm-up
    t0 = time.perf_counter()
    for i in range(iters):
        touch(bufs[i % 2].to(dev, non_blocking=True))
    dt = time.perf_counter() - t0
    nbytes = batch * int(np.prod(shape)) * iters
    return {"gbytes_per_s": nbytes / dt / 1e9, "frames_per_s": batch * iters / dt}
