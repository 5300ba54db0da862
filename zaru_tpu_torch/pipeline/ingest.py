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

Given a :class:`~zaru_tpu_torch.parallel.StreamSharding` (a
``ShardedTracker``'s ``frame_sharding``) as its device, the uploader stages
straight into the stream-sharded layout: each shard has its own pair of
device buffers on its device, its own copy stream there and its own
fences, the staging batch is copied slice by slice to each shard's device,
and ``flush()`` returns a :class:`~zaru_tpu_torch.parallel.Sharded` batch,
which ``ShardedTracker.step_gated`` takes with no second transfer
(zaru_tpu/pipeline/ingest.py: ``device=`` a ``NamedSharding``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.mesh import Sharded, StreamSharding

__all__ = ["FrameUploader", "measure_ingest_bandwidth"]


class _Lane:
    """One device's share of the uploader: streams ``[start, stop)`` of the
    batch, two device buffers, a copy stream on CUDA, and the fences
    (``copied[k]``: the copy out of staging k into device buffer k ended;
    ``consumed[k]``: the work queued on the caller's stream before the flush
    that followed buffer k's, the step that read it, ended)."""

    def __init__(self, device: torch.device, start: int, stop: int, shape: tuple):
        self.device, self.start, self.stop = device, start, stop
        self.dev = [torch.empty((stop - start, *shape), dtype=torch.uint8, device=device) for _ in range(2)]
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.copied = [None, None]
        self.consumed = [None, None]

    def flush(self, k: int, staging: torch.Tensor) -> torch.Tensor:
        dev, part = self.dev[k], staging[self.start:self.stop]
        if self.stream is None:
            dev.copy_(part)
            return dev
        caller = torch.cuda.current_stream(self.device)
        # The step that read device buffer k^1 was queued before this
        # call: a later flush into k^1 waits for it.
        self.consumed[k ^ 1] = caller.record_event()
        with torch.cuda.stream(self.stream):
            if self.consumed[k] is not None:
                self.stream.wait_event(self.consumed[k])
            dev.copy_(part, non_blocking=True)
            self.copied[k] = self.stream.record_event()
        caller.wait_event(self.copied[k])
        return dev


class FrameUploader:
    """Double-buffered batched frame uploader onto ``device`` (``cuda``
    unless named), or onto a mesh's devices, shard by shard, given a
    ``StreamSharding``.

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
        if isinstance(device, StreamSharding):
            self.device = device
            lanes = [(d, a, b) for d, (a, b) in zip(device.mesh, device.bounds(batch))]
        else:
            self.device = resolve_device(device)
            lanes = [(self.device, 0, batch)]
        self._lanes = [_Lane(d, a, b, self.shape) for d, a, b in lanes]
        cuda = any(lane.stream is not None for lane in self._lanes)
        full = (batch, *self.shape)
        self._staging = [torch.zeros(full, dtype=torch.uint8, pin_memory=cuda) for _ in range(2)]
        self._staging_np = [t.numpy() for t in self._staging]
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
            for lane in self._lanes:
                if lane.copied[k] is not None:
                    lane.copied[k].synchronize()
            self._fenced = True
        np.copyto(self._staging_np[k][slot], frame)
        self.stage_seconds += time.perf_counter() - t0

    def flush(self):
        """Starts the upload of the staged batch and returns its device
        buffer ``[B,H,W,4] u8`` (a ``Sharded`` batch over a mesh); work the
        caller queues on each device's current stream after this call sees
        that device's whole share of the batch."""
        t0 = time.perf_counter()
        k = self._cur
        parts = [lane.flush(k, self._staging[k]) for lane in self._lanes]
        self._cur ^= 1
        self._fenced = False
        self.flush_seconds += time.perf_counter() - t0
        return Sharded(parts) if isinstance(self.device, StreamSharding) else parts[0]


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
