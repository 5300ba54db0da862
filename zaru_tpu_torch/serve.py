"""The multi-stream serving loop and its host policies
(zaru_tpu/serve.py: ``SlotEvent`` :36, ``StreamSet`` :44,
``reset_state_slots`` :213, ``ServeStats`` :237; the loop of
zaru_tpu/__main__.py:316-391 ``cmd_serve``).

The serving contract is a loop that survives a flaky camera indefinitely
(reference webcam.rs:291-313 decodes corrupt frames to blanks and keeps
going):

- :class:`StreamSet`: per-slot frame sources decoded on a thread pool, one
  in-flight decode per stream (that bound IS the backpressure), a
  non-blocking drop policy (a stream whose decode missed the step deadline
  re-serves its previous frame and counts a drop; the device loop never
  stalls on a slow source), and join/leave: a finite source that ends
  frees its slot, the next pending input joins into it;
- :func:`reset_state_slots`: a tracker state with the joined slots reset
  to a fresh state's, so a new stream re-detects instead of inheriting the
  previous occupant's ROI; on the state's device, no host round trip;
- :class:`ServeStats`: step-latency/drop/fps accounting (a step's time is
  its whole period, the gather of the next frames included), the periodic
  stats line, and in the summary the program's counters
  (:data:`zaru_tpu_torch.profiling.counters`) over the run;
- :func:`serve_loop`: the loop itself, the body of ``cmd_serve``: stage
  every slot's frame into the double-buffered uploader
  (:class:`~zaru_tpu_torch.pipeline.ingest.FrameUploader`), flush, one
  tracker step, one JSON record per step, then gather the next step's
  frames (decoded while the device stepped). The CLI calls it with file
  sources; ``chip_smoke.py`` with in-memory ones. Its spans:
  ``zaru.serve.stage``, ``zaru.serve.flush``, ``zaru.sync.emit`` (the
  outputs read to the host, one counted host sync) and
  ``zaru.serve.gather``.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .profiling import counters, span, sync

__all__ = ["SlotEvent", "StreamSet", "ServeStats", "reset_state_slots", "serve_loop"]


@dataclass
class SlotEvent:
    """One join/leave transition on a slot during ``gather``."""

    slot: int
    kind: str  # "leave" | "join" | "reject"
    source: str = ""


class StreamSet:
    """Fixed slots over a changing set of frame sources.

    ``initial`` is one source factory per slot; ``pending`` is a queue of
    factories that join as slots free up. A *source factory* is a callable
    returning an iterator of ``np.uint8 [H,W,4]`` frames (the CLI wraps
    ``_iter_frames``; tests pass synthetic iterators). A factory may be
    ``None`` to start a slot empty (it joins from ``pending`` immediately
    if one is available).

    Decode policy: one in-flight decode per slot on a shared thread pool.
    ``gather(wait)`` returns the current frame per slot — a fresh one when
    its decode finished, otherwise the PREVIOUS frame with the slot's drop
    counter bumped. The in-flight decode is never cancelled; it lands on a
    later step. Sources that end (StopIteration) leave; the next pending
    source joins the freed slot (its first frame is decoded synchronously —
    joins are rare).
    """

    _END = object()
    _FAIL = object()

    def __init__(self, initial, pending=(), *, pool=None):
        self.slots = len(initial)
        self._pool = pool or cf.ThreadPoolExecutor(
            max_workers=max(1, min(self.slots, os.cpu_count() or 1))
        )
        self._own_pool = pool is None
        self._pending = list(pending)
        self._iters = [None] * self.slots
        self._futs = [None] * self.slots
        self.frames: list[np.ndarray | None] = [None] * self.slots
        self.active = [False] * self.slots
        self.drops = [0] * self.slots
        self.served = [0] * self.slots
        self.joins = 0
        self.leaves = 0
        self._shape = None  # pinned by prime(); mid-run joins must match
        for i, factory in enumerate(initial):
            if factory is not None:
                self._attach(i, factory)

    # -- internals ----------------------------------------------------------

    def _attach(self, slot: int, factory) -> bool:
        """Binds a source to a slot and synchronously decodes its first
        frame. Returns False (slot stays free) for an empty or failing
        source, or — after prime() pinned the serving resolution — one
        whose frames have a different shape (the batch program is traced
        at one resolution; a mismatched joiner must not crash the loop
        for every other stream)."""
        try:
            it = iter(factory())
            first = self._decode(it)
        except Exception:
            return False
        if first is self._END or first is self._FAIL:
            return False
        if self._shape is not None and first.shape != self._shape:
            return False
        self._iters[slot] = it
        self.frames[slot] = first
        self.active[slot] = True
        self.served[slot] += 1
        self._futs[slot] = self._pool.submit(self._decode, it)
        return True

    @classmethod
    def _decode(cls, it):
        """Next frame, END on exhaustion, FAIL on a decode error — the
        reference's loop survives corrupt frames (webcam.rs:291-313);
        a failed decode counts a drop and the previous frame re-serves."""
        try:
            return np.asarray(next(it))
        except StopIteration:
            return cls._END
        except Exception:
            return cls._FAIL

    def _join_from_pending(self, slot: int, events: list[SlotEvent]):
        while self._pending:
            factory = self._pending.pop(0)
            name = getattr(factory, "name", "")
            if self._attach(slot, factory):
                self.joins += 1
                events.append(SlotEvent(slot, "join", name))
                return
            # Empty, failing, or wrong-resolution source: skip it and
            # try the next pending one (the loop must survive).
            events.append(SlotEvent(slot, "reject", name))
        self.frames[slot] = (
            np.zeros_like(self.frames[slot])
            if self.frames[slot] is not None
            else None
        )

    # -- public API ---------------------------------------------------------

    def prime(self):
        """Ensures every slot has a frame (joining pending sources into
        empty slots); raises if none do. Call once before the loop."""
        events: list[SlotEvent] = []
        for i in range(self.slots):
            if not self.active[i]:
                self._join_from_pending(i, events)
        live = [f for f in self.frames if f is not None]
        if not live:
            raise RuntimeError("no stream produced any frame")
        shape = live[0].shape
        for i, f in enumerate(self.frames):
            if f is None:
                self.frames[i] = np.zeros(shape, np.uint8)
            elif f.shape != shape:
                raise RuntimeError(
                    f"stream {i} shape {f.shape} != stream 0 shape {shape}; "
                    "serving batches require one resolution"
                )
        self._shape = shape  # mid-run joiners must match (see _attach)
        return events

    def gather(self, wait: float = 0.0) -> tuple[list[np.ndarray], list[SlotEvent]]:
        """Returns (frames per slot, join/leave events) for the next step.

        ``wait`` seconds is the per-step decode deadline, shared across
        slots: slots whose decode has not landed by then re-serve their
        previous frame and count a drop (never stalls the device loop
        beyond the deadline — the backpressure policy).
        """
        deadline = time.monotonic() + wait
        events: list[SlotEvent] = []
        for i in range(self.slots):
            if not self.active[i]:
                continue
            fut = self._futs[i]
            remaining = deadline - time.monotonic()
            try:
                result = fut.result(timeout=max(0.0, remaining))
            except cf.TimeoutError:
                self.drops[i] += 1  # decode missed the step; frame reused
                continue
            if result is self._END:
                self.active[i] = False
                self._iters[i] = None
                self._futs[i] = None
                self.leaves += 1
                events.append(SlotEvent(i, "leave"))
                self._join_from_pending(i, events)
            elif result is self._FAIL or (
                self._shape is not None and result.shape != self._shape
            ):
                # Corrupt/failed (or wrong-shaped) decode: re-serve the
                # previous frame, count a drop, keep the source going.
                self.drops[i] += 1
                self._futs[i] = self._pool.submit(self._decode, self._iters[i])
            else:
                self.frames[i] = result
                self.served[i] += 1
                self._futs[i] = self._pool.submit(self._decode, self._iters[i])
        return list(self.frames), events

    @property
    def n_active(self) -> int:
        return sum(self.active)

    def close(self):
        if self._own_pool:
            self._pool.shutdown(wait=False, cancel_futures=True)


def reset_state_slots(state: dict, fresh_state: dict, slots) -> dict:
    """``state`` with the given stream slots reset to ``fresh_state``'s
    values: both are dicts (possibly nested) of tensors with a leading
    stream axis. A new dict of new tensors; the caller's state is left as
    it was. An index assignment per slot on the state's device, no host
    round trip (joins are rare; the hot step never takes this path)."""
    slots = list(slots)
    if not slots:
        return state

    def reset(leaf, fresh):
        if isinstance(leaf, dict):
            return {k: reset(v, fresh[k]) for k, v in leaf.items()}
        out = leaf.clone()
        for i in slots:
            out[i] = fresh[i]
        return out

    return reset(state, fresh_state)


@dataclass
class ServeStats:
    """Step accounting + the periodic stats line.

    ``frames`` counts FRESH frames only — a slot that re-served its
    previous frame (drop) does not inflate throughput. Step-time
    percentiles are computed over a bounded window (the last
    ``WINDOW`` steps) so an indefinite ``--soak`` run neither leaks
    memory nor pays ever-growing percentile cost. The summary adds the
    program's host syncs a step, host copies, detect steps and kernel
    builds from the start to the last recorded step, once the program has
    stepped.
    """

    WINDOW = 4096

    streams: int
    t_start: float = field(default_factory=time.perf_counter)
    steps: int = 0
    frames: int = 0
    step_times: "deque" = field(
        default_factory=lambda: deque(maxlen=ServeStats.WINDOW)
    )
    _last_report_t: float = 0.0
    _last_report_frames: int = 0
    _counters0: dict = field(default_factory=lambda: dict(counters))  # at the start
    _counters1: dict = field(default_factory=lambda: dict(counters))  # at the last recorded step

    def record_step(self, dt: float, n_active: int, n_dropped: int = 0):
        self.steps += 1
        self.frames += max(0, n_active - n_dropped)
        self.step_times.append(dt)
        self._counters1 = dict(counters)

    def _pct(self, q: float) -> float:
        if not self.step_times:
            return 0.0
        return float(np.percentile(list(self.step_times), q))

    def report_line(self, stream_set: StreamSet) -> str:
        """The periodic line: interval fps, p50 step, drops, active."""
        now = time.perf_counter()
        interval = now - (self._last_report_t or self.t_start)
        int_frames = self.frames - self._last_report_frames
        self._last_report_t = now
        self._last_report_frames = self.frames
        times = list(self.step_times)
        recent = times[-max(1, len(times) // 4):]
        p50 = float(np.percentile(recent, 50)) * 1e3 if recent else 0.0
        return (
            f"step {self.steps}: {int_frames / max(interval, 1e-9):.6g} "
            f"frames/s e2e, p50 {p50:.1f}ms/step, "
            f"drops {sum(stream_set.drops)}, "
            f"active {stream_set.n_active}/{stream_set.slots}"
        )

    def summary(self, stream_set: StreamSet) -> str:
        dt = time.perf_counter() - self.t_start
        return (
            f"served {self.frames} fresh frames over {self.streams} slots "
            f"in {dt:.2f}s = {self.frames / max(dt, 1e-9):.6g} frames/s "
            f"end-to-end; step p50 {self._pct(50) * 1e3:.1f}ms / "
            f"p95 {self._pct(95) * 1e3:.1f}ms "
            f"(last {len(self.step_times)} steps), "
            f"drops {sum(stream_set.drops)}, joins {stream_set.joins}, "
            f"leaves {stream_set.leaves}{self._counted()}"
        )

    def _counted(self) -> str:
        """The program's counters from the start to the last recorded step,
        or nothing while the program has not stepped."""
        ran = {k: v - self._counters0[k] for k, v in self._counters1.items()}
        if not (ran["steps"] and self.steps):
            return ""
        return (f"; host syncs {ran['host_syncs'] / self.steps:.3g}/step, host copies {ran['host_copies']}, "
                f"detect steps {ran['detect_steps']}, kernel builds {ran['kernel_builds']}")


REPORT_KEYS = ("confidence", "presence", "pose_flag")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def serve_loop(
    tracker,
    streams: StreamSet,
    uploader,
    *,
    single: bool,
    steps: int,
    emit,
    soak: float = 0.0,
    decode_wait: float = 1.0,
    report_every: int = 10,
    landmarks: bool = False,
    no_loop: bool = False,
    log=lambda line: None,
) -> ServeStats:
    """Serves ``streams`` (primed) through ``tracker`` until ``steps`` steps
    (or ``soak`` seconds, when given) have run, or with ``no_loop`` until
    every source is exhausted.

    Each step stages every slot's frame into ``uploader`` and flushes it,
    runs one tracker step on the uploaded batch (``single``: the stream's
    ``run_frame`` on frame 0, outputs given a leading stream axis so the
    records keep the batch program's schema; else ``run_frames_gated``),
    and calls ``emit(record, outputs)`` with the step's JSON-able record
    (``step``, ``valid``, ``active`` once a slot left or joined,
    ``REPORT_KEYS`` rounded to 4 places, ``landmarks`` if asked) and the
    raw outputs. Then it gathers the next step's frames, waiting at most
    ``decode_wait`` seconds for the decodes. A slot that joined is reset to
    a fresh state, so its stream re-detects. ``tracker`` may be a
    :class:`~zaru_tpu_torch.parallel.ShardedTracker` (with ``uploader`` on
    its ``frame_sharding``): its state is sharded, and a reset state is
    placed again with its ``shard_state``. ``log`` takes the stderr lines
    (slot events, the periodic stats line every ``report_every`` steps).
    Returns the run's :class:`ServeStats`.
    """
    if single:
        fresh_state = tracker.init_state()
    else:
        fresh_state = tracker.init_state(batch=streams.slots)
    state = fresh_state
    shard_state = getattr(tracker, "shard_state", None)
    stats = ServeStats(streams=streams.slots)
    soak_deadline = time.perf_counter() + soak if soak else None
    step = 0
    # The primed frames are step 0's batch; each step ends by gathering
    # the NEXT step's frames, whose decodes ran while the device stepped.
    frames = list(streams.frames)
    events = []
    # Drops recorded by the gather that produced THIS step's frames —
    # re-served frames must not count as fresh throughput.
    step_drops = 0
    drop_total = sum(streams.drops)
    while True:
        t_step = time.perf_counter()
        for ev in events:
            src = f" ({ev.source})" if ev.source else ""
            log(f"stream slot {ev.slot}: {ev.kind}{src}")
        joined = [ev.slot for ev in events if ev.kind == "join"]
        if joined:
            # A fresh occupant must re-detect, not inherit the previous
            # stream's ROI/filter state.
            state = fresh_state if single else reset_state_slots(state, fresh_state, joined)
            if shard_state is not None:
                state = shard_state(state)
        with span("zaru.serve.stage"):
            for slot, frame in enumerate(frames):
                uploader.stage(slot, frame)
        with span("zaru.serve.flush"):
            frames_dev = uploader.flush()
        if single:
            state, out = tracker.run_frame(state, frames_dev[0])
            out = {k: v[None] for k, v in out.items()}
        else:
            state, out = tracker.run_frames_gated(state, frames_dev)
        with sync("zaru.sync.emit"):
            rec = {"step": step, "valid": _host(out["valid"]).tolist()}
            if streams.n_active != streams.slots or streams.joins:
                rec["active"] = list(streams.active)
            for key in REPORT_KEYS:
                if key in out:
                    rec[key] = np.round(_host(out[key]), 4).tolist()
            if landmarks:
                rec["landmarks"] = _host(out["landmarks"]).tolist()
        emit(rec, out)
        n_active = streams.n_active
        step += 1
        if soak_deadline is not None:
            done = time.perf_counter() >= soak_deadline
        else:
            done = step >= steps
        if not done:
            with span("zaru.serve.gather"):
                frames, events = streams.gather(wait=decode_wait)
        stats.record_step(time.perf_counter() - t_step, n_active, n_dropped=step_drops)
        if step % report_every == 0:
            log(stats.report_line(streams))
        if done:
            break
        new_total = sum(streams.drops)
        step_drops, drop_total = new_total - drop_total, new_total
        if no_loop and streams.n_active == 0:
            log("all sources exhausted")
            break
    return stats
