"""Stream-sharded serving over several devices (zaru_tpu/parallel/mesh.py).

A mesh is a 1-D, ordered tuple of ``torch.device`` (:func:`stream_mesh`); a
batch of streams is split along its leading axis into equal, contiguous
shards, shard ``s`` on ``mesh[s]``. Devices may repeat: the tests build a
mesh of eight ``cpu`` shards (JAX's tests build eight virtual CPU devices),
and one card can carry two shards.

:class:`ShardedTracker` runs a tracker over such a mesh, as JAX's
``shard_map`` does, with no collectives:

- the tracker is replicated once per distinct device of the mesh: every
  tensor it holds (parameters, the stage plans' packed weights, anchors,
  constants, the executor's kept host-value copies) is copied onto that
  device; the tracker's own device keeps the tracker itself;
- states, frames and outputs are :class:`Sharded` trees: one tensor per
  shard, on the shard's device, in mesh order. Nothing of a shard ever lands
  on another shard's device;
- ``step`` runs each shard's ``run_frames`` (JAX's ``vmap(step)``),
  ``step_gated`` each shard's ``step_batch``: each shard has its own
  detection gate and its own ``redetect_bucket``;
- the shards are issued one after another from the caller's thread. Each
  shard's gate reads one value to the host, which waits for that shard's
  previous step; a thread per card would let one card's wait overlap
  another's launches, but the launches are Python and hold the interpreter
  lock: on four H100s, four shards of 128 streams took 54.0-58.1 ms/step
  from a thread per card and 18.0-18.5 ms/step one after another
  (``chip_smoke.py --sharding``).
"""

from __future__ import annotations

import copy
import enum
import types

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["Replicated", "ShardedFaceTracker", "ShardedTracker", "Sharded", "StreamSharding", "stream_mesh"]


def _canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def stream_mesh(devices=None) -> tuple[torch.device, ...]:
    """A 1-D mesh: every visible CUDA device (raising without a GPU, the rule
    of :func:`~zaru_tpu_torch.resolve_device`), or the given devices in
    their order, repeats allowed."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(_canonical(resolve_device(d)) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


class Sharded:
    """A tensor split along its leading (stream) axis over a mesh:
    ``shards[s]`` holds shard ``s``'s streams on that shard's device, in
    mesh order. ``np.asarray`` gathers it on the host; an integer index
    reads or writes one stream on its shard's device (what
    :func:`~zaru_tpu_torch.serve.reset_state_slots` does to a state)."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = tuple(shards)

    @property
    def sharding(self) -> "StreamSharding":
        return StreamSharding(tuple(s.device for s in self.shards))

    @property
    def shape(self) -> tuple[int, ...]:
        return (sum(s.shape[0] for s in self.shards), *self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def __len__(self) -> int:
        return self.shape[0]

    def cpu(self) -> torch.Tensor:
        """The whole batch, gathered on the host."""
        return torch.cat([s.detach().cpu() for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype)

    def clone(self) -> "Sharded":
        return Sharded(s.clone() for s in self.shards)

    def _locate(self, i: int) -> tuple[torch.Tensor, int]:
        n = len(self)
        if not -n <= i < n:
            raise IndexError(f"stream {i} out of {n}")
        i %= n
        for s in self.shards:
            if i < s.shape[0]:
                return s, i
            i -= s.shape[0]
        raise AssertionError("unreachable")

    def __getitem__(self, i: int) -> torch.Tensor:
        shard, j = self._locate(i)
        return shard[j]

    def __setitem__(self, i: int, value) -> None:
        shard, j = self._locate(i)
        shard[j] = value.to(shard.device) if isinstance(value, torch.Tensor) else value

    def __repr__(self) -> str:
        return f"Sharded(shape={self.shape}, dtype={self.dtype}, devices={[str(s.device) for s in self.shards]})"


class Replicated:
    """One parameter's copies, one per distinct device of a mesh, in mesh
    order: JAX's replicated sharding. ``np.asarray`` reads the first copy
    (so ``checkpoint.save_params`` takes a dict of them as it is), and
    ``checkpoint.load_params(like=...)`` restores a copy onto each device."""

    __slots__ = ("copies",)

    def __init__(self, copies):
        self.copies = tuple(copies)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(c.device for c in self.copies)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.copies[0].shape)

    def __array__(self, dtype=None, copy=None):
        arr = self.copies[0].detach().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self) -> str:
        return f"Replicated(shape={self.shape}, devices={[str(d) for d in self.devices]})"


class StreamSharding:
    """Where a stream-sharded batch lives: over a mesh of ``n`` devices, a
    batch of ``B`` streams is ``n`` equal shards, shard ``s`` (streams
    ``[s·B/n, (s+1)·B/n)``) on ``mesh[s]``. ``FrameUploader`` takes it as
    its ``device`` and uploads each shard straight to its device."""

    def __init__(self, mesh):
        self.mesh = tuple(mesh)

    def __eq__(self, other) -> bool:
        return isinstance(other, StreamSharding) and self.mesh == other.mesh

    def __repr__(self) -> str:
        return f"StreamSharding({[str(d) for d in self.mesh]})"

    def bounds(self, batch: int) -> list[tuple[int, int]]:
        """Each shard's ``(start, stop)`` in a batch of ``batch`` streams;
        raises unless the mesh divides it."""
        n = len(self.mesh)
        if batch % n:
            raise ValueError(f"stream count {batch} must divide evenly over {n} devices")
        k = batch // n
        return [(s * k, (s + 1) * k) for s in range(n)]

    def put(self, x) -> Sharded:
        """``x`` in this layout: a host array is copied shard by shard
        straight to each device (never staged whole on one device), a tensor
        sliced and each slice moved to its device (a view where it is there
        already), a :class:`Sharded` with
        as many shards re-placed shard by shard (no copy where a shard is in
        place)."""
        if isinstance(x, Sharded) and len(x.shards) == len(self.mesh):
            return Sharded(s if s.device == d else s.to(d) for s, d in zip(x.shards, self.mesh))
        if isinstance(x, Sharded):
            x = x.cpu()
        shards = []
        for (a, b), d in zip(self.bounds(len(x)), self.mesh):
            if isinstance(x, torch.Tensor):
                shards.append(x[a:b].to(d))
            else:
                shards.append(torch.tensor(np.asarray(x)[a:b], device=d))
        return Sharded(shards)


def _map(fn, tree):
    """``fn`` on every leaf of a (nested) dict."""
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _stack(trees: list[dict]) -> dict:
    """Per-shard trees (same keys) → one tree of :class:`Sharded` leaves."""
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict) else Sharded(t[k] for t in trees)
            for k, v in first.items()}


# Objects a replica shares with its source: they hold no tensor.
_SHARED = (type(None), bool, int, float, complex, str, bytes, type, enum.Enum, np.ndarray, np.generic,
           torch.dtype, torch.layout, torch.memory_format, types.ModuleType, types.BuiltinFunctionType)


def _replica(obj, src: torch.device, dst: torch.device):
    """A copy of ``obj`` (a tracker, a network, a module) with every tensor
    on ``src`` copied onto ``dst`` and every ``src`` device attribute set to
    ``dst``. Containers and objects with a ``__dict__`` are copied (shared
    references stay shared); numpy arrays, numbers, strings, classes and
    functions are shared. A function that closes over a ``src`` tensor
    raises: it could not be moved."""
    memo: dict[int, object] = {}

    def walk(x):
        key = id(x)
        if key in memo:
            return memo[key]
        if isinstance(x, torch.Tensor):
            y = x
            if x.device == src:
                y = x.detach().to(dst)
                if isinstance(x, torch.nn.Parameter):
                    y = torch.nn.Parameter(y, requires_grad=x.requires_grad)
        elif isinstance(x, torch.device):
            y = dst if _canonical(x) == src else x
        elif isinstance(x, _SHARED):
            y = x
        elif isinstance(x, types.FunctionType):
            for cell in x.__closure__ or ():
                if isinstance(cell.cell_contents, torch.Tensor) and cell.cell_contents.device == src:
                    raise ValueError(f"{x.__qualname__} closes over a tensor on {src}; it cannot be replicated")
            y = x
        elif isinstance(x, dict):
            y = copy.copy(x)
            memo[key] = y
            y.clear()
            y.update((k, walk(v)) for k, v in x.items())
        elif isinstance(x, (list, tuple, set, frozenset)):
            y = type(x)(walk(v) for v in x)
        elif hasattr(x, "__dict__"):
            y = object.__new__(type(x))
            memo[key] = y
            for k, v in vars(x).items():
                object.__setattr__(y, k, walk(v))
        else:
            y = x
        memo[key] = y
        return y

    return walk(obj)


class ShardedTracker:
    """A batched tracker sharded over the streams of a mesh (see the module
    docstring). Works with ``FaceTracker`` and the slot engines
    (``MultiFaceTracker``, ``MultiHandTracker``, ``BodyTracker``), which
    share the step protocol: ``init_state(batch)``, ``step_batch``,
    ``run_frames``, state and output dicts with the stream axis leading."""

    def __init__(self, tracker, mesh):
        self.tracker = tracker
        self.mesh = stream_mesh(mesh)
        src = _canonical(tracker.device)
        self._replicas = {d: tracker if d == src else _replica(tracker, src, d) for d in dict.fromkeys(self.mesh)}

    @property
    def frame_sharding(self) -> StreamSharding:
        """The layout of a ``[B,H,W,4]`` frame batch. Pass it as ``device=``
        to ``pipeline.ingest.FrameUploader`` so that frames are uploaded
        straight into it, and :meth:`step_gated` takes them with no second
        transfer."""
        return StreamSharding(self.mesh)

    def shard_frames(self, frames) -> Sharded:
        """A host batch (numpy or a CPU tensor) scattered shard by shard to
        each device; a device batch re-placed."""
        return self.frame_sharding.put(frames)

    def shard_state(self, state: dict) -> dict:
        """Re-places a state tree (after host-side surgery such as
        ``serve.reset_state_slots`` on a join) in the sharded layout."""
        return _map(self.frame_sharding.put, state)

    def init_state(self, batch: int) -> dict:
        """A fresh state for ``batch`` streams, each shard's built on its
        device; raises unless the mesh divides ``batch``."""
        bounds = self.frame_sharding.bounds(batch)
        return _stack([self._replicas[d].init_state(b - a) for d, (a, b) in zip(self.mesh, bounds)])

    def _sharded_step(self, method: str, state: dict, frames, *extra):
        """Each shard's ``method(state, frames, *extra)`` on its replica, in
        mesh order, from the caller's thread → the sharded ``(state,
        outputs)``."""
        state = self.shard_state(state)
        frames = self.shard_frames(frames)
        results = []
        for s, (d, f) in enumerate(zip(self.mesh, frames.shards)):
            args = (e.to(d) if isinstance(e, torch.Tensor) else e for e in extra)
            results.append(getattr(self._replicas[d], method)(_map(lambda leaf: leaf.shards[s], state), f, *args))
        return _stack([st for st, _ in results]), _stack([out for _, out in results])

    def step(self, state: dict, frames):
        """One ungated step of every shard: its ``run_frames`` (JAX's
        ``vmap(step)``) → ``(state, outputs)``, sharded."""
        return self._sharded_step("run_frames", state, frames)

    def step_gated(self, state: dict, frames, force_detect=False):
        """One batch-gated step of every shard: its ``step_batch``, with the
        shard's own detection gate and redetect bucket → ``(state,
        outputs)``, sharded. ``force_detect`` (the port's ``step_batch``
        argument, the redetect cadence) goes to every shard."""
        return self._sharded_step("step_batch", state, frames, force_detect)

    def run_frames_gated(self, state: dict, frames):
        """The serving step (:func:`~zaru_tpu_torch.serve.serve_loop`):
        :meth:`step_gated`."""
        return self.step_gated(state, frames)


# The original face-specific name; any batched tracker works.
ShardedFaceTracker = ShardedTracker
