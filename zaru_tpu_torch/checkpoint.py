"""Weight checkpointing (zaru_tpu/checkpoint.py).

A model's parameters are a flat ``{onnx name: tensor}`` dict
(``OnnxModule.params()``). :func:`save_params` writes them as

- ``.npz``: the numpy archive JAX's ``save_params`` writes, so a file written
  by either package loads in the other;
- any other path: a directory in the port's own format, one
  ``params.pt`` written by ``torch.save`` and read by ``torch.load`` with
  ``weights_only=True`` (no code runs on load). It takes the place of JAX's
  orbax directory.

:func:`save_params_async` copies the tensors to host memory before it
returns, so a later in-place optimizer update cannot race the write, and
writes on a background thread. :class:`CheckpointManager` keeps step-numbered
checkpoints in a directory (``<dir>/<step>/``), saves every
``save_interval_steps`` in the background and keeps the newest
``max_to_keep``.
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from .parallel.mesh import Replicated, Sharded

__all__ = ["CheckpointManager", "load_params", "save_params", "save_params_async"]

_FILE = "params.pt"  # the tensors of a directory checkpoint


def _host_copy(params: dict) -> dict[str, torch.Tensor]:
    """Each tensor (or array) as a CPU tensor of its own: a device tensor
    is copied to the host (the copy has finished when this returns), a host
    one cloned."""
    out = {}
    for k, v in params.items():
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[k] = t.to("cpu", copy=True)
    return out


def _write(path: Path, params: dict[str, torch.Tensor]) -> None:
    if path.suffix == ".npz":
        with open(path, "wb") as f:
            np.savez(f, **{k: v.numpy() for k, v in params.items()})
        return
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{_FILE}.{os.getpid()}.tmp"
    torch.save(params, tmp)
    os.replace(tmp, path / _FILE)  # a save over an existing checkpoint replaces it whole


def save_params(path: str | Path, params: dict) -> None:
    """Saves a flat ``{name: tensor or array}`` dict: a ``.npz`` path as a
    numpy archive, any other path as a checkpoint directory."""
    _write(Path(path), _host_copy(params))


class _PendingSave:
    """A save running on a background thread."""

    def __init__(self, target, *args):
        self._error: BaseException | None = None

        def run():
            try:
                target(*args)
            except BaseException as e:  # handed to wait_until_finished
                self._error = e

        self._thread = threading.Thread(target=run, name="zaru-checkpoint", daemon=True)
        self._thread.start()

    def wait_until_finished(self) -> None:
        """Blocks until the write is done; raises what the write raised."""
        self._thread.join()
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def save_params_async(path: str | Path, params: dict) -> _PendingSave:
    """Starts saving ``params`` as :func:`save_params` does and returns a
    handle; call its ``wait_until_finished()`` before reading the
    checkpoint back or exiting. The tensors are on the host when this
    returns."""
    return _PendingSave(_write, Path(path), _host_copy(params))


def _place(t: torch.Tensor, like):
    """``t`` where ``like`` lives: split shard by shard over the mesh of a
    :class:`~zaru_tpu_torch.parallel.Sharded` (each shard copied straight
    to its device, as JAX restores a leaf with its ``NamedSharding``), a
    copy on each device of a :class:`~zaru_tpu_torch.parallel.Replicated`
    (a parameter replicated over a mesh, as JAX's ``_abstract_like`` places
    a replicated leaf), a tensor's device, else the host."""
    if isinstance(like, Sharded):
        sharding = like.sharding
        if t.ndim == 0 or t.shape[0] % len(sharding.mesh):
            raise ValueError(f"a saved leaf of shape {tuple(t.shape)} does not divide over the "
                             f"{len(sharding.mesh)} shards of {sharding}")
        return sharding.put(t)
    if isinstance(like, Replicated):
        return Replicated(t.to(d, copy=True) for d in like.devices)
    return t.to(like.device if isinstance(like, torch.Tensor) else "cpu")


def _restore(data: dict, like: dict | None, path: Path) -> dict:
    """``data`` (name → CPU tensor) checked against ``like`` and each leaf
    placed where its ``like`` leaf lives (:func:`_place`)."""
    if like is None:
        return data
    missing = sorted(set(like) - set(data))
    if missing:
        raise KeyError(f"checkpoint {path} is missing params {missing} (has {sorted(data)})")
    extra = sorted(set(data) - set(like))
    if extra:
        raise ValueError(f"checkpoint {path} has params {extra} not in the restore target; pass a matching "
                         "`like` tree")
    return {k: _place(data[k], v) for k, v in like.items()}


def load_params(path: str | Path, *, like: dict | None = None) -> dict:
    """Loads a flat parameter dict as CPU tensors (a ``.npz`` archive of
    either package, or a checkpoint directory). ``like``: a dict of tensors,
    ``Replicated`` parameters (such as
    ``train.make_data_parallel_train_step`` returns) or ``Sharded`` ones,
    naming exactly the parameters to load; each leaf goes to its tensor's
    device, a copy to each device of a replicated one, and a sharded one is
    split over its mesh shard by shard (its axis 0 must divide). A missing
    or extra name raises."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path, allow_pickle=False) as data:
            params = {k: torch.from_numpy(data[k]) for k in data.files}
    else:
        params = torch.load(path / _FILE, map_location="cpu", weights_only=True)
    return _restore(params, like, path)


class CheckpointManager:
    """Step-numbered background checkpointing for fine-tune loops: saves
    every ``save_interval_steps`` (callers may call :meth:`save` every
    step), keeps the newest ``max_to_keep`` and writes on a background
    thread, one save at a time::

        with CheckpointManager(dir, max_to_keep=3) as mgr:
            for step in range(n):
                trainer.train_step(x, y)
                mgr.save(step, trainer.params)
        params = mgr.restore()           # latest
        params = mgr.restore(step=1200)  # a given step
    """

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3, save_interval_steps: int = 1):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._pending: _PendingSave | None = None

    def save(self, step: int, params: dict) -> bool:
        """Starts a background save of ``step`` (after the previous one has
        finished); returns whether one was started (False when the interval
        skips this step)."""
        if step % self.save_interval_steps:
            return False
        self.wait_until_finished()
        self._pending = _PendingSave(self._save, int(step), _host_copy(params))
        return True

    def _save(self, step: int, params: dict) -> None:
        tmp = self.directory / f"{step}.tmp"
        _write(tmp, params)
        final = self.directory / str(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def restore(self, step: int | None = None, *, like: dict | None = None) -> dict:
        """Loads ``step`` (the latest saved step unless named); ``like`` as
        in :func:`load_params`."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoints saved yet")
        return load_params(self.directory / str(step), like=like)

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir() if p.name.isdigit() and (p / _FILE).exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.wait_until_finished()

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
