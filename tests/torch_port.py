"""Helpers for the port's tests (``tests/test_torch_*.py``).

- ``one_torch_thread``: the tier-1 suite runs in several pytest-xdist
  worker processes on one machine. torch's default of one OpenMP thread per
  core in each of them oversubscribes the cores, and the port's small CPU
  ops then spin instead of working: a ``FaceTracker`` step at batch 2 takes
  3-9 s beside six busy test processes instead of 0.1 s. Each port test
  module imports this fixture, so its tests run torch on one thread and
  give the worker's setting back after the module.
- ``jax_processes``: a pool of fresh processes for a module's live JAX
  reference runs. Tracing and lowering a tracker hold the interpreter lock,
  so runs on threads barely overlap; in processes they do (the four
  multi-object runs: about 92 s on threads, 54 s in processes on an 8-core
  CPU). A worker imports the test module afresh, inherits the environment
  ``tests/conftest.py`` set (``JAX_PLATFORMS``, ``XLA_FLAGS``) and takes the
  JAX settings it made (platform, compile cache); ``numpy_params`` turns a
  tracker's params into arrays a worker can return.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_params(params: dict) -> dict:
    """A JAX tracker's ``{"det": {...}, "lm": {...}[, "eye": ...]}`` params
    as numpy arrays, which a process can return."""
    return {net: {k: np.asarray(v) for k, v in p.items()} for net, p in params.items()}


# The JAX settings tests/conftest.py makes in the test process, which a
# spawned worker does not inherit.
_JAX_SETTINGS = ("jax_platforms", "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _configure_jax(settings: dict) -> None:
    import jax

    for name, value in settings.items():
        if value is not None:
            jax.config.update(name, value)


def jax_processes(workers: int) -> ProcessPoolExecutor:
    """A process pool (spawned, not forked: the test process has threads)
    for ``workers`` JAX runs, with the test process's JAX settings; use it
    in a ``with`` block."""
    import jax

    settings = {name: getattr(jax.config, name) for name in _JAX_SETTINGS}
    return ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_configure_jax, initargs=(settings,),
    )
