"""Helpers for the port's tests (``tests/test_torch_*.py``).

``one_torch_thread``: the tier-1 suite runs in several pytest-xdist worker
processes on one machine. torch's default of one OpenMP thread per core in
each of them oversubscribes the cores, and the port's small CPU ops then
spin instead of working: a ``FaceTracker`` step at batch 2 takes 3-9 s
beside six busy test processes instead of 0.1 s. Each port test module
imports this fixture, so its tests run torch on one thread and give the
worker's setting back after the module.

A port module's live JAX reference runs (its ``test_fixture_is_current``)
run in the test process, one at a time, with the JAX settings
``tests/conftest.py`` made there (the CPU platform, 8 host devices, the
compile cache). A module computes each run when a test first asks for it
and keeps it for the module, so each parametrised case pays for its own
run. No port test starts a process or a thread pool of its own: the
suite's busy processes are the xdist workers.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
