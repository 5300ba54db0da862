"""Test settings of the benchmark: the checkout's root on the import path,
torch on a few threads, and the ``chip`` marker for tests that need a CUDA
device (each decides inside the test whether there is one)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skipped without one")


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the chip")
    return torch.device("cuda")
