"""The benchmark's own tests (``python -m pytest vince_bench/tests``). Tests
that need an NVIDIA GPU carry the ``chip`` marker, registered here, and skip
inside the test where there is none."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU; skips without one")
    # the runs here are many small eager ops: threads beside the test workers cost more
    # than they give
    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
