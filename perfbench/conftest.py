"""pytest settings of the benchmark's own tests (perfbench/tests/): the
`chip` marker for tests that need a CUDA device; whether there is one is
decided inside the `cuda` fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (an H100); skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the chip")
    return torch.device("cuda")
