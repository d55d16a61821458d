"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``card`` marker for tests that need a CUDA card.  Whether a card is
there is decided inside the ``card`` fixture, never at import time."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
