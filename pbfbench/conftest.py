"""pytest settings of the benchmark's own tests (pbfbench/tests).

    python -m pytest pbfbench/tests -q

runs them on the CPU; the tests marked `card` need an NVIDIA card and skip
without one, so the same command on a machine with a card runs them too.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card, or skip: decided when a test asks, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
