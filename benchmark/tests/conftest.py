"""The benchmark's own tests: on the CPU at tiny sizes, except those marked
``card``, which run one short cell on a CUDA card and skip without one.

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m card    # on the card
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
