"""Tests of the benchmark harness.  Tests marked `card` need a CUDA card:
the `card` fixture skips them without one (decided when the test runs,
never at import).  Run from the repository root:

    python -m pytest benchmark/tests -q            # CPU: the card tests skip
    python -m pytest benchmark/tests -q -m card    # on the card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")
