"""Tests of the benchmark harness.  Tests marked `card` need a CUDA card:
the `card` fixture skips them without one (decided when the test runs,
never at import).  Run from the repository root:

    python -m pytest benchmark/tests -q            # CPU: the card tests skip
    python -m pytest benchmark/tests -q -m card    # on the card
"""

import importlib.util
import os
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

FAULT_KINDS = ("state_unchanged", "half_left_out", "answer_altered")


def fault_file(entry: str):
    """tests/faults/<entry>.py as a module: the `FAULTS` planted in what the
    entry's call runs, and the `SIZE` of its CPU runs.  The file is not named
    test_* and so not collected; it is loaded by path."""
    path = os.path.join(TESTS, "faults", entry + ".py")
    assert os.path.exists(path), f"entry {entry!r} has no fault file {os.path.relpath(path, ROOT)}"
    spec = importlib.util.spec_from_file_location(f"bench_faults_{entry}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")
