"""Tests of the benchmark's harness and reference, on the CPU at small
sizes; tests marked `cuda` need the card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
