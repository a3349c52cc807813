"""Tests of the benchmark harness; ``cuda`` tests need a card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs the benchmark on a CUDA card; skips where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
