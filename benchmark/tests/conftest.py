"""Tests of the benchmark. Those marked ``card`` need a CUDA card and
skip without one; the fixture decides when the test runs."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = os.path.join(ROOT, "benchmark", "tests", "tiny", "BENCHMARK.json")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.fixture
def tiny():
    return TINY
