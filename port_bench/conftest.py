"""pytest settings of the benchmark's own tests (``port_bench/tests``):
the harness's modules on the path, and the ``card`` marker of the tests that
need a CUDA card, which skip without one (decided in the ``card`` fixture,
never while a module is imported)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (HERE, os.path.dirname(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
