"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root. Tests marked ``card`` need an NVIDIA card and skip without
one; whether there is one is decided inside the ``card`` fixture, never at
import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")
    return torch.device("cuda")
