"""pytest settings of the benchmark's own tests (``gossipbench/tests``):
the ``card`` marker, for tests that need a CUDA card. Whether there is a
card is decided in the ``card`` fixture, when a test runs."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda", 0)
