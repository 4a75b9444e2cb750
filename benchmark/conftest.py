"""Pytest settings of the benchmark's own tests (`python -m pytest
benchmark/tests -q`). Tests that need a card carry the `card` marker and
take the `card` fixture, which decides when the test runs, never when a
module is imported, whether a card is present."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
