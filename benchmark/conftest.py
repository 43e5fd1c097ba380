"""pytest settings of the benchmark's own tests (``pytest benchmark/tests``):
the ``cuda`` marker for tests that need the card.  Those decide inside a
fixture whether there is one and skip on the CPU."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips on the CPU)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
