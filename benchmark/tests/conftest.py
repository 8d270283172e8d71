"""The benchmark's own tests (run with ``python -m pytest benchmark/tests
-q``). They import neither JAX nor the JAX package. Tests that need the
card carry the ``cuda`` marker and decide inside a fixture."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs on the card only")
    return torch.device("cuda", 0)
