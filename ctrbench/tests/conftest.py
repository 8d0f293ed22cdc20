"""Tests of the benchmark itself (CPU; tests marked `cuda` need a card and
skip without one: `python -m pytest ctrbench/tests -m cuda` on the card)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
