"""The harness's tests: on the CPU at tiny sizes, except those marked
`card`, which need a CUDA card and skip without one (decided inside the
`card` fixture, never at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"
