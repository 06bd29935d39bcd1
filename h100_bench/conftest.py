"""pytest settings of the benchmark's own tests (h100_bench/tests/).

Run them from the repository's root: ``python -m pytest h100_bench/tests
-q``. A test marked ``card`` needs a CUDA device; it decides inside its
fixture and skips without one, so here on a CPU it skips with a reason.
"""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips on a machine without one")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda", 0)
