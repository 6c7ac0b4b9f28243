"""pytest settings of the benchmark's own tests (benchmark/tests/).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which decides when the test runs whether a card is there and
skips otherwise; nothing is decided while a module is imported.

    python -m pytest benchmark/tests -q            # CPU, a few minutes
    python -m pytest benchmark/tests -q -m card    # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on a card")
    return torch.device("cuda")
