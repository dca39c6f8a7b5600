"""Tests of the benchmark (``python -m pytest -q bench/tests`` from the root
of the checkout).  Tests marked ``card`` need a CUDA card and skip without one;
``python -m pytest -q -m card bench/tests`` runs them on the card."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test reads the card at the cell's own size")
    return torch.device("cuda", 0)
