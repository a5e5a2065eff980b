"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root.  Tests marked ``card`` need an NVIDIA card; they skip
elsewhere (the ``card`` fixture decides, never at import)."""
from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped on a machine without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
