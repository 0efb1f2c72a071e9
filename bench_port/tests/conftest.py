"""Fixtures of the benchmark's own tests: the repository root on the
import path, and a card check decided when a test asks for it."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def cuda():
    """Skips the test without a CUDA device (decided here, not at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
