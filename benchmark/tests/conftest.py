"""The benchmark's own tests (``python -m pytest benchmark/tests``): on the
CPU at tiny sizes, the card's tests (marked ``chip``) skip there."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, at
    run time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card")
    return "cuda"
