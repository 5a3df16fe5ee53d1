"""The benchmark's tests: the harness on the CPU at tiny sizes, and a
card-only rehearsal marked ``cuda``. Run from the root of the checkout:

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is present (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
