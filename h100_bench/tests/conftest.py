import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none: the decision is made
    here, when a test asks for it, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this machine has no CUDA device")
    return torch.device("cuda")
