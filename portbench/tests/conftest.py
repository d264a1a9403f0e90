"""The benchmark's tests: python -m pytest portbench/tests from the root of
the checkout. Tests marked `cuda` run a cell on the card and skip without
one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures only on the card")
    return torch.cuda.get_device_name(0)
