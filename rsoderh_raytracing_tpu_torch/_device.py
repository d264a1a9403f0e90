"""The device rule of the port's entry points: the card by default, and
never a silent drop to the CPU."""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and there is
    no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run its plain PyTorch path on the CPU"
        )
    return dev
