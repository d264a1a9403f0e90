"""Two rules of the port's entry points: the card by default, never a
silent drop to the CPU; and no reference knob ignored without a word."""

from __future__ import annotations

import os
import warnings

import torch

DEFAULT = "cuda"

# Environment knobs of the reference (rsoderh_raytracing_tpu) that the
# port does not honour: the chunk ceiling, the chunk orders, the BVH
# crossover and the compaction cadence. A run that sets one measures
# something else than it claims, so the port says so, once a knob.
IGNORED_KNOBS = (
    "RT_MAX_CHUNKED_TRIS", "RT_CHUNK_CLUSTER", "RT_DISABLE_MORTON", "RT_BVH_ABOVE_TRIS",
    "RT_COMPACT_EVERY",
)
_warned: set = set()


def warn_ignored_knobs() -> None:
    """A RuntimeWarning naming each IGNORED_KNOBS variable that is set,
    the first time this process sees it set."""
    for knob in IGNORED_KNOBS:
        if knob in os.environ and knob not in _warned:
            _warned.add(knob)
            warnings.warn(
                f"{knob}={os.environ[knob]!r} is a knob of rsoderh_raytracing_tpu that the "
                "PyTorch port ignores: this run does not take the setting",
                RuntimeWarning, stacklevel=3,
            )


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
