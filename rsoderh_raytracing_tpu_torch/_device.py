"""Two rules of the port's entry points: the card by default, never a
silent drop to the CPU; and no reference knob ignored without a word."""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch

DEFAULT = "cuda"

# Environment knobs of the reference (rsoderh_raytracing_tpu) that the
# port does not honour: the compaction cadence, which is TPU grid
# machinery. A run that sets one measures something else than it claims,
# so the port says so, once a knob. (The chunked route's ceilings and
# chunk orders, RT_MAX_CHUNKED_TRIS, RT_MAX_CHUNKED_SPHERES,
# RT_CHUNK_CLUSTER and RT_DISABLE_MORTON, and the BVH crossover,
# RT_BVH_ABOVE_TRIS, are honoured: scene/device.py.)
IGNORED_KNOBS = ("RT_COMPACT_EVERY",)
_warned: set = set()


def warn_once(key: str, message: str) -> None:
    """A RuntimeWarning with `message`, the first time this process
    warns under `key`."""
    if key not in _warned:
        _warned.add(key)
        warnings.warn(message, RuntimeWarning, stacklevel=4)


def warn_ignored_knobs() -> None:
    """A RuntimeWarning naming each IGNORED_KNOBS variable that is set,
    the first time this process sees it set."""
    for knob in IGNORED_KNOBS:
        if knob in os.environ:
            warn_once(knob, f"{knob}={os.environ[knob]!r} is a knob of rsoderh_raytracing_tpu "
                            "that the PyTorch port ignores: this run does not take the setting")


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


def copy_to(obj, device):
    """A copy of the dataclass `obj` on `device`: every tensor field
    copied there, every dataclass field (the chunk tables, the BVH)
    copied the same way, every other field as it is. Fields that the
    class computes itself (init=False) are computed anew."""
    device = resolve(device)

    def move(value):
        if isinstance(value, torch.Tensor):
            return value.to(device)
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            return copy_to(value, device)
        return value

    return type(obj)(**{f.name: move(getattr(obj, f.name))
                        for f in dataclasses.fields(obj) if f.init})
