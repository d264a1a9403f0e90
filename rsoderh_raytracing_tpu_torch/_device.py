"""Rules of the port's entry points: the card by default, never a silent
drop to the CPU; a wrapper runs its plain twin only on CPU tensors and
launches its kernel (or raises) on CUDA ones (``use_plain``); no
reference knob ignored without a word; the reference's two switches,
read at call time: RT_DISABLE_PALLAS=1 (``kernels_disabled``: the
wavefront's composed body on the CPU, refused on the card, where the
port has no plain path) and RT_DEBUG_NANS=1 (``debug_nans``: every
wrapper's float outputs and the wavefront carry are checked for NaN,
``check_nans``); and, on the CPU, a first sine and cosine that do not
depend on being first (``warm_cpu_math``)."""

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
# RT_BVH_ABOVE_TRIS, are honoured: scene/device.py; RT_DISABLE_PALLAS and
# RT_DEBUG_NANS below.)
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


def kernels_disabled() -> bool:
    """True under RT_DISABLE_PALLAS=1, the reference's switch that runs
    the estimator without a kernel (rsoderh_raytracing_tpu/ops/
    pallas_intersect.py:pallas_enabled): on the CPU the wavefront then
    runs its composed body over the plain versions; on the card every
    wrapper refuses to run (use_plain), since the port's plain versions
    run on the CPU only. Read at each call."""
    if os.environ.get("RT_DISABLE_PALLAS") != "1":
        return False
    warn_once("RT_DISABLE_PALLAS", "RT_DISABLE_PALLAS=1: no hand-written kernel runs; the "
                                   "wavefront runs its composed body over the plain PyTorch "
                                   "versions, on the CPU only")
    return True


def debug_nans() -> bool:
    """True under RT_DEBUG_NANS=1, the reference's NaN sanitizer
    (rsoderh_raytracing_tpu/__init__.py: jax_debug_nans). The card cannot
    check every op as JAX does, so the port checks every wrapper's float
    outputs and the wavefront carry (check_nans). Read at each call; unset,
    nothing is checked and nothing waits for the device."""
    if os.environ.get("RT_DEBUG_NANS") != "1":
        return False
    warn_once("RT_DEBUG_NANS", "RT_DEBUG_NANS=1: every kernel's float outputs and the wavefront "
                               "carry are checked for NaN (a host sync a check)")
    return True


def use_plain(t: torch.Tensor, what: str) -> bool:
    """Whether a wrapper runs its plain twin for inputs on t's device:
    True on the CPU, False on the card, where it launches its kernel.
    Raises ValueError for any other device, and RuntimeError on the card
    under RT_DISABLE_PALLAS=1."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    if kernels_disabled():
        raise RuntimeError(
            f"{what}: RT_DISABLE_PALLAS=1 asks for no hand-written kernel, and on the card every "
            "query and shade is one; run with device='cpu' (--device cpu) for the plain path, "
            "or unset the knob")
    return False


def check_nans(op: str, outputs, names=()):
    """`outputs` (a dict of tensors, a tuple of them, named by `names` or
    by position, or one tensor) as given, after raising FloatingPointError
    naming `op` and the first float output that holds a NaN, when
    debug_nans() (one host sync a call). No output of the port carries a
    NaN by design: a miss holds t = 3e38, and the walks' NaN slab rule
    stays inside the kernels."""
    if not debug_nans():
        return outputs
    if isinstance(outputs, dict):
        named = list(outputs.items())
    elif isinstance(outputs, torch.Tensor):
        named = [(names[0] if names else "out", outputs)]
    else:
        named = list(zip(names or map(str, range(len(outputs))), outputs))
    floats = [(name, v) for name, v in named if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not floats:
        return outputs
    has_nan = torch.stack([torch.isnan(v).any() for _, v in floats])
    if bool(has_nan.any()):
        name, value = floats[int(has_nan.to(torch.int8).argmax())]
        raise FloatingPointError(
            f"RT_DEBUG_NANS: {op} output {name!r} holds {int(torch.isnan(value).sum())} NaN")
    return outputs


# The first parallel sine or cosine of a process can compute one CPU
# thread's share of the lanes differently from every later call (torch
# 2.13 for the CPU, MKL and OpenMP; a few percent of fresh processes:
# tests/test_torch_first_call.py). warm_cpu_math makes that first call,
# once a process, so the plain path's results do not depend on being first,
# over 2,048 lanes a thread (the grain of torch's unary float kernels) and
# at least four threads' worth.
_WARM_LANES = 8192
_warm = False


def warm_cpu_math() -> None:
    """Run torch's CPU sine and cosine once over its threads, the first
    time a process asks for the CPU, so that the plain path's own first
    call is right."""
    global _warm
    if not _warm:
        x = torch.linspace(-3.0, 3.0, max(_WARM_LANES, 2048 * torch.get_num_threads()))
        torch.sin(x)
        torch.cos(x)
        _warm = True


def resolve(device) -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and there is
    no CUDA device. The CPU gets warm_cpu_math first."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run its plain PyTorch path on the CPU"
        )
    if dev.type == "cpu":
        warm_cpu_math()
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
