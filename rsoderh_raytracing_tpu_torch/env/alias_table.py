"""Vose alias-table construction for O(1) HDRI importance sampling.

A copy of ``rsoderh_raytracing_tpu.env.alias_table`` (pure numpy; the
original's package imports jax), with its own native fast path: the C++
pairing loop in ``csrc/alias_table.cpp`` (a copy of the reference
package's), built at first use with the reference's g++ flags into
``build/native/`` at the root of the checkout (accel/native.host_library).

Same construction as the reference (src/environments.rs:96-187):
per-pixel weight = luminance(color) * sin(theta_row) (lat-long solid-angle
correction), weights normalized to mean 1, then the small/large worklist
pairing; unpaired leftovers become identity entries with probability 1.

The table is consumed on-device by ops/envmap.py: three arrays
(probability, alias_index, pmf) instead of the reference's interleaved
16-byte struct — SoA suits TPU gathers.

The C++ fast path accelerates the pairing loop for multi-megapixel
HDRIs. It is tried first, as in the reference, because the two builders
are not bitwise equal: the numpy/Python fallback below differs from it
at the 1e-6 level (tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import os
import subprocess
import threading

import numpy as np

from rsoderh_raytracing_tpu_torch.accel.native import NATIVE_DIR, host_library  # noqa: F401

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(_PKG, "csrc", "alias_table.cpp")

_native_lock = threading.Lock()
_native_lib = None
_native_failed = False


@dataclasses.dataclass
class AliasTable:
    probability: np.ndarray  # (L,) f32 — threshold to keep own index
    alias_index: np.ndarray  # (L,) i32
    pmf: np.ndarray  # (L,) f32 — discrete probability of each entry

    @property
    def size(self) -> int:
        return len(self.probability)


def luminance(rgb: np.ndarray) -> np.ndarray:
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    ).astype(np.float32)


def build_weights_by_luminance(hdri: np.ndarray) -> np.ndarray:
    """Per-pixel sampling weight for an (H,W,3) lat-long HDRI."""
    height = hdri.shape[0]
    rows = (np.arange(height, dtype=np.float32) + 0.5) * (np.pi / height)
    sin_theta = np.sin(rows)[:, None]
    return (luminance(hdri) * sin_theta).reshape(-1).astype(np.float32)


def build_alias_table(weights: np.ndarray) -> AliasTable:
    """Build the alias table from non-negative weights (any shape -> flat)."""
    weights = np.asarray(weights, dtype=np.float32).reshape(-1)
    length = len(weights)
    if length == 0:
        raise ValueError("alias table needs at least one weight")

    weight_sum = float(weights.sum(dtype=np.float64))
    if weight_sum <= 0:
        probabilities = np.ones(length, dtype=np.float32)
    else:
        # Normalize to mean 1 with the reference's f32 arithmetic shape:
        # w * length / sum (src/environments.rs:110-118).
        probabilities = (
            weights * np.float32(length) / np.float32(weight_sum)
        ).astype(np.float32)

    result = build_alias_table_native(probabilities)
    if result is not None:
        prob, alias, pmf = result
        return AliasTable(probability=prob, alias_index=alias, pmf=pmf)
    return _build_python(probabilities)


def _load_native():
    """The compiled C++ builder, built on first use; None (logged) where
    g++ is missing or fails, so callers fall back to numpy."""
    global _native_lib, _native_failed
    with _native_lock:
        if _native_lib is not None or _native_failed:
            return _native_lib
        try:
            lib = ctypes.CDLL(host_library(NATIVE_SRC))
        except (OSError, subprocess.CalledProcessError) as err:
            logging.getLogger(__name__).warning(
                "native alias-table builder unavailable (%s); using numpy", err)
            _native_failed = True
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.build_alias_table.restype = ctypes.c_int64
        lib.build_alias_table.argtypes = [f32p, ctypes.c_int64, f32p, i32p, f32p]
        _native_lib = lib
        return lib


def build_alias_table_native(probabilities: np.ndarray):
    """probabilities: f32 normalized to mean 1. Returns (probability,
    alias_index, pmf) from the C++ builder, or None without it."""
    lib = _load_native()
    if lib is None:
        return None
    probabilities = np.ascontiguousarray(probabilities, np.float32)
    length = len(probabilities)
    out_prob = np.empty(length, np.float32)
    out_alias = np.empty(length, np.int32)
    out_pmf = np.empty(length, np.float32)
    leftover = lib.build_alias_table(probabilities, length, out_prob, out_alias, out_pmf)
    if leftover > 0:
        logging.getLogger(__name__).info(
            "AliasTable: %d left over pixels out of %d", leftover, length)
    return out_prob, out_alias, out_pmf


def _build_python(probabilities: np.ndarray) -> AliasTable:
    length = len(probabilities)
    alias_probabilities = probabilities.copy()
    pmf_src = probabilities / np.float32(length)

    small = [i for i in range(length) if probabilities[i] < 1.0]
    large = [i for i in range(length) if probabilities[i] >= 1.0]

    out_probability = np.ones(length, dtype=np.float32)
    out_alias = np.arange(length, dtype=np.int32)
    # Leftover (never-paired) entries keep probability 1 / alias=self
    # like the reference, but store their TRUE weight-proportional pmf
    # rather than the reference's 1/length (environments.rs:161-183):
    # a leftover's actual draw rate includes every alias slot pointing
    # at it, so 1/length misreports the sampling pdf — and, decisively,
    # the RGBE quad path RECOMPUTES the pmf from radiance for BSDF-hit
    # MIS (ops/envmap.py:_texel_pmf); storing the true pmf keeps both
    # MIS arms consistent for any HDRI (a bright texel stranded in the
    # large worklist would otherwise pair a ~1/L NEE pdf with a
    # weight-proportional BSDF pdf and lose its energy in both arms).
    out_pmf = pmf_src.astype(np.float32).copy()
    assigned = np.zeros(length, dtype=bool)

    while small and large:
        small_index = small.pop()
        large_index = large.pop()

        out_probability[small_index] = alias_probabilities[small_index]
        out_alias[small_index] = large_index
        out_pmf[small_index] = pmf_src[small_index]
        assigned[small_index] = True

        alias_probabilities[large_index] = np.float32(
            alias_probabilities[large_index]
            - (np.float32(1.0) - alias_probabilities[small_index])
        )
        if alias_probabilities[large_index] < 1.0:
            small.append(large_index)
        else:
            large.append(large_index)

    # Unassigned entries keep the identity defaults (probability 1,
    # alias=self) with their true pmf — see the out_pmf comment above.
    logging.getLogger(__name__).info(
        "AliasTable: %d left over pixels out of %d",
        int(length - assigned.sum()),
        length,
    )
    return AliasTable(
        probability=out_probability, alias_index=out_alias, pmf=out_pmf
    )
