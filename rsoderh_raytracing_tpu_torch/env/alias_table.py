"""Vose alias-table construction for O(1) HDRI importance sampling.

A verbatim copy of ``rsoderh_raytracing_tpu.env.alias_table`` (pure
numpy; the original's package imports jax). The native fast path it
calls, ``rsoderh_raytracing_tpu.accel.native``, imports without jax.

Same construction as the reference (src/environments.rs:96-187):
per-pixel weight = luminance(color) * sin(theta_row) (lat-long solid-angle
correction), weights normalized to mean 1, then the small/large worklist
pairing; unpaired leftovers become identity entries with probability 1.

The table is consumed on-device by ops/envmap.py: three arrays
(probability, alias_index, pmf) instead of the reference's interleaved
16-byte struct — SoA suits TPU gathers.

A C++ native fast path (native/) accelerates the pairing loop for
multi-megapixel HDRIs; the numpy/Python fallback below is identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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

    try:
        from rsoderh_raytracing_tpu.accel.native import (
            build_alias_table_native,
        )

        result = build_alias_table_native(probabilities)
        if result is not None:
            prob, alias, pmf, leftover = result
            return AliasTable(probability=prob, alias_index=alias, pmf=pmf)
    except ImportError:
        pass

    return _build_python(probabilities)


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
    import logging

    logging.getLogger(__name__).info(
        "AliasTable: %d left over pixels out of %d",
        int(length - assigned.sum()),
        length,
    )
    return AliasTable(
        probability=out_probability, alias_index=out_alias, pmf=out_pmf
    )
