"""ACES-fitted tonemapping and the sRGB transfer (port of
rsoderh_raytracing_tpu/ops/tonemap.py; reference src/shaders/hdr.wgsl)."""

from __future__ import annotations

import torch

from rsoderh_raytracing_tpu_torch import tracing

# WGSL mat3x3 constructors are column-major; rows here are transposed
# accordingly so that (M @ v) matches (m * v) in the shader.
_M1 = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
_M2 = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def aces_tonemap(hdr: torch.Tensor) -> torch.Tensor:
    """(..., 3) linear HDR -> (..., 3) in [0, 1]; negative pixels are
    painted magenta, as in the reference. Its three constant uploads are
    host syncs on the card (sync.tonemap)."""
    tracing.count("sync.tonemap", 3)
    m1 = torch.tensor(_M1, dtype=hdr.dtype, device=hdr.device)
    m2 = torch.tensor(_M2, dtype=hdr.dtype, device=hdr.device)
    negative = (hdr < 0.0).any(dim=-1, keepdim=True)
    v = hdr @ m1.T
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    mapped = torch.clamp((a / b) @ m2.T, 0.0, 1.0)
    magenta = torch.tensor([1.0, 0.0, 1.0], dtype=hdr.dtype, device=hdr.device)
    return torch.where(negative, magenta, mapped)


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 transfer, used when writing PNGs."""
    linear = torch.clamp(linear, 0.0, 1.0)
    return torch.where(
        linear <= 0.0031308,
        linear * 12.92,
        1.055 * torch.pow(linear, 1.0 / 2.4) - 0.055,
    )
