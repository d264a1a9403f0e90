"""The benchmark's frozen copy of the port's counter-style per-lane u32 RNG
(rsoderh_raytracing_tpu_torch/ops/rng.py; originally rsoderh_raytracing_tpu/ops/rng.py).

The same PCG-ish hash stream: each lane carries a u32 state seeded from
(pixel_index, sample_index); every draw advances it with

    state = state * 747796405 + 2891336453
    result = ((state >> ((state >> 28) + 4)) ^ state) * 277803737
    result = (result >> 22) ^ result

PyTorch has no usable uint32 arithmetic on the CPU (no add, shift or
compare), so the plain code holds u32 values in int64 tensors masked to
32 bits. The largest products (state * 747796405, result * 277803737)
stay below 2^62. Tensors that cross into a CUDA kernel carry the u32 bit
pattern as int32 (``to_bits`` / ``from_bits``); the kernels read them as
``uint32_t``.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_MUL = 747796405
_INC = 2891336453
_MIX = 277803737

# The reference's truncated device constants (shader.wgsl:239, :628).
PI_DEVICE = 3.14159
TWO_PI_CIRCLE = 2.0 * 3.1415926


def from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 (or any integer) u32 bit pattern -> int64 value in [0, 2^32)."""
    return bits.to(torch.int64) & MASK


def to_bits(value: torch.Tensor) -> torch.Tensor:
    """int64 value in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(value >= 2**31, value - 2**32, value).to(torch.int32)


def seed(pixel_index, sample_index) -> torch.Tensor:
    """state = 0; salt(pixel); salt(sample) (shader.wgsl:1310-1312).
    Inputs are integer tensors (or ints) holding u32 values."""
    state = torch.as_tensor(pixel_index).to(torch.int64) & MASK
    state, _ = next_u32(state)
    state = state ^ (torch.as_tensor(sample_index, device=state.device).to(torch.int64) & MASK)
    state, _ = next_u32(state)
    return state


def next_u32(state: torch.Tensor):
    """Advance the generator. Returns (new_state, u32 result), int64."""
    state = (state * _MUL + _INC) & MASK
    shift = (state >> 28) + 4
    result = ((torch.bitwise_right_shift(state, shift) ^ state) * _MIX) & MASK
    result = (result >> 22) ^ result
    return state, result


def next_uniform(state: torch.Tensor):
    """Uniform float32 in [0, 1]. Returns (new_state, value)."""
    state, bits = next_u32(state)
    # int64 -> f32 rounds to nearest even, like XLA's u32 -> f32; the
    # divisor 4294967295.0 rounds to 2^32 in f32, as in the reference.
    return state, bits.to(torch.float32) / 4294967295.0


def next_in_circle(state: torch.Tensor):
    """Uniform point in the unit disk (shader.wgsl:627-631).
    Returns (new_state, x, y)."""
    state, angle_u = next_uniform(state)
    angle = angle_u * TWO_PI_CIRCLE
    state, radius_u = next_uniform(state)
    radius = torch.sqrt(radius_u)
    return state, radius * torch.cos(angle), radius * torch.sin(angle)
