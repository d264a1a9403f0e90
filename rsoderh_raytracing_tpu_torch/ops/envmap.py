"""Environment sampling (port of rsoderh_raytracing_tpu/ops/envmap.py).

Equirect uv <-> direction, the RGBE decode, the alias-table draw and the
quad-row bilinear fetch with its pmf (recomputed from the texel for RGBE
rows, stored in columns 12-15 of the legacy float rows). Vectors travel
as component tensors, as in the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch.env.environment import DeviceEnvironment
from rsoderh_raytracing_tpu_torch.ops import rng

PI = rng.PI_DEVICE
INV_PI = 1.0 / PI
_INT_MAX_F = 2147483520.0  # largest f32 below 2^31


def float_to_int(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 toward zero, saturating, NaN -> 0: XLA's conversion
    (and CUDA's __float2int_rz). A bare .to(int32) is undefined there."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    out = x.clamp(-2147483648.0, _INT_MAX_F).to(torch.int32)
    return torch.where(x >= 2147483648.0, 2147483647, out)


def decode_rgbe(word: torch.Tensor):
    """int32 tensor of u32 RGBE words -> (r, g, b) f32 tensors.
    value = byte * 2^(e-136); e == 0 is black. The scale is built from
    the f32 exponent bits, as in the reference."""
    word = word.to(torch.int32)
    r = (word & 0xFF).to(torch.float32)
    g = ((word >> 8) & 0xFF).to(torch.float32)
    b = ((word >> 16) & 0xFF).to(torch.float32)
    e = (word >> 24) & 0xFF
    bits = torch.clamp(e - 136 + 127, 1, 254) << 23
    scale = torch.where(e == 0, 0.0, bits.view(torch.float32))
    return r * scale, g * scale, b * scale


def direction_to_equirect_uv(dx, dy, dz):
    """Unit direction components -> (u, v). (shader.wgsl:710-714)"""
    u = torch.atan2(dz, dx) * (INV_PI * 0.5) + 0.5
    v = 0.5 - torch.asin(torch.clamp(dy, -1.0, 1.0)) * INV_PI
    return u, v


def equirect_uv_to_direction(u, v):
    """(u, v) -> direction components. (shader.wgsl:718-732)"""
    phi = (2.0 * u - 1.0) * PI
    theta = PI * v
    sin_theta = torch.sin(theta)
    return sin_theta * torch.cos(phi), torch.cos(theta), sin_theta * torch.sin(phi)


def pixel_solid_angle(v, width: int, height: int):
    """Solid angle of the lat-long pixel at v. (shader.wgsl:739-749)"""
    sin_t = torch.clamp_min(torch.sin(PI * v), 1.0e-6)
    return (2.0 * PI / width) * (PI / height) * sin_t


def sample_alias_index(state: torch.Tensor, env: DeviceEnvironment):
    """Alias-table index draw + jittered uv (shader.wgsl:689-706,793-803).

    ``state`` is int64 (u32 values). Returns (state, index, u, v, pmf).
    Draw order: index, alias accept, jitter x, jitter y."""
    height, width = env.texture_shape
    length = width * height
    state, u_index = rng.next_uniform(state)
    index = torch.clamp_max(float_to_int(u_index * float(length)), length - 1)
    state, u_accept = rng.next_uniform(state)
    pair = env.alias_pair.index_select(0, index)
    keep = u_accept < pair[:, 0]
    index = torch.where(keep, index, env.alias_index.index_select(0, index))
    pmf = torch.where(keep, pair[:, 2], pair[:, 3])
    x = index % width
    y = index // width
    state, jitter_x = rng.next_uniform(state)
    state, jitter_y = rng.next_uniform(state)
    u = (x.to(torch.float32) + jitter_x) / width
    v = (y.to(torch.float32) + jitter_y) / height
    return state, index, u, v, pmf


def env_draw(state: torch.Tensor, env: DeviceEnvironment):
    """The alias draw from int64 ``state`` and its NEE direction: the
    plain twin of the ENV_DRAW kernel (ops/cuda_wavefront.py). Returns
    (state, nee_u, nee_v, nee_pmf, nee_dir)."""
    state, _, nee_u, nee_v, nee_pmf = sample_alias_index(state, env)
    return state, nee_u, nee_v, nee_pmf, equirect_uv_to_direction(nee_u, nee_v)


def trace_glue(state: torch.Tensor, env: DeviceEnvironment, dx, dy, dz):
    """What one wavefront iteration computes from the environment before
    its sweeps (reference render/wavefront.py:928-938): the alias draw
    from int64 ``state``, its NEE uv and direction (env_draw), and the uv
    of the ray (dx, dy, dz) should it escape. Returns (state, nee_u,
    nee_v, nee_pmf, nee_dir, miss_u, miss_v)."""
    state, nee_u, nee_v, nee_pmf, nee_dir = env_draw(state, env)
    miss_u, miss_v = direction_to_equirect_uv(dx, dy, dz)
    return state, nee_u, nee_v, nee_pmf, nee_dir, miss_u, miss_v


def _quad_texels(q):
    """The four texels (c00, c10, c01, c11) of gathered quad rows, each
    an (r, g, b) tuple: decoded RGBE words, or the radiance columns of a
    legacy float row. Also returns the float row (None for RGBE)."""
    if q.dtype == torch.int32:
        return tuple(decode_rgbe(q[:, k]) for k in range(4)), None
    row = q.to(torch.float32)
    return tuple(tuple(row[:, 3 * k + i] for i in range(3)) for k in range(4)), row


def _bilinear(texels, u, v, width: int, height: int):
    """Bilinear blend of a row's texels at uv; also the row's (x0, y0)."""
    x = u * width - 0.5
    y = v * height - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where(x0 < 0, 0.0, x - x0)
    fy = torch.where(y0 < 0, 0.0, y - y0)
    x0i = torch.clamp(float_to_int(x0), 0, width - 1)
    y0i = torch.clamp(float_to_int(y0), 0, height - 1)
    c00, c10, c01, c11 = texels
    radiance = tuple(
        (c00[i] * (1.0 - fx) + c10[i] * fx) * (1.0 - fy)
        + (c01[i] * (1.0 - fx) + c11[i] * fx) * fy
        for i in range(3)
    )
    return radiance, x0i, y0i


def radiance_and_pmf_from_quad(q, u, v, width: int, height: int, pmf_norm):
    """Bilinear radiance and texel pmf from gathered quad rows.

    q: (n, 4) int32 RGBE words [c00 c10 c01 c11] of the row at uv's
    (x0, y0), or (n, 16) legacy float rows. Returns ((r, g, b), pmf). For
    RGBE rows the pmf is recomputed from the selected texel:
    ((lum * sin(theta) * L) / Z) / L, with np.pi like the alias builder;
    legacy rows carry it in columns 12-15."""
    texels, row = _quad_texels(q)
    radiance, x0i, y0i = _bilinear(texels, u, v, width, height)
    pxsel = torch.clamp_max(float_to_int(u * width), width - 1)
    pysel = torch.clamp_max(float_to_int(v * height), height - 1)
    sel_x = pxsel != x0i
    sel_y = pysel != y0i
    if row is not None:
        pmf = torch.where(
            sel_y,
            torch.where(sel_x, row[:, 15], row[:, 14]),
            torch.where(sel_x, row[:, 13], row[:, 12]),
        )
        return radiance, pmf
    c00, c10, c01, c11 = texels
    selt = tuple(
        torch.where(
            sel_y,
            torch.where(sel_x, c11[i], c01[i]),
            torch.where(sel_x, c10[i], c00[i]),
        )
        for i in range(3)
    )
    lum = 0.2126 * selt[0] + 0.7152 * selt[1] + 0.0722 * selt[2]
    sin_theta = torch.sin(
        (pysel.to(torch.float32) + 0.5) * float(np.float32(np.pi / height))
    )
    length = pmf_norm[0]
    total = pmf_norm[1]
    pmf = torch.where(
        total > 0.0,
        ((lum * sin_theta * length) / total) / length,
        1.0 / length,
    )
    return radiance, pmf


def quad_index(u, v, width: int, height: int):
    """Row of the quad table that serves uv: y0 * W + x0 (clamped)."""
    x0 = torch.floor(u * width - 0.5)
    y0 = torch.floor(v * height - 0.5)
    x0i = torch.clamp(float_to_int(x0), 0, width - 1)
    y0i = torch.clamp(float_to_int(y0), 0, height - 1)
    return y0i * width + x0i


def radiance_and_pmf(env: DeviceEnvironment, u, v):
    """ONE quad-row gather -> (bilinear radiance, pmf at uv's texel)."""
    height, width = env.texture_shape
    q = env.quad.index_select(0, quad_index(u, v, width, height))
    return radiance_and_pmf_from_quad(q, u, v, width, height, env.pmf_norm)


def bilinear_sample_quad(env: DeviceEnvironment, u, v):
    """Bilinear radiance (r, g, b) at uv: one quad-row gather."""
    height, width = env.texture_shape
    q = env.quad.index_select(0, quad_index(u, v, width, height))
    return _bilinear(_quad_texels(q)[0], u, v, width, height)[0]


def sky_light(env: DeviceEnvironment, dx, dy, dz):
    """Environment radiance along escaped rays (shader.wgsl:822-831)."""
    return bilinear_sample_quad(env, *direction_to_equirect_uv(dx, dy, dz))


def direction_pdf(env: DeviceEnvironment, dx, dy, dz):
    """Pdf (per steradian) of sampling the direction from the alias
    table, read through the quad row like the integrators' miss pdf
    (shader.wgsl:753-769)."""
    height, width = env.texture_shape
    u, v = direction_to_equirect_uv(dx, dy, dz)
    _, pmf = radiance_and_pmf(env, u, v)
    return pmf / pixel_solid_angle(v, width, height)


def sample_environment(state: torch.Tensor, env: DeviceEnvironment):
    """Alias-table importance sample (shader.wgsl:782-820): four draws.
    ``state`` is int64. Returns (state, direction (dx, dy, dz), radiance
    (r, g, b), pdf)."""
    height, width = env.texture_shape
    state, _, u, v, pmf = sample_alias_index(state, env)
    direction = equirect_uv_to_direction(u, v)
    radiance = bilinear_sample_quad(env, u, v)
    return state, direction, radiance, pmf / pixel_solid_angle(v, width, height)
