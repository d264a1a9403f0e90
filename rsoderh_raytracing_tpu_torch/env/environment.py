"""Environment map: host HDRI + alias table, and its device tensors.

Port of rsoderh_raytracing_tpu/env/environment.py: the RGBE ``quad``
layout that the kernel loop reads and the legacy float32 / bfloat16
layouts with stored pmf columns, with the environment set
(``EnvironmentMaps``, ``load_default_environments``) copied as it is.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
from typing import List

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device, tracing
from rsoderh_raytracing_tpu_torch.env import hdr_io
from rsoderh_raytracing_tpu_torch.env.alias_table import (
    AliasTable,
    build_alias_table,
    build_weights_by_luminance,
)

# Names of the two HDRIs the reference embeds (src/state.rs:119-122).
DEFAULT_ENVIRONMENT_NAMES = ("winter_lake_01_2k", "passendorf_snow_2k")


@dataclasses.dataclass
class Environment:
    """One HDRI + its importance-sampling table (host side). The texture
    is RGBE-quantized at construction, as in the reference."""

    name: str
    texture: np.ndarray  # (H, W, 3) float32, lat-long (RGBE-quantized)
    alias: AliasTable
    weight_sum: float = 0.0  # f32(sum of luminance*sin(theta) weights)

    @property
    def width(self) -> int:
        return self.texture.shape[1]

    @property
    def height(self) -> int:
        return self.texture.shape[0]

    @staticmethod
    @tracing.traced("env.build")
    def from_texture(name: str, texture: np.ndarray) -> "Environment":
        texture = hdr_io.rgbe_quantize(np.asarray(texture, np.float32))
        weights = build_weights_by_luminance(texture)
        return Environment(
            name=name,
            texture=texture,
            alias=build_alias_table(weights),
            weight_sum=float(np.float32(weights.sum(dtype=np.float64))),
        )


@dataclasses.dataclass
class DeviceEnvironment:
    """The active environment on the device.

    - ``quad``: (H*W, 4) int32 holding u32 RGBE words of the neighbour
      texels [c00 c10 c01 c11]: one 16-byte row serves a bilinear fetch
      and the in-register pmf of its texel. The legacy layouts are
      (H*W, 16) float32 or bfloat16 rows: the four texels' radiance (12
      columns) and their stored pmf (columns 12-15).
    - ``alias_pair``: (H*W, 4) float32 [probability, alias_index_bits,
      pmf_self, pmf_alias]. Column 1 holds int32 BITS; ``alias_index`` is
      that column read back with ``.view(torch.int32)`` (a value cast
      would round indices above 2^24).
    - ``pmf_norm``: (2,) float32 [table length, weight sum].
    """

    texture_shape: tuple  # (H, W)
    quad: torch.Tensor
    alias_pair: torch.Tensor
    pmf_norm: torch.Tensor
    alias_index: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        self.alias_index = self.alias_pair[:, 1].contiguous().view(torch.int32)

    @property
    def device(self) -> torch.device:
        return self.quad.device

    def to(self, device) -> "DeviceEnvironment":
        """A replica on `device` (every table copied)."""
        return _device.copy_to(self, device)


def _neighbours(width: int, height: int):
    return np.minimum(np.arange(width) + 1, width - 1), np.minimum(np.arange(height) + 1, height - 1)


def _quad_words(tex: np.ndarray) -> np.ndarray:
    height, width = tex.shape[:2]
    xp, yp = _neighbours(width, height)
    rgbe = hdr_io.float_to_rgbe(tex).astype(np.uint32)
    word = rgbe[..., 0] | (rgbe[..., 1] << 8) | (rgbe[..., 2] << 16) | (rgbe[..., 3] << 24)
    return np.stack(
        [word, word[:, xp], word[yp], word[yp][:, xp]], axis=-1
    ).reshape(height * width, 4)


def _quad_legacy(tex: np.ndarray, pmf: np.ndarray) -> np.ndarray:
    """(H*W, 16) float32 rows: radiance of [c00 c10 c01 c11], then their
    alias-table pmf."""
    height, width = tex.shape[:2]
    xp, yp = _neighbours(width, height)
    pmf = np.asarray(pmf, np.float32).reshape(height, width)[..., None]
    return np.concatenate(
        [tex, tex[:, xp], tex[yp], tex[yp][:, xp], pmf, pmf[:, xp], pmf[yp], pmf[yp][:, xp]],
        axis=-1,
    ).reshape(height * width, 16)


def bfloat16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bit patterns of its bfloat16 rounding (to
    nearest, ties to even), as XLA converts."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


@tracing.traced("env.upload")
def device_environment(
    env: Environment, device=_device.DEFAULT, radiance_dtype: str = "rgbe"
) -> DeviceEnvironment:
    """Upload an environment to `device`. `radiance_dtype` sets the quad
    storage: "rgbe" (16-byte u32 rows, the pmf recomputed from the texel:
    the layout the kernel loop reads), or the legacy "float32" /
    "bfloat16" rows with stored pmf columns, which the composed wavefront
    body and the scan integrator read. RGBE-quantized radiance is exact
    in both legacy types; bfloat16 rounds the pmf columns by about 0.4%,
    so there the BSDF-hit MIS pdf differs slightly from the f32 NEE pdf,
    as in the reference."""
    tex = np.asarray(env.texture, np.float32)
    height, width = tex.shape[:2]
    if radiance_dtype == "rgbe":
        quad = _quad_words(tex)
    elif radiance_dtype == "float32":
        quad = _quad_legacy(tex, env.alias.pmf)
    elif radiance_dtype == "bfloat16":
        quad = bfloat16_bits(_quad_legacy(tex, env.alias.pmf))
    else:
        raise ValueError(f"unknown radiance_dtype '{radiance_dtype}'")
    alias_pair = np.stack(
        [
            env.alias.probability,
            env.alias.alias_index.astype(np.int32).view(np.float32),
            env.alias.pmf,
            env.alias.pmf[env.alias.alias_index],
        ],
        axis=-1,
    ).astype(np.float32)
    weight_sum = env.weight_sum
    if weight_sum <= 0.0:
        weight_sum = float(
            np.float32(build_weights_by_luminance(tex).sum(dtype=np.float64))
        )
    return device_environment_from_arrays(
        (height, width),
        quad,
        alias_pair,
        np.array([height * width, weight_sum], np.float32),
        device,
    )


def device_environment_from_arrays(
    texture_shape, quad, alias_pair, pmf_norm, device=_device.DEFAULT
) -> DeviceEnvironment:
    """Build the port's environment from numpy arrays, for example the
    fields of the JAX package's DeviceEnvironment. ``quad`` is (L, 4)
    uint32 (or its int32 bits) for the RGBE layout, (L, 16) float32 for
    the legacy float layout, or (L, 16) two-byte values (bfloat16, or its
    uint16 bits) for the legacy bfloat16 layout; ``alias_pair`` (L, 4)
    float32 with int32 bits in column 1."""
    device = _device.resolve(device)
    quad = np.ascontiguousarray(quad)
    if quad.shape[1] == 4:
        quad_t = torch.from_numpy(quad.view(np.int32).copy())
    elif quad.dtype.itemsize == 2:
        quad_t = torch.from_numpy(quad.view(np.int16).copy()).view(torch.bfloat16)
    else:
        quad_t = torch.from_numpy(quad.astype(np.float32))
    return DeviceEnvironment(
        texture_shape=(int(texture_shape[0]), int(texture_shape[1])),
        quad=quad_t.to(device),
        alias_pair=torch.from_numpy(
            np.ascontiguousarray(alias_pair, np.float32).copy()
        ).to(device),
        pmf_norm=torch.from_numpy(
            np.asarray(pmf_norm, np.float32).copy()
        ).to(device),
    )


class EnvironmentMaps:
    """Ordered set of environments; index cycling matches the reference's
    'e' key behavior (src/camera.rs:271-278)."""

    def __init__(self, environments: List[Environment]):
        if not environments:
            raise ValueError("need at least one environment")
        self.environments = environments

    def __len__(self) -> int:
        return len(self.environments)

    def __getitem__(self, index: int) -> Environment:
        return self.environments[index]

    def next_index(self, index: int) -> int:
        index += 1
        return 0 if index >= len(self.environments) else index


def load_default_environments(
    hdri_dir: str | None = None, resolution: int = 1024
) -> EnvironmentMaps:
    """Load HDRIs from `hdri_dir` (any .hdr/.npy files; default
    assets/hdri of the checkout), or synthesize the two default procedural
    skies if the directory has none."""
    if hdri_dir is None:
        hdri_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "assets",
            "hdri",
        )

    def _order(path: str):
        # The reference loads winter_lake first, passendorf second
        # (src/state.rs:119-122); keep that order for the known names,
        # extras after, alphabetically.
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            return (DEFAULT_ENVIRONMENT_NAMES.index(name), name)
        except ValueError:
            return (len(DEFAULT_ENVIRONMENT_NAMES), name)

    paths = sorted(
        glob.glob(os.path.join(hdri_dir, "*.hdr"))
        + glob.glob(os.path.join(hdri_dir, "*.npy")),
        key=_order,
    )
    environments = []
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            texture = hdr_io.load_image(path)
        except (ValueError, OSError) as err:
            logging.getLogger(__name__).warning("Skipping HDRI %s: %s", path, err)
            continue
        environments.append(Environment.from_texture(name, texture))

    if not environments:
        width, height = resolution, resolution // 2
        # Stand-in for winter_lake_01_2k: bright cold sky, high sun.
        environments.append(
            Environment.from_texture(
                DEFAULT_ENVIRONMENT_NAMES[0],
                hdr_io.procedural_sky(
                    width,
                    height,
                    sun_direction=(0.35, 0.45, -0.82),
                    sun_intensity=220.0,
                    zenith_color=(0.22, 0.45, 0.95),
                ),
            )
        )
        # Stand-in for passendorf_snow_2k: overcast warm low sun.
        environments.append(
            Environment.from_texture(
                DEFAULT_ENVIRONMENT_NAMES[1],
                hdr_io.procedural_sky(
                    width,
                    height,
                    sun_direction=(-0.6, 0.18, 0.78),
                    sun_intensity=90.0,
                    sun_radius=0.035,
                    zenith_color=(0.45, 0.52, 0.62),
                    horizon_color=(0.8, 0.78, 0.75),
                ),
            )
        )
    return EnvironmentMaps(environments)
