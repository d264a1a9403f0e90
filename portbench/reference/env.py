"""The environment as the reference reads it: the Radiance .hdr file
decoded and RGBE-quantized, the luminance x sin(theta) weights, the Vose
alias table and the 16-byte RGBE quad rows, all worked out here from the
file alone (frozen copies of the port's env/hdr_io.py, env/alias_table.py
and env/environment.py arithmetic). The alias table's pairing loop is the
C++ copy beside this file (alias_table.cpp), built with g++ into
build/portbench/native/ of the checkout: the port builds its own copy of
the same source, and the numpy pairing differs from it at the 1e-6 level.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
ALIAS_SRC = os.path.join(_HERE, "alias_table.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def read_hdr(path: str) -> np.ndarray:
    """A Radiance RGBE file as (H, W, 3) float32 (flat and adaptive-RLE
    scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res!r}")
    height, width = int(res[1]), int(res[3])
    raw = np.frombuffer(data, dtype=np.uint8, offset=pos)
    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    idx = 0
    for y in range(height):
        if (8 <= width < 32768 and raw[idx] == 2 and raw[idx + 1] == 2
                and (int(raw[idx + 2]) << 8 | int(raw[idx + 3])) == width):
            idx += 4
            for ch in range(4):
                x = 0
                while x < width:
                    count = int(raw[idx])
                    idx += 1
                    if count > 128:
                        rgbe[y, x:x + count - 128, ch] = raw[idx]
                        idx += 1
                        x += count - 128
                    elif count == 0:
                        raise ValueError(f"{path}: corrupt RLE scanline {y}")
                    else:
                        rgbe[y, x:x + count, ch] = raw[idx:idx + count]
                        idx += count
                        x += count
        else:
            rgbe[y] = raw[idx:idx + width * 4].reshape(width, 4)
            idx += width * 4
    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 128 - 8)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    rgb = np.maximum(rgb, 0.0).astype(np.float32)
    max_c = rgb.max(axis=-1)
    exp = np.zeros_like(max_c, dtype=np.int32)
    nz = max_c >= 1e-32
    mant_nz, exp_nz = np.frexp(max_c[nz])
    exp[nz] = exp_nz
    scale = np.zeros_like(max_c)
    scale[nz] = mant_nz * 256.0 / max_c[nz]
    rgbe = np.zeros(rgb.shape[:-1] + (4,), dtype=np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return rgbe


def luminance_weights(tex: np.ndarray) -> np.ndarray:
    """Per-texel sampling weight: luminance x sin(theta of the row)."""
    height = tex.shape[0]
    rows = (np.arange(height, dtype=np.float32) + 0.5) * (np.pi / height)
    lum = (0.2126 * tex[..., 0] + 0.7152 * tex[..., 1] + 0.0722 * tex[..., 2]).astype(np.float32)
    return (lum * np.sin(rows)[:, None]).reshape(-1).astype(np.float32)


def _alias_library(build_dir: str) -> str:
    with open(ALIAS_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(build_dir, f"libalias_table_{tag}.so")
    if not os.path.exists(path):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        subprocess.run(["g++", *GXX_FLAGS, ALIAS_SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, path)
    return path


def alias_table(weights: np.ndarray, build_dir: str):
    """(probability, alias index, pmf) of the Vose table over `weights`,
    normalised to mean 1 in float32 as w * L / sum."""
    length = len(weights)
    total = float(weights.sum(dtype=np.float64))
    if total <= 0:
        probs = np.ones(length, np.float32)
    else:
        probs = (weights * np.float32(length) / np.float32(total)).astype(np.float32)
    lib = ctypes.CDLL(_alias_library(build_dir))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.build_alias_table.restype = ctypes.c_int64
    lib.build_alias_table.argtypes = [f32p, ctypes.c_int64, f32p, i32p, f32p]
    prob = np.empty(length, np.float32)
    alias = np.empty(length, np.int32)
    pmf = np.empty(length, np.float32)
    lib.build_alias_table(np.ascontiguousarray(probs), length, prob, alias, pmf)
    return prob, alias, pmf


@dataclasses.dataclass
class RefEnvironment:
    """The tables the estimator reads, on one device: (H*W, 4) int32 RGBE
    quad rows [c00 c10 c01 c11], (H*W, 4) f32 alias rows [probability,
    alias bits, pmf self, pmf alias], the alias indices and [L, weight
    sum]."""

    texture_shape: tuple
    quad: torch.Tensor
    alias_pair: torch.Tensor
    alias_index: torch.Tensor
    pmf_norm: torch.Tensor


def load_environment(path: str, device, build_dir: str) -> RefEnvironment:
    tex = rgbe_to_float(float_to_rgbe(read_hdr(path)))
    height, width = tex.shape[:2]
    weights = luminance_weights(tex)
    prob, alias, pmf = alias_table(weights, build_dir)
    xp = np.minimum(np.arange(width) + 1, width - 1)
    yp = np.minimum(np.arange(height) + 1, height - 1)
    rgbe = float_to_rgbe(tex).astype(np.uint32)
    word = rgbe[..., 0] | (rgbe[..., 1] << 8) | (rgbe[..., 2] << 16) | (rgbe[..., 3] << 24)
    quad = np.stack([word, word[:, xp], word[yp], word[yp][:, xp]], axis=-1).reshape(-1, 4)
    pair = np.stack([prob, alias.view(np.float32), pmf, pmf[alias]], axis=-1).astype(np.float32)
    total = np.float32(weights.sum(dtype=np.float64))
    return RefEnvironment(
        texture_shape=(height, width),
        quad=torch.from_numpy(quad.view(np.int32).copy()).to(device),
        alias_pair=torch.from_numpy(pair).to(device),
        alias_index=torch.from_numpy(alias.copy()).to(device),
        pmf_norm=torch.tensor([height * width, total], dtype=torch.float32, device=device),
    )
