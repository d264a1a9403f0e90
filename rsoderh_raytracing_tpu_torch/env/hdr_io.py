"""HDR image I/O and procedural sky synthesis.

A verbatim copy of ``rsoderh_raytracing_tpu.env.hdr_io`` (pure numpy):
the original cannot be imported without jax, because its package's
``__init__`` imports the jax environment module. Tests hold the two
copies bitwise equal.

The reference embeds two 2k Radiance ``.hdr`` equirect HDRIs at compile
time (src/state.rs:119-122). Those binaries are not redistributable here,
so this module provides:

- a self-contained Radiance RGBE ``.hdr`` reader/writer (numpy only),
- ``.npy``/``.npz`` float32 loading,
- a procedural clear-sky + sun generator used as the default stand-in
  environments (deterministic, so goldens are stable).
"""

from __future__ import annotations

import os

import numpy as np

from rsoderh_raytracing_tpu_torch import tracing


# -- Radiance RGBE (.hdr) -----------------------------------------------------


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance RGBE file into (H, W, 3) float32."""
    with open(path, "rb") as f:
        data = f.read()

    # Header ends at the first empty line; next line is the resolution.
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    resolution = data[pos:eol].split()
    pos = eol + 1
    if len(resolution) != 4 or resolution[0] != b"-Y" or resolution[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {resolution!r}")
    height = int(resolution[1])
    width = int(resolution[3])

    raw = np.frombuffer(data, dtype=np.uint8, offset=pos)
    rgbe = np.zeros((height, width, 4), dtype=np.uint8)

    idx = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and raw[idx] == 2
            and raw[idx + 1] == 2
            and (int(raw[idx + 2]) << 8 | int(raw[idx + 3])) == width
        ):
            # Adaptive RLE: four separate channel streams per scanline.
            idx += 4
            try:
                for ch in range(4):
                    x = 0
                    while x < width:
                        count = int(raw[idx])
                        idx += 1
                        if count > 128:  # run
                            rgbe[y, x : x + count - 128, ch] = raw[idx]
                            idx += 1
                            x += count - 128
                        elif count == 0:
                            # A zero literal count would advance nothing
                            # and loop forever: corrupt stream.
                            raise ValueError(
                                f"{path}: corrupt RLE scanline {y}"
                                " (zero-length literal)"
                            )
                        else:  # literal
                            rgbe[y, x : x + count, ch] = raw[idx : idx + count]
                            idx += count
                            x += count
            except IndexError as err:
                raise ValueError(
                    f"{path}: truncated RLE data in scanline {y}"
                ) from err
        else:
            # Flat scanline.
            flat = raw[idx : idx + width * 4].reshape(width, 4)
            rgbe[y] = flat
            idx += width * 4

    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 128 - 8)).astype(
        np.float32
    )
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    rgb = np.maximum(rgb, 0.0).astype(np.float32)
    max_c = rgb.max(axis=-1)
    exp = np.zeros_like(max_c, dtype=np.int32)
    mant = np.zeros_like(max_c)
    nz = max_c >= 1e-32
    mant_nz, exp_nz = np.frexp(max_c[nz])
    exp[nz] = exp_nz
    mant[nz] = mant_nz
    scale = np.zeros_like(max_c)
    scale[nz] = mant_nz * 256.0 / max_c[nz]
    rgbe = np.zeros(rgb.shape[:-1] + (4,), dtype=np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(
        np.uint8
    )
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return rgbe


def rgbe_quantize(rgb: np.ndarray) -> np.ndarray:
    """Round-trip (H, W, 3) float32 through RGBE (shared-exponent u8).

    The device radiance tables store RGBE words (16-byte quad rows — the
    gather-rate sweet spot), so the authoritative texture is defined as
    the RGBE-decoded values. Real ``.hdr`` HDRIs are RGBE-encoded on disk
    (the reference's own environments are Radiance files,
    src/state.rs:119-122), so for them this is (near-)lossless; RGBE
    values are also exactly representable in bfloat16 and float32,
    keeping every quad storage mode bit-compatible."""
    return rgbe_to_float(float_to_rgbe(rgb))


def _rle_encode_channel(data: np.ndarray) -> bytes:
    """Adaptive-RLE encode one scanline channel (width u8 values):
    count>128 = run of (count-128) copies; count<=128 = literal block.
    Matches the decoder in read_hdr (and the Radiance file format)."""
    out = bytearray()
    width = len(data)
    x = 0
    while x < width:
        # Find a run of >= 4 identical bytes (Radiance's break-even).
        run_start = x
        while run_start < width:
            run_len = 1
            while (
                run_len < 127
                and run_start + run_len < width
                and data[run_start + run_len] == data[run_start]
            ):
                run_len += 1
            if run_len >= 4:
                break
            run_start += 1
        else:
            run_start = width
            run_len = 0
        # Literals up to the run.
        lit = run_start - x
        while lit > 0:
            n = min(lit, 128)
            out.append(n)
            out.extend(data[x : x + n].tobytes())
            x += n
            lit -= n
        if run_start < width and run_len >= 4:
            out.append(128 + run_len)
            out.append(int(data[run_start]))
            x = run_start + run_len
    return bytes(out)


def write_hdr(path: str, rgb: np.ndarray, rle: bool = True) -> None:
    """Write (H, W, 3) float32 as a Radiance HDR file (adaptive RLE by
    default when the width allows it; flat otherwise)."""
    height, width = rgb.shape[:2]
    rgbe = float_to_rgbe(rgb)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {height} +X {width}\n".encode())
        if rle and 8 <= width < 32768:
            for y in range(height):
                f.write(bytes([2, 2, (width >> 8) & 0xFF, width & 0xFF]))
                for ch in range(4):
                    f.write(_rle_encode_channel(rgbe[y, :, ch]))
        else:
            f.write(rgbe.tobytes())


# -- generic loading ----------------------------------------------------------


@tracing.traced("hdr.load")
def load_image(path: str) -> np.ndarray:
    """Load an HDRI as (H, W, 3) float32 from .hdr/.npy/.npz."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return read_hdr(path)
    if ext == ".npy":
        arr = np.load(path)
    elif ext == ".npz":
        with np.load(path) as z:
            arr = z[list(z.files)[0]]
    else:
        raise ValueError(f"Unsupported HDRI format: {path}")
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[2] < 3:
        raise ValueError(f"{path}: expected (H,W,3) array, got {arr.shape}")
    return arr[..., :3]


# -- procedural sky -----------------------------------------------------------


def procedural_sky(
    width: int = 1024,
    height: int = 512,
    sun_direction=(0.35, 0.45, -0.82),
    sun_intensity: float = 220.0,
    sun_radius: float = 0.02,
    zenith_color=(0.22, 0.45, 0.95),
    horizon_color=(0.85, 0.87, 0.92),
    ground_color=(0.32, 0.28, 0.24),
    overall_scale: float = 1.0,
) -> np.ndarray:
    """Deterministic clear-sky HDRI in lat-long layout, (H, W, 3) float32.

    Row v maps to polar angle theta = pi*v, column u to azimuth
    phi = (2u-1)*pi, matching the shader's equirect convention
    (shader.wgsl:718-732): direction = (sin t cos p, cos t, sin t sin p).
    """
    v = (np.arange(height, dtype=np.float32) + 0.5) / height
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    theta = np.pi * v[:, None]
    phi = (2.0 * u[None, :] - 1.0) * np.pi

    sin_t = np.sin(theta)
    dir_x = sin_t * np.cos(phi)
    dir_y = np.cos(theta) * np.ones_like(phi)
    dir_z = sin_t * np.sin(phi)

    sun = np.asarray(sun_direction, dtype=np.float32)
    sun = sun / np.linalg.norm(sun)
    cos_sun = dir_x * sun[0] + dir_y * sun[1] + dir_z * sun[2]

    up = np.clip(dir_y, -1.0, 1.0)
    sky_t = np.clip(up, 0.0, 1.0) ** 0.6
    zenith = np.asarray(zenith_color, dtype=np.float32)
    horizon = np.asarray(horizon_color, dtype=np.float32)
    ground = np.asarray(ground_color, dtype=np.float32)

    img = (
        sky_t[..., None] * zenith[None, None, :]
        + (1.0 - sky_t[..., None]) * horizon[None, None, :]
    )
    below = up < 0.0
    ground_t = np.clip(-up, 0.0, 1.0)[..., None] ** 0.5
    img = np.where(
        below[..., None],
        ground_t * ground[None, None, :] + (1 - ground_t) * horizon[None, None, :],
        img,
    )

    # Sun disk with a soft edge plus a wide glow term.
    ang = np.arccos(np.clip(cos_sun, -1.0, 1.0))
    disk = np.clip(1.0 - ang / sun_radius, 0.0, 1.0) ** 2
    glow = np.exp(-ang * 14.0) * 0.6
    img = img + (disk * sun_intensity + glow)[..., None] * np.array(
        [1.0, 0.93, 0.82], dtype=np.float32
    )

    return (img * overall_scale).astype(np.float32)
