"""Minimal dependency-free PNG writer (RGB8), and a reader of what it
writes."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 (or float in [0,1]) as a PNG file."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected (H,W,3), got {image.shape}")
    height, width = image.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    raw = b"".join(
        b"\x00" + image[row].tobytes() for row in range(height)
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an RGB8 PNG as write_png writes it (8-bit RGB, no interlace,
    every scanline with filter 0) into (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace")
    width, height = header[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, 1 + width * 3)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines are not supported")
    return rows[:, 1:].reshape(height, width, 3).copy()
