"""The one traffic generator: everything a run sends the program comes
from the mix's parameters and --seed, through numpy's PCG64 generator.

- ``base_counts``: every pixel's first progressive sample index, uniform
  in [0, base_max): what a resumed render's checkpoint holds;
- ``fly_path``: the camera of each frame. One flight from the scene's
  camera, flown round and round and the same for every seed: the mix's
  legs of held keys and mouse moves, through a copy of the upstream fly
  controller (src/camera.rs:184-364) at the mix's frame time. The seed
  picks the frame of the flight that a run starts at, so every run flies
  the same views from another start;
- ``check_pixels`` and ``pick``: which pixels, calls and frames the
  comparison with the reference reads, drawn from the seed too.

The seed may be any whole number up to 2**64: each stream takes a
SeedSequence of (seed, stream number).
"""

from __future__ import annotations

import math

import numpy as np

BASE, CAMERA, PIXELS, PICK = range(4)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed) & (2**64 - 1), stream])))


def base_counts(seed: int, mix: dict, width: int, height: int) -> np.ndarray:
    return rng(seed, BASE).integers(0, int(mix["base_max"]), size=(height, width), dtype=np.int64)


def _rot_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


def flight(cam: dict, start) -> list:
    """The frames (pos (3,) f32, yaw, pitch) of one flight from start =
    (pos, yaw, pitch) (radians): for each leg, `frames` updates of the
    upstream fly controller at cam["frame_s"] seconds a frame, its keys
    held and the mouse moved by mouse_px pixels a frame. Every frame has
    moved the camera, so the viewer resets the film each frame."""
    dt = float(cam["frame_s"])
    speed, accel, friction = float(cam["max_speed"]), float(cam["acceleration"]), float(cam["friction"])
    turn = float(cam["turn_deg_per_px"])
    pos = np.asarray(start[0], np.float32)
    yaw, pitch = float(start[1]), float(start[2])
    vel = np.zeros(3, np.float32)
    frames = []
    for leg in cam["legs"]:
        keys = set(leg["keys"])
        dx, dy = (float(v) for v in leg["mouse_px"])
        for _ in range(int(leg["frames"])):
            direction = np.array([("right" in keys) - ("left" in keys), ("up" in keys) - ("down" in keys),
                                  ("back" in keys) - ("forward" in keys)], dtype=np.float32)
            direction = _rot_y(yaw) @ direction
            norm = np.linalg.norm(direction)
            if norm > 0:
                direction = direction / norm
            target = direction * speed
            rate = accel if np.any(target) else friction
            delta = target - vel
            dist = np.linalg.norm(delta)
            if dist <= rate * dt or dist == 0.0:
                vel = target
            else:
                vel = vel + delta / dist * (rate * dt)
            if np.linalg.norm(vel) < 1.0e-3:
                vel = np.zeros(3, np.float32)
            pos = (pos + vel * dt).astype(np.float32)
            yaw += math.radians(-dx * turn)
            pitch += math.radians(-dy * turn)
            frames.append((pos, yaw, pitch))
    views = [(tuple(p.tolist()), y, q) for p, y, q in [(start[0], start[1], start[2])] + frames]
    if any(a == b for a, b in zip(views, views[1:] + views[:1])) or len(set(views)) != len(views):
        raise ValueError("the flight holds a frame at which the camera did not move")
    return frames


def fly_path(seed: int, mix: dict, start):
    """An endless iterator of the flight's frames, round and round, from
    the frame that the seed picks."""
    frames = flight(mix["camera"], start)
    k = int(rng(seed, CAMERA).integers(len(frames)))
    while True:
        yield frames[k]
        k = (k + 1) % len(frames)


def check_pixels(seed: int, mix: dict, width: int, height: int) -> np.ndarray:
    """Flat indices of the pixels the comparison reads, distinct."""
    n = min(int(mix["check_pixels"]), width * height)
    return np.sort(rng(seed, PIXELS).choice(width * height, size=n, replace=False)).astype(np.int64)


def pick(seed: int, count: int, available: int) -> list:
    """`count` distinct indices of `available` (all where fewer), sorted:
    the calls or frames the comparison reads."""
    n = min(count, available)
    return sorted(int(i) for i in rng(seed, PICK).choice(available, size=n, replace=False))
