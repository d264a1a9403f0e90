"""Pinhole camera model, base64 state codec, and fly controller physics.

Matches the reference camera (src/camera.rs): rotation is
Ry(yaw) @ Rx(pitch); the serialized state is 24 little-endian bytes
(pos xyz, yaw, pitch, fov_y as f32) in standard base64 so ``--state``
strings are interchangeable with the reference CLI.
"""

from __future__ import annotations

import base64
import dataclasses
import math
import struct

import numpy as np


def _rot_x(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def _rot_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


@dataclasses.dataclass
class Camera:
    pos: np.ndarray  # (3,) float32
    yaw: float  # radians
    pitch: float  # radians
    fov_y: float  # radians, vertical fov

    def __post_init__(self):
        self.pos = np.asarray(self.pos, dtype=np.float32)
        self.yaw = float(self.yaw)
        self.pitch = float(self.pitch)
        self.fov_y = float(self.fov_y)

    def rot_transform(self) -> np.ndarray:
        """Camera-to-world rotation = Ry(yaw) @ Rx(pitch).

        (reference: src/camera.rs:26-29)
        """
        return (_rot_y(self.yaw) @ _rot_x(self.pitch)).astype(np.float32)

    # -- state codec (reference: src/camera.rs:30-89) ----------------------

    def serialize(self) -> str:
        data = struct.pack(
            "<ffffff",
            float(self.pos[0]),
            float(self.pos[1]),
            float(self.pos[2]),
            self.yaw,
            self.pitch,
            self.fov_y,
        )
        return base64.standard_b64encode(data).decode("ascii")

    @staticmethod
    def deserialize(encoded: str) -> "Camera":
        data = base64.standard_b64decode(encoded)
        if len(data) != 24:
            raise ValueError(
                f"Couldn't deserialize camera: binary data ({len(data)} bytes)"
                " not 24 bytes"
            )
        x, y, z, yaw, pitch, fov_y = struct.unpack("<ffffff", data)
        return Camera(pos=np.array([x, y, z]), yaw=yaw, pitch=pitch, fov_y=fov_y)

    def state_hash(self) -> int:
        """Bitwise hash of the camera state, used to reset accumulation
        when the camera moves (reference: src/camera.rs:92-100)."""
        bits = np.concatenate(
            [
                self.pos.astype(np.float32).view(np.uint32),
                np.array(
                    [self.yaw, self.pitch, self.fov_y], dtype=np.float32
                ).view(np.uint32),
            ]
        )
        return hash(bits.tobytes())


@dataclasses.dataclass
class ControllerConfig:
    """Fly-camera physics constants (reference: src/camera.rs:203-213)."""

    max_speed: float = 3.0  # units / s
    acceleration: float = 10.0  # units / s^2
    friction: float = 15.0  # units / s^2
    turn_factor: float = 0.25  # degrees / pixel
    slow_factor: float = 0.1  # scale while shift held


class CameraController:
    """Accelerate/friction fly movement + mouse turn, decoupled from any
    windowing system. Feed key state + mouse deltas, call update(dt).

    (reference: src/camera.rs:184-364 SceneController)
    """

    def __init__(self, config: ControllerConfig | None = None):
        self.config = config or ControllerConfig()
        self.velocity = np.zeros(3, dtype=np.float32)
        self.delta_pixels = np.zeros(2, dtype=np.float32)
        self.pressed = {
            k: False
            for k in ("forward", "back", "left", "right", "up", "down", "slow")
        }

    def set_key(self, name: str, is_pressed: bool) -> None:
        if name in self.pressed:
            self.pressed[name] = bool(is_pressed)

    def add_mouse_delta(self, dx: float, dy: float) -> None:
        self.delta_pixels += np.array([dx, dy], dtype=np.float32)

    def update(self, camera: Camera, delta_seconds: float) -> Camera:
        cfg = self.config
        p = self.pressed
        direction = np.array(
            [
                (1.0 if p["right"] else 0.0) + (-1.0 if p["left"] else 0.0),
                (1.0 if p["up"] else 0.0) + (-1.0 if p["down"] else 0.0),
                (1.0 if p["back"] else 0.0) + (-1.0 if p["forward"] else 0.0),
            ],
            dtype=np.float32,
        )
        direction = _rot_y(camera.yaw) @ direction
        norm = np.linalg.norm(direction)
        if norm > 0:
            direction = direction / norm
        factor = cfg.slow_factor if p["slow"] else 1.0
        target_velocity = direction * cfg.max_speed * factor
        accel = (
            cfg.friction
            if not np.any(target_velocity)
            else cfg.acceleration * factor
        )

        delta = target_velocity - self.velocity
        dist = np.linalg.norm(delta)
        max_delta = accel * delta_seconds
        if dist <= max_delta or dist == 0.0:
            self.velocity = target_velocity
        else:
            self.velocity = self.velocity + delta / dist * max_delta
        if np.linalg.norm(self.velocity) < 1.0e-3:
            self.velocity = np.zeros(3, dtype=np.float32)

        pos = camera.pos + self.velocity * delta_seconds
        yaw = camera.yaw + math.radians(
            -float(self.delta_pixels[0]) * cfg.turn_factor
        )
        pitch = camera.pitch + math.radians(
            -float(self.delta_pixels[1]) * cfg.turn_factor
        )
        self.delta_pixels = np.zeros(2, dtype=np.float32)
        return Camera(pos=pos, yaw=yaw, pitch=pitch, fov_y=camera.fov_y)


@dataclasses.dataclass
class KeyboardLayout:
    """Maps movement/other key characters (reference: src/camera.rs:122-181)."""

    forward: str
    left: str
    back: str
    right: str
    down: str
    up: str
    capture_mouse: str
    print_camera_state: str
    next_environment: str

    @staticmethod
    def parse_config(movement: str, other: str) -> "KeyboardLayout":
        movement = movement.lower()
        other = other.lower()
        if len(movement) != 6:
            raise ValueError(
                f"Invalid keyboard config '{movement}': expected 6 characters."
            )
        if len(other) != 3:
            raise ValueError(
                f"Invalid mouse capture config '{other}': expected 3 character."
            )
        f, l, b, r, d, u = movement
        c, p, e = other
        return KeyboardLayout(
            forward=f,
            left=l,
            back=b,
            right=r,
            down=d,
            up=u,
            capture_mouse=c,
            print_camera_state=p,
            next_environment=e,
        )
