"""Host-side scene model (pure numpy, no JAX).

Mirrors the data model of the reference renderer's scene layer
(reference: src/scene.rs) while staying a plain-Python/numpy design:
materials are referenced by name in the TOML and resolved to integer ids;
planes are finite parallelograms described by (pos, forward, right) and
precomputed into (normal, inverse change-of-basis matrix) for the device.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Material:
    """Metallic-roughness material (reference: src/scene.rs:16-23)."""

    color: np.ndarray  # (3,) float32 albedo / metal reflectance
    roughness: float
    metallic: float
    emission: np.ndarray  # (3,) float32

    def __post_init__(self):
        self.color = np.asarray(self.color, dtype=np.float32)
        self.emission = np.asarray(self.emission, dtype=np.float32)
        self.roughness = float(self.roughness)
        self.metallic = float(self.metallic)


@dataclasses.dataclass
class Sphere:
    pos: np.ndarray  # (3,)
    radius: float
    material_id: int

    def __post_init__(self):
        self.pos = np.asarray(self.pos, dtype=np.float32)
        self.radius = float(self.radius)

    def bounds(self) -> "Bounds3":
        r = np.full(3, self.radius, dtype=np.float32)
        return Bounds3(self.pos - r, self.pos + r)


@dataclasses.dataclass
class Plane:
    """Finite parallelogram: pos + s*right + t*forward for s,t in [0,1].

    (reference: src/scene.rs:182-207)
    """

    pos: np.ndarray
    forward: np.ndarray
    right: np.ndarray
    material_id: int

    def __post_init__(self):
        self.pos = np.asarray(self.pos, dtype=np.float32)
        self.forward = np.asarray(self.forward, dtype=np.float32)
        self.right = np.asarray(self.right, dtype=np.float32)

    def normal(self) -> np.ndarray:
        n = np.cross(self.forward, self.right)
        return (n / np.linalg.norm(n)).astype(np.float32)

    def base_change_matrix(self) -> np.ndarray:
        """Inverse of the base {right, normal, forward} as columns.

        Converts a world-space offset (point - pos) into plane-space where
        the hit test is x,z in [0,1] (reference: src/scene.rs:190-201,
        shader.wgsl:380-391).
        """
        basis = np.stack([self.right, self.normal(), self.forward], axis=1)
        return np.linalg.inv(basis.astype(np.float64)).astype(np.float32)

    def bounds(self) -> "Bounds3":
        pts = np.stack([self.pos, self.pos + self.forward + self.right])
        return Bounds3(pts.min(axis=0), pts.max(axis=0))


@dataclasses.dataclass
class Bounds3:
    """Axis-aligned bounding box (reference: src/scene.rs:60-141)."""

    min: np.ndarray
    max: np.ndarray

    @staticmethod
    def identity() -> "Bounds3":
        return Bounds3(
            np.full(3, np.finfo(np.float32).max, dtype=np.float32),
            np.full(3, -np.finfo(np.float32).max, dtype=np.float32),
        )

    @staticmethod
    def from_points(points: np.ndarray) -> "Bounds3":
        points = np.asarray(points, dtype=np.float32)
        return Bounds3(points.min(axis=0), points.max(axis=0))

    def union(self, other: "Bounds3") -> "Bounds3":
        return Bounds3(
            np.minimum(self.min, other.min), np.maximum(self.max, other.max)
        )

    def center(self) -> np.ndarray:
        return self.min * 0.5 + self.max * 0.5

    def max_axis(self) -> int:
        """Longest axis, ties broken like the reference (z > y > x strict)."""
        d = self.max - self.min
        if d[2] > d[0] and d[2] > d[1]:
            return 2
        if d[1] > d[0]:
            return 1
        return 0

    def surface_area(self) -> float:
        d = (self.max - self.min).astype(np.float32)
        return float(2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]))


@dataclasses.dataclass
class PackedMeshes:
    """All OBJ meshes concatenated into one indexed triangle soup.

    (reference: src/mesh.rs:84-136)
    vertices: (V,3) f32, normals: (N,3) f32,
    triangles: (T,7) int32 rows = (v0,v1,v2,n0,n1,n2,material_id).
    """

    vertices: np.ndarray
    normals: np.ndarray
    triangles: np.ndarray

    @staticmethod
    def empty() -> "PackedMeshes":
        return PackedMeshes(
            vertices=np.zeros((0, 3), dtype=np.float32),
            normals=np.zeros((0, 3), dtype=np.float32),
            triangles=np.zeros((0, 7), dtype=np.int32),
        )

    @staticmethod
    def pack(meshes: List["PackedMeshes"]) -> "PackedMeshes":
        if not meshes:
            return PackedMeshes.empty()
        vertices, normals, triangles = [], [], []
        v_off = 0
        n_off = 0
        for mesh in meshes:
            tri = mesh.triangles.copy()
            tri[:, 0:3] += v_off
            tri[:, 3:6] += n_off
            triangles.append(tri)
            vertices.append(mesh.vertices)
            normals.append(mesh.normals)
            v_off += len(mesh.vertices)
            n_off += len(mesh.normals)
        return PackedMeshes(
            vertices=np.concatenate(vertices, axis=0),
            normals=np.concatenate(normals, axis=0),
            triangles=np.concatenate(triangles, axis=0),
        )

    def triangle_vertices(self) -> np.ndarray:
        """(T,3,3) world-space corner positions of every triangle."""
        if len(self.triangles) == 0:
            return np.zeros((0, 3, 3), dtype=np.float32)
        return self.vertices[self.triangles[:, 0:3]]


@dataclasses.dataclass
class Scene:
    materials: List[Material]
    spheres: List[Sphere]
    planes: List[Plane]
    meshes: PackedMeshes
    camera: "Camera"  # noqa: F821  (scene.camera.Camera)

    @property
    def primitive_count(self) -> int:
        return len(self.spheres) + len(self.planes) + len(self.meshes.triangles)
