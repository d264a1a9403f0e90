"""DeviceScene: the scene as padded structure-of-arrays tensors.

Port of rsoderh_raytracing_tpu/scene/device.py. The numpy body, the
padding rules and the precomputed intersection constants are the same,
so every field equals the reference's lane for lane; only the final
upload differs (torch tensors on an explicit device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rsoderh_raytracing_tpu.scene.types import Scene

# Copied from rsoderh_raytracing_tpu/ops/pallas_intersect.py (that module
# imports jax): the unrolled-sweep budget and the chunk height that
# decide the triangle padding.
MAX_UNROLL_PRIMS = 192
TRI_CHUNK = 64

FIELDS = (
    "mat_color", "mat_roughness", "mat_metallic", "mat_emission",
    "sph_pos", "sph_radius", "sph_material", "sph_valid",
    "pln_pos", "pln_normal", "pln_bcm", "pln_material", "pln_valid",
    "tri_a", "tri_edge0", "tri_edge1", "tri_n0", "tri_n1", "tri_n2",
    "tri_material", "tri_valid",
    "sph_c2", "pln_ndotp", "pln_r0", "pln_r2", "pln_r0dotp", "pln_r2dotp",
    "tri_cdet", "tri_cu", "tri_cv", "tri_n", "tri_adotn",
)


def _round_up(x: int, multiple: int) -> int:
    return max(multiple, -(-x // multiple) * multiple)


def _morton_order(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Stable argsort of triangles along a 30-bit Morton curve of their
    centroids (the reference's storage order for chunked scenes)."""
    cent = (
        vertices[tris[:, 0]] + vertices[tris[:, 1]] + vertices[tris[:, 2]]
    ) / 3.0
    lo = cent.min(axis=0)
    span = cent.max(axis=0) - lo
    span[span == 0] = 1.0
    q = np.clip((cent - lo) / span * 1023.0, 0, 1023).astype(np.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


@dataclasses.dataclass
class DeviceScene:
    """Padded SoA scene tensors; field names and meanings as in the
    reference (valid masks are bool, material ids int32)."""

    mat_color: torch.Tensor
    mat_roughness: torch.Tensor
    mat_metallic: torch.Tensor
    mat_emission: torch.Tensor
    sph_pos: torch.Tensor
    sph_radius: torch.Tensor
    sph_material: torch.Tensor
    sph_valid: torch.Tensor
    pln_pos: torch.Tensor
    pln_normal: torch.Tensor
    pln_bcm: torch.Tensor
    pln_material: torch.Tensor
    pln_valid: torch.Tensor
    tri_a: torch.Tensor
    tri_edge0: torch.Tensor
    tri_edge1: torch.Tensor
    tri_n0: torch.Tensor
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_material: torch.Tensor
    tri_valid: torch.Tensor
    sph_c2: torch.Tensor  # (S,) |c|^2 - r^2
    pln_ndotp: torch.Tensor  # (P,) n . pos
    pln_r0: torch.Tensor  # (P,3) bcm row 0
    pln_r2: torch.Tensor  # (P,3) bcm row 2
    pln_r0dotp: torch.Tensor
    pln_r2dotp: torch.Tensor
    tri_cdet: torch.Tensor  # (T,3) e1 x e0
    tri_cu: torch.Tensor  # (T,3) a x e1
    tri_cv: torch.Tensor  # (T,3) a x e0
    tri_n: torch.Tensor  # (T,3) e0 x e1
    tri_adotn: torch.Tensor  # (T,)
    # The packed table the TRACE kernel stages in shared memory; built
    # on first use by ops/cuda_wavefront.scene_table.
    kernel_table: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False
    )

    @property
    def device(self) -> torch.device:
        return self.sph_pos.device

    @property
    def num_lanes(self) -> int:
        return (
            self.sph_radius.shape[0]
            + self.pln_valid.shape[0]
            + self.tri_valid.shape[0]
        )


def build_device_scene(
    scene: Scene, device="cpu", pad_to: int = 8
) -> DeviceScene:
    """Flatten + pad a host Scene into a DeviceScene (no BVH: the BVH
    route is not ported yet)."""
    materials = scene.materials or []
    m = max(1, len(materials))
    mat_color = np.zeros((m, 3), np.float32)
    mat_roughness = np.zeros((m,), np.float32)
    mat_metallic = np.zeros((m,), np.float32)
    mat_emission = np.zeros((m, 3), np.float32)
    for i, mat in enumerate(materials):
        mat_color[i] = mat.color
        mat_roughness[i] = mat.roughness
        mat_metallic[i] = mat.metallic
        mat_emission[i] = mat.emission

    # Spheres pad to whole TRI_CHUNK windows when the sphere+plane unroll
    # would overflow the chunked kernels' per-step budget.
    s_n = _round_up(len(scene.spheres), pad_to)
    p_n_probe = _round_up(len(scene.planes), pad_to)
    if (
        len(scene.spheres) > 0
        and s_n + p_n_probe + TRI_CHUNK > MAX_UNROLL_PRIMS
        and p_n_probe + TRI_CHUNK <= MAX_UNROLL_PRIMS
    ):
        s_n = _round_up(len(scene.spheres), TRI_CHUNK)
    sph_pos = np.zeros((s_n, 3), np.float32)
    sph_radius = np.zeros((s_n,), np.float32)
    sph_material = np.zeros((s_n,), np.int32)
    sph_valid = np.zeros((s_n,), bool)
    for i, sph in enumerate(scene.spheres):
        sph_pos[i] = sph.pos
        sph_radius[i] = sph.radius
        sph_material[i] = sph.material_id
        sph_valid[i] = True
    if len(scene.spheres):
        # Padded spheres sit at the last real centre (radius 0).
        sph_pos[len(scene.spheres):] = sph_pos[len(scene.spheres) - 1]

    p_n = _round_up(len(scene.planes), pad_to)
    pln_pos = np.zeros((p_n, 3), np.float32)
    pln_normal = np.zeros((p_n, 3), np.float32)
    pln_bcm = np.zeros((p_n, 3, 3), np.float32)
    pln_material = np.zeros((p_n,), np.int32)
    pln_valid = np.zeros((p_n,), bool)
    for i, pln in enumerate(scene.planes):
        pln_pos[i] = pln.pos
        pln_normal[i] = pln.normal()
        pln_bcm[i] = pln.base_change_matrix()
        pln_material[i] = pln.material_id
        pln_valid[i] = True

    # Triangles pad to TRI_CHUNK whenever the total padded lane count
    # exceeds the unroll budget; such scenes are stored in Morton order,
    # the reference's default, so the fields still match it lane for lane
    # (rendering them raises: the big-scene route is not ported).
    tris = scene.meshes.triangles
    total_small = s_n + p_n + _round_up(len(tris), pad_to)
    if total_small > MAX_UNROLL_PRIMS and len(tris) > 0:
        tris = tris[_morton_order(scene.meshes.vertices, tris)]

    tri_pad = pad_to if total_small <= MAX_UNROLL_PRIMS else TRI_CHUNK
    t_n = _round_up(len(tris), tri_pad)
    tri_a = np.zeros((t_n, 3), np.float32)
    tri_edge0 = np.zeros((t_n, 3), np.float32)
    tri_edge1 = np.zeros((t_n, 3), np.float32)
    tri_n0 = np.zeros((t_n, 3), np.float32)
    tri_n1 = np.zeros((t_n, 3), np.float32)
    tri_n2 = np.zeros((t_n, 3), np.float32)
    tri_material = np.zeros((t_n,), np.int32)
    tri_valid = np.zeros((t_n,), bool)
    if len(tris):
        v = scene.meshes.vertices
        n = scene.meshes.normals
        a = v[tris[:, 0]]
        b = v[tris[:, 1]]
        c = v[tris[:, 2]]
        tri_a[: len(tris)] = a
        tri_edge0[: len(tris)] = b - a
        tri_edge1[: len(tris)] = c - a
        tri_n0[: len(tris)] = n[tris[:, 3]]
        tri_n1[: len(tris)] = n[tris[:, 4]]
        tri_n2[: len(tris)] = n[tris[:, 5]]
        tri_material[: len(tris)] = tris[:, 6]
        tri_valid[: len(tris)] = True

    # Intersection constants: sph_c2 in float64 (cancellation-sensitive),
    # the rest in f32, exactly as the reference computes them.
    sph_c2 = (sph_pos.astype(np.float64) ** 2).sum(-1) - (
        sph_radius.astype(np.float64) ** 2
    )
    pln_ndotp = (pln_normal * pln_pos).sum(-1)
    pln_r0 = pln_bcm[:, 0, :]
    pln_r2 = pln_bcm[:, 2, :]
    pln_r0dotp = (pln_r0 * pln_pos).sum(-1)
    pln_r2dotp = (pln_r2 * pln_pos).sum(-1)
    tri_cdet = np.cross(tri_edge1, tri_edge0)
    tri_cu = np.cross(tri_a, tri_edge1)
    tri_cv = np.cross(tri_a, tri_edge0)
    tri_n = np.cross(tri_edge0, tri_edge1)
    tri_adotn = (tri_a * tri_n).sum(-1)

    arrays = dict(
        mat_color=mat_color, mat_roughness=mat_roughness,
        mat_metallic=mat_metallic, mat_emission=mat_emission,
        sph_pos=sph_pos, sph_radius=sph_radius, sph_material=sph_material,
        sph_valid=sph_valid,
        pln_pos=pln_pos, pln_normal=pln_normal, pln_bcm=pln_bcm,
        pln_material=pln_material, pln_valid=pln_valid,
        tri_a=tri_a, tri_edge0=tri_edge0, tri_edge1=tri_edge1,
        tri_n0=tri_n0, tri_n1=tri_n1, tri_n2=tri_n2,
        tri_material=tri_material, tri_valid=tri_valid,
        sph_c2=sph_c2, pln_ndotp=pln_ndotp, pln_r0=pln_r0, pln_r2=pln_r2,
        pln_r0dotp=pln_r0dotp, pln_r2dotp=pln_r2dotp,
        tri_cdet=tri_cdet, tri_cu=tri_cu, tri_cv=tri_cv, tri_n=tri_n,
        tri_adotn=tri_adotn,
    )
    return device_scene_from_arrays(arrays, device)


def device_scene_from_arrays(arrays: dict, device="cpu") -> DeviceScene:
    """Build a DeviceScene from a dict of numpy arrays keyed by field name
    (for example the fields of the JAX package's DeviceScene). Float
    fields become float32, material ids int32, valid masks bool."""
    out = {}
    for name in FIELDS:
        arr = np.asarray(arrays[name])
        if name.endswith("_valid"):
            arr = arr.astype(bool)
        elif name.endswith("_material"):
            arr = arr.astype(np.int32)
        else:
            arr = arr.astype(np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)
    return DeviceScene(**out)
