"""DeviceScene: the scene as padded structure-of-arrays tensors.

Port of rsoderh_raytracing_tpu/scene/device.py. The numpy body, the
padding rules and the precomputed intersection constants are the same,
so every field equals the reference's lane for lane; only the final
upload differs (torch tensors on the card unless another device is
asked for).

Scenes past the unroll budget take the chunked route: the chunk
predicates, ceilings, bounds and window rows below are those of
rsoderh_raytracing_tpu/ops/pallas_intersect.py (which imports jax).
``device_scene_from_arrays`` also packs, once per scene, the flat tables
the CUDA kernels read (row layouts in csrc/wavefront_common.cuh): the
small route's ``trace_table``, or the chunked route's ``chunks``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device
from rsoderh_raytracing_tpu_torch.scene.types import Scene

# From rsoderh_raytracing_tpu/ops/pallas_intersect.py: the unrolled-sweep
# budget, the chunk height that decides the triangle padding, and the
# chunked route's ceilings (the reference's defaults, without its
# environment overrides).
MAX_UNROLL_PRIMS = 192
TRI_CHUNK = 64
MAX_CHUNKED_TRIS = 262144
MAX_CHUNKED_SPHERES = 262144

# Window rows of the chunked kernels (pallas_intersect.tri_const_table /
# sphere_const_table): one 20-float row a primitive.
WIN_COLS = 20
# Row widths of the packed scene table and of the big-mesh union rows
# (csrc/wavefront_common.cuh).
SPH_COLS, PLN_COLS, TRI_COLS, MAT_COLS = 8, 16, 36, 8
WINNER_SLOTS = 20

SMALL, CHUNKED = "small", "chunked"

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
    # The TRACE kernel's table (pack_rows: every primitive and material
    # row), built with the scene when its route is SMALL.
    trace_table: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    # Rows of each kind (sphere, plane, triangle) up to its last valid
    # one: what CLOSEST and ANY sweep of the table (the padding is
    # trailing, so these are the valid counts).
    sweep_rows: tuple = (0, 0, 0)
    # The chunked route's tables (ChunkTables), built with the scene
    # when its route is CHUNKED.
    chunks: Optional["ChunkTables"] = dataclasses.field(default=None, repr=False)

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


@dataclasses.dataclass
class ChunkTables:
    """The big-mesh route's scene data: chunks [0, n_tri_chunks) are
    triangle windows, the rest sphere windows (spheres join the chunks
    only when they no longer fit the unrolled step)."""

    bounds: torch.Tensor  # (C, 6) f32 [min xyz, max xyz], inflated
    windows: torch.Tensor  # (C * TRI_CHUNK, WIN_COLS) f32
    n_tri_chunks: int
    n_sph_chunks: int
    # The unrolled primitives the chunked kernels sweep before any
    # window (pack_rows: sphere rows unless spheres are chunked, then
    # plane rows).
    small: torch.Tensor
    winner: torch.Tensor  # (S + P + T, WINNER_SLOTS) f32 union rows (winner_rows)
    materials: torch.Tensor  # (n_mat, MAT_COLS) f32 (material_rows)

    @property
    def count(self) -> int:
        return self.n_tri_chunks + self.n_sph_chunks


def counts_chunk_spheres(n_sph: int, n_pln: int) -> bool:
    """Sphere lanes stream as chunk windows when the sphere+plane unroll
    no longer fits the per-step budget (pallas_intersect._counts_chunk_spheres)."""
    return (
        n_sph + n_pln + TRI_CHUNK > MAX_UNROLL_PRIMS
        and n_sph > 0
        and n_sph % TRI_CHUNK == 0
        and n_sph <= MAX_CHUNKED_SPHERES
        and n_pln + TRI_CHUNK <= MAX_UNROLL_PRIMS
    )


def counts_chunked_applicable(n_sph: int, n_pln: int, n_tri: int) -> bool:
    """Whether the chunked route covers padded lane counts
    (pallas_intersect._counts_chunked_applicable)."""
    if n_tri % TRI_CHUNK != 0 or n_tri > MAX_CHUNKED_TRIS:
        return False
    if n_sph + n_pln + TRI_CHUNK <= MAX_UNROLL_PRIMS:
        return n_tri > 0
    return counts_chunk_spheres(n_sph, n_pln)


def _counts(scene):
    return scene.sph_radius.shape[0], scene.pln_valid.shape[0], scene.tri_valid.shape[0]


def chunk_spheres(scene) -> bool:
    return counts_chunk_spheres(*_counts(scene)[:2])


def scene_chunk_count(scene) -> int:
    """Triangle windows plus (when chunk_spheres) sphere windows
    (pallas_intersect.scene_chunk_count)."""
    n_sph, _, n_tri = _counts(scene)
    c = -(-n_tri // TRI_CHUNK) if n_tri else 0
    if chunk_spheres(scene):
        c += -(-n_sph // TRI_CHUNK)
    return c


def route(scene) -> str:
    """SMALL (every primitive in the unrolled sweep) or CHUNKED; raises
    NotImplementedError for a scene that is neither."""
    n_sph, n_pln, n_tri = _counts(scene)
    if n_sph + n_pln + n_tri <= MAX_UNROLL_PRIMS:
        return SMALL
    if counts_chunked_applicable(n_sph, n_pln, n_tri):
        return CHUNKED
    raise NotImplementedError(
        f"scene with {n_sph} sphere, {n_pln} plane and {n_tri} triangle lanes "
        f"is past the unroll budget ({MAX_UNROLL_PRIMS}) and outside the chunked "
        "route's limits: it needs the BVH route, which is not ported yet"
    )


def chunk_bounds(tri_a, tri_edge0, tri_edge1):
    """(n_chunks, 6) f32 AABBs of each TRI_CHUNK-triangle chunk over its
    vertices a, a+e0, a+e1, inflated by (hi-lo)*1e-5 + 1e-5
    (pallas_intersect.chunk_bounds). Padded triangles collapse to the
    origin, which only enlarges a chunk."""
    n_chunks = tri_a.shape[0] // TRI_CHUNK
    pts = np.stack([tri_a, tri_a + tri_edge0, tri_a + tri_edge1], axis=1)
    pts = pts.reshape(n_chunks, TRI_CHUNK * 3, 3)
    return _inflate(pts.min(axis=1), pts.max(axis=1))


def sphere_chunk_bounds(sph_pos, sph_radius):
    """(n_sph_chunks, 6) f32 AABBs over centre +- radius, inflated like
    chunk_bounds (pallas_intersect.sphere_chunk_bounds)."""
    n_chunks = sph_radius.shape[0] // TRI_CHUNK
    r = sph_radius[:, None]
    lo = (sph_pos - r).reshape(n_chunks, TRI_CHUNK, 3).min(axis=1)
    hi = (sph_pos + r).reshape(n_chunks, TRI_CHUNK, 3).max(axis=1)
    return _inflate(lo, hi)


def _inflate(lo, hi):
    eps = (hi - lo) * np.float32(1.0e-5) + np.float32(1.0e-5)
    return np.concatenate([lo - eps, hi + eps], axis=-1).astype(np.float32)


def pair_nan_bounds(bounds):
    """(C, 6) bounds with a NaN on either side of an axis written to both
    sides. A NaN vertex leaves its chunk's axis without a constraint; the
    chunked kernels' fast slab test reads that from both sides being NaN
    (csrc/chunked.cu: slab_pass_finite). min/max and _inflate above already
    give pairs; this holds it for any bounds."""
    nan = np.isnan(bounds[:, :3]) | np.isnan(bounds[:, 3:])
    return np.where(np.concatenate([nan, nan], axis=1), np.float32(np.nan), bounds)


def tri_const_table(a: dict):
    """(n_tri, WIN_COLS) f32 triangle window rows: cdet, e0, e1, cu, cv,
    n, adotn, valid (pallas_intersect.tri_const_table)."""
    return np.concatenate(
        [a["tri_cdet"], a["tri_edge0"], a["tri_edge1"], a["tri_cu"], a["tri_cv"],
         a["tri_n"], a["tri_adotn"][:, None], a["tri_valid"].astype(np.float32)[:, None]],
        axis=1,
    ).astype(np.float32)


def sphere_const_table(a: dict):
    """(n_sph, WIN_COLS) f32 sphere window rows: pos, c2, valid, zeros
    (pallas_intersect.sphere_const_table)."""
    n = a["sph_radius"].shape[0]
    return np.concatenate(
        [a["sph_pos"], a["sph_c2"][:, None], a["sph_valid"].astype(np.float32)[:, None],
         np.zeros((n, WIN_COLS - 5), np.float32)],
        axis=1,
    ).astype(np.float32)


def pack_rows(scene, spheres=True, triangles=True, materials=True) -> torch.Tensor:
    """Sphere, plane, triangle and material rows packed into one flat f32
    table, in that order; the sphere, triangle and material rows only
    where asked for."""

    def cols(*parts):
        return torch.cat(
            [p.to(torch.float32).reshape(p.shape[0], -1) for p in parts], dim=1
        )

    def pad(t, width):
        return torch.nn.functional.pad(t, (0, width - t.shape[1]))

    rows = []
    if spheres:
        rows.append(pad(cols(scene.sph_pos, scene.sph_c2, scene.sph_radius,
                             scene.sph_material, scene.sph_valid), SPH_COLS))
    rows.append(pad(cols(scene.pln_normal, scene.pln_ndotp, scene.pln_r0,
                         scene.pln_r2, scene.pln_r0dotp, scene.pln_r2dotp,
                         scene.pln_material, scene.pln_valid), PLN_COLS))
    if triangles:
        rows.append(pad(cols(scene.tri_cdet, scene.tri_edge0, scene.tri_edge1,
                             scene.tri_cu, scene.tri_cv, scene.tri_n, scene.tri_adotn,
                             scene.tri_valid, scene.tri_a, scene.tri_n0, scene.tri_n1,
                             scene.tri_n2, scene.tri_material), TRI_COLS))
    if materials:
        rows.append(material_rows(scene))
    return torch.cat([r.reshape(-1) for r in rows]).contiguous()


def material_rows(scene) -> torch.Tensor:
    """(n_mat, MAT_COLS) f32: color[3] roughness metallic emission[3]."""
    return torch.cat(
        [scene.mat_color, scene.mat_roughness[:, None], scene.mat_metallic[:, None],
         scene.mat_emission], dim=1,
    ).to(torch.float32).contiguous()


def winner_rows(scene) -> torch.Tensor:
    """(n_sph + n_pln + n_tri, WINNER_SLOTS) f32 union rows of every
    primitive (pallas_wavefront.winner_table): sphere pos[3] radius;
    plane normal[3]; triangle a[3] e0[3] e1[3] n0[3] n1[3] n2[3]; slot 18
    the material id as an exact small-int float."""

    def rows(parts, material):
        n = material.shape[0]
        body = torch.cat([p.reshape(n, -1).to(torch.float32) for p in parts], dim=1)
        out = torch.zeros((n, WINNER_SLOTS), dtype=torch.float32, device=material.device)
        out[:, : body.shape[1]] = body
        out[:, 18] = material.to(torch.float32)
        return out

    return torch.cat([
        rows((scene.sph_pos, scene.sph_radius), scene.sph_material),
        rows((scene.pln_normal,), scene.pln_material),
        rows((scene.tri_a, scene.tri_edge0, scene.tri_edge1, scene.tri_n0,
              scene.tri_n1, scene.tri_n2), scene.tri_material),
    ]).contiguous()


def _chunk_tables(a: dict, scene: DeviceScene) -> ChunkTables:
    n_sph, n_pln, n_tri = a["sph_radius"].shape[0], a["pln_valid"].shape[0], a["tri_valid"].shape[0]
    bounds = [chunk_bounds(a["tri_a"], a["tri_edge0"], a["tri_edge1"])] if n_tri else []
    windows = [tri_const_table(a)] if n_tri else []
    n_sph_chunks = 0
    if counts_chunk_spheres(n_sph, n_pln):
        n_sph_chunks = n_sph // TRI_CHUNK
        bounds.append(sphere_chunk_bounds(a["sph_pos"], a["sph_radius"]))
        windows.append(sphere_const_table(a))

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(np.concatenate(x))).to(scene.device)

    return ChunkTables(
        up([pair_nan_bounds(np.concatenate(bounds))]), up(windows), n_tri // TRI_CHUNK, n_sph_chunks,
        small=pack_rows(scene, spheres=not n_sph_chunks, triangles=False, materials=False),
        winner=winner_rows(scene), materials=material_rows(scene),
    )


def build_device_scene(
    scene: Scene, device=_device.DEFAULT, pad_to: int = 8
) -> DeviceScene:
    """Flatten + pad a host Scene into a DeviceScene on `device` (no BVH:
    the BVH route is not ported yet)."""
    device = _device.resolve(device)
    _device.warn_ignored_knobs()
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
    # the reference's default, so the fields match it lane for lane.
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


def device_scene_from_arrays(arrays: dict, device=_device.DEFAULT) -> DeviceScene:
    """Build a DeviceScene on `device` from a dict of numpy arrays keyed
    by field name (for example the fields of the JAX package's
    DeviceScene). Float fields become float32, material ids int32, valid
    masks bool. A scene within the unroll budget gets the TRACE kernel's
    table; one past it that the chunked route covers gets its chunk
    tables."""
    device = _device.resolve(device)
    host = {}
    for name in FIELDS:
        arr = np.asarray(arrays[name])
        if name.endswith("_valid"):
            arr = arr.astype(bool)
        elif name.endswith("_material"):
            arr = arr.astype(np.int32)
        else:
            arr = arr.astype(np.float32)
        host[name] = np.ascontiguousarray(arr)
    scene = DeviceScene(**{k: torch.from_numpy(v.copy()).to(device) for k, v in host.items()})
    scene.sweep_rows = tuple(
        int(np.flatnonzero(host[k])[-1]) + 1 if host[k].any() else 0
        for k in ("sph_valid", "pln_valid", "tri_valid")
    )
    n_sph, n_pln, n_tri = _counts(scene)
    if n_sph + n_pln + n_tri <= MAX_UNROLL_PRIMS:
        scene.trace_table = pack_rows(scene)
    elif counts_chunked_applicable(n_sph, n_pln, n_tri):
        scene.chunks = _chunk_tables(host, scene)
    return scene
