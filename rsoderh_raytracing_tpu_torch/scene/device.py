"""DeviceScene: the scene as padded structure-of-arrays tensors.

Port of rsoderh_raytracing_tpu/scene/device.py. The numpy body, the
padding rules and the precomputed intersection constants are the same,
so every field equals the reference's lane for lane; only the final
upload differs (torch tensors on the card unless another device is
asked for).

A scene built without a BVH takes one of two routes (``route``):

- CHUNKED, the big-mesh kernels, past the reference's unroll budget of
  192 padded lanes where the chunk predicates and ceilings of
  rsoderh_raytracing_tpu/ops/pallas_intersect.py (which imports jax)
  cover the scene, whatever its chunk count (csrc/chunked.cu keeps the
  union boxes of as many batches as a block's shared memory holds at a
  time: chunked_shared_bytes mirrors its layout);
- SMALL, the sweep kernels over the packed table (TRACE, FUSED, CLOSEST,
  ANY), for every other scene: within the budget, and past it where the
  chunked route does not take the scene (planes never chunk). The budget
  is Mosaic's unroll limit; the H100's sweep kernels stage the table in
  a block's shared memory where it fits (sweep_shared_bytes, the mirror
  of the kernels' SWEEP_MAX_TABLE_BYTES) and read a larger one from
  global memory, where the reference sweeps densely in XLA
  (_sweep_xla). So no scene is refused.

A scene past the unroll budget stores its triangles in the order
RT_CHUNK_CLUSTER picks (morton, the default, or bvh or treelet:
scene/cluster.py), or in the host's order under RT_DISABLE_MORTON=1, as
the reference does, whatever route it takes.
A scene built with a BVH (``with_bvh``) takes the BVH route whatever its
size; such a scene keeps the host's triangle order (no reorder),
because the BVH's leaf slots name host triangles.
``device_scene_from_arrays`` also packs, once per scene, the flat tables
the CUDA kernels read (row layouts in csrc/wavefront_common.cuh): the
small route's ``trace_table``, the chunked route's ``chunks``, the BVH
route's ``bvh`` (ops/bvh.py), and for both of the last two the union rows
and material rows that BIG_SHADE reads (``winner``, ``materials``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device, tracing
from rsoderh_raytracing_tpu_torch.accel.bvh import build_bvh
from rsoderh_raytracing_tpu_torch.ops.bvh import device_bvh
from rsoderh_raytracing_tpu_torch.scene.types import Scene

# From rsoderh_raytracing_tpu/ops/pallas_intersect.py: the unrolled-sweep
# budget, the chunk height that decides the triangle padding, and the
# chunked route's ceilings in padded lanes (the reference's defaults;
# RT_MAX_CHUNKED_TRIS and RT_MAX_CHUNKED_SPHERES override them, read each
# time a route is decided: max_chunked).
MAX_UNROLL_PRIMS = 192
TRI_CHUNK = 64
MAX_CHUNKED_TRIS = 262144
MAX_CHUNKED_SPHERES = 262144

# RT_CHUNK_CLUSTER's orders of a chunked scene's triangles (scene/cluster.py).
CLUSTER_ORDERS = ("morton", "bvh", "treelet")

# A block's dynamic shared memory in the chunked kernels (csrc/chunked.cu:
# shared_bytes, union_batches, OFF_SMALL, MAX_SHARED): the fixed tables,
# then the unrolled primitive rows rounded up to a quad of floats, then a
# union box of CHUNKED_BOUND_COLS floats for every batch of CHUNKED_BATCH
# chunks, or for as many batches as fit CHUNKED_MAX_SHARED, the most a
# block may ask for (the kernels then stage the boxes a group at a time).
CHUNKED_OFF_SMALL = 191136
CHUNKED_MAX_SHARED = 232448
CHUNKED_BATCH = 16
CHUNKED_BOUND_COLS = 8
# The consecutive lanes a block of the chunked kernels owns (kTile).
CHUNKED_TILE = 1024

# The dynamic shared memory that each of TRACE, FUSED, CLOSEST and ANY may
# ask for to stage the packed table (csrc/wavefront_common.cuh:
# SWEEP_MAX_TABLE_BYTES; csrc/sweep.cu: rt_sweep_max_table_bytes asks the
# card): an H100 block's 232,448 bytes less the 1,056 bytes of CLOSEST's
# and ANY's lane lists. A table of pack_rows up to this is staged; the
# kernels read a larger one from global memory.
SWEEP_MAX_SHARED = 231392

# Window rows of the chunked kernels (pallas_intersect.tri_const_table /
# sphere_const_table): one 20-float row a primitive.
WIN_COLS = 20
# Row widths of the packed scene table and of the big-mesh union rows
# (csrc/wavefront_common.cuh).
SPH_COLS, PLN_COLS, TRI_COLS, MAT_COLS = 8, 16, 36, 8
WINNER_SLOTS = 20

SMALL, CHUNKED, BVH = "small", "chunked", "bvh"

# with_bvh="auto" on the CPU: the reference's crossover, past which its
# CPU renders through the BVH walk (rsoderh_raytracing_tpu/scene/
# device.py: CPU_BVH_ABOVE_LANES, padded triangle lanes).
CPU_BVH_ABOVE_LANES = 262144
# with_bvh="auto" on the card: the BVH past this many padded sphere and
# triangle lanes. The crossover measured on an NVIDIA H100 80GB HBM3,
# 700.00 W (chip_smoke.py phase 12: 2048^2, 8 bounces, free-run calls of
# 32 iterations, median Mrays/s of three calls, spread in brackets, sweep
# route against BVH): house (8 + 56 lanes, the small route) 2,743.19
# (14.04) against 627.73 (0.91); from suzanne (8 + 1,024, the chunked
# route) up the BVH wins by far more than the spreads: 457.05 (1.03)
# against 547.98 (0.38), level 1 (3,904) 428.90 against 537.20,
# suzanne_hi (15,488) 378.82 against 523.81, level 3 (61,952) 286.98
# against 508.76, suzanne_xhi (247,808) 154.82 against 490.83; spheres
# (1,024 + 64) 381.30 (1.06) against 389.02 (2.72). So the constant lies
# between 64 and 1,032 lanes: the unroll budget, which every scene of the
# small route within it stays under, and which the chunked route's
# scenes pass.
CUDA_BVH_ABOVE_LANES = 192

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
    # The BVH route's tables (ops/bvh.DeviceBVH): present when the scene
    # was built with a BVH, and then its route is BVH.
    bvh: Optional[object] = dataclasses.field(default=None, repr=False)
    # BIG_SHADE's tables on the chunked and BVH routes: the union row of
    # every primitive (winner_rows) and the material rows (material_rows).
    winner: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    materials: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

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

    def to(self, device) -> "DeviceScene":
        """A replica on `device`: every table copied, the kernels' tables
        (trace_table, chunks, bvh, winner, materials) included, so a
        device holds the scene without building it again."""
        return _device.copy_to(self, device)


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

    @property
    def count(self) -> int:
        return self.n_tri_chunks + self.n_sph_chunks


def max_chunked(kind: str) -> int:
    """The chunked route's ceiling in padded lanes of `kind` ("TRIS" or
    "SPHERES"): its knob where it is set, else the default."""
    knob, default = {"TRIS": ("RT_MAX_CHUNKED_TRIS", MAX_CHUNKED_TRIS),
                     "SPHERES": ("RT_MAX_CHUNKED_SPHERES", MAX_CHUNKED_SPHERES)}[kind]
    return int(os.environ.get(knob, default))


def counts_chunk_spheres(n_sph: int, n_pln: int) -> bool:
    """Sphere lanes stream as chunk windows when the sphere+plane unroll
    no longer fits the per-step budget (pallas_intersect._counts_chunk_spheres)."""
    return (
        n_sph + n_pln + TRI_CHUNK > MAX_UNROLL_PRIMS
        and n_sph > 0
        and n_sph % TRI_CHUNK == 0
        and n_sph <= max_chunked("SPHERES")
        and n_pln + TRI_CHUNK <= MAX_UNROLL_PRIMS
    )


def counts_chunked_applicable(n_sph: int, n_pln: int, n_tri: int) -> bool:
    """Whether the chunked route covers padded lane counts
    (pallas_intersect._counts_chunked_applicable)."""
    if n_tri % TRI_CHUNK != 0 or n_tri > max_chunked("TRIS"):
        return False
    if n_sph + n_pln + TRI_CHUNK <= MAX_UNROLL_PRIMS:
        return n_tri > 0
    return counts_chunk_spheres(n_sph, n_pln)


def chunked_union_batches(small_len: int, n_chunks: int) -> int:
    """Batches whose union boxes a block of the chunked kernels holds at
    once (csrc/chunked.cu: union_batches): every batch where they fit
    CHUNKED_MAX_SHARED, else as many as fit; small_len is the unrolled
    rows' floats."""
    quads = -(-small_len // 4) * 4
    room = (CHUNKED_MAX_SHARED - CHUNKED_OFF_SMALL) // 4 - quads
    return min(-(-n_chunks // CHUNKED_BATCH), room // CHUNKED_BOUND_COLS)


def chunked_shared_bytes(small_len: int, n_chunks: int) -> int:
    """Dynamic shared memory a block of the chunked kernels asks for, bytes
    (csrc/chunked.cu: shared_bytes), at most CHUNKED_MAX_SHARED."""
    quads = -(-small_len // 4) * 4
    return CHUNKED_OFF_SMALL + 4 * (quads + chunked_union_batches(small_len, n_chunks)
                                    * CHUNKED_BOUND_COLS)


def counts_shared_bytes(n_sph: int, n_pln: int, n_tri: int) -> int:
    """chunked_shared_bytes of a chunked scene of these padded lane
    counts: its unrolled rows (spheres unless they are chunked, then
    planes) and its chunks."""
    sph_chunked = counts_chunk_spheres(n_sph, n_pln)
    small_len = (0 if sph_chunked else n_sph * SPH_COLS) + n_pln * PLN_COLS
    n_chunks = -(-n_tri // TRI_CHUNK) + (-(-n_sph // TRI_CHUNK) if sph_chunked else 0)
    return chunked_shared_bytes(small_len, n_chunks)


def _counts(scene):
    return scene.sph_radius.shape[0], scene.pln_valid.shape[0], scene.tri_valid.shape[0]


def chunk_spheres(scene) -> bool:
    """Whether the scene's spheres stream as chunk windows: its chunk
    tables say so where it has them."""
    if scene.chunks is not None:
        return scene.chunks.n_sph_chunks > 0
    return counts_chunk_spheres(*_counts(scene)[:2])


def scene_chunk_count(scene) -> int:
    """Triangle windows plus (when chunk_spheres) sphere windows
    (pallas_intersect.scene_chunk_count)."""
    n_sph, _, n_tri = _counts(scene)
    c = -(-n_tri // TRI_CHUNK) if n_tri else 0
    if chunk_spheres(scene):
        c += -(-n_sph // TRI_CHUNK)
    return c


def sweep_shared_bytes(n_sph: int, n_pln: int, n_tri: int, n_mat: int) -> int:
    """Bytes of the packed table (pack_rows) for padded lane counts and
    materials: the sweep kernels stage it in a block's dynamic shared
    memory up to SWEEP_MAX_SHARED and read it from global memory past
    that."""
    return 4 * (n_sph * SPH_COLS + n_pln * PLN_COLS + n_tri * TRI_COLS + n_mat * MAT_COLS)


def counts_route(n_sph: int, n_pln: int, n_tri: int) -> str:
    """SMALL or CHUNKED for padded lane counts (under the ceilings as they
    are set now): CHUNKED past the unroll budget where the chunk
    predicates hold, SMALL otherwise."""
    if n_sph + n_pln + n_tri > MAX_UNROLL_PRIMS and counts_chunked_applicable(n_sph, n_pln, n_tri):
        return CHUNKED
    return SMALL


def route(scene) -> str:
    """The route the scene was built for, by the kernels' tables it holds
    (so a ceiling or a knob changed after the build does not move it):
    BVH for a scene that carries a BVH, CHUNKED for chunk tables, SMALL
    for the packed table."""
    if scene.bvh is not None:
        return BVH
    if scene.chunks is not None:
        return CHUNKED
    return SMALL


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
    )


def auto_bvh(n_sph: int, n_pln: int, n_tri: int, device: torch.device, n_mat: int = 1) -> bool:
    """with_bvh="auto" for padded lane counts (and materials): the route
    this backend measures as fastest, as the reference picks it. On the
    CPU exactly the reference's rule, more than CPU_BVH_ABOVE_LANES
    triangle lanes: a scene past the unroll budget that does not chunk
    then sweeps every row, as the reference's CPU does. On the card more
    than CUDA_BVH_ABOVE_LANES sphere and triangle lanes, where the walks
    run ahead of the chunked kernels (planes stay with the sweep), or a
    scene whose small route would read a packed table past a block's
    shared memory (SWEEP_MAX_SHARED) from global memory.
    RT_BVH_ABOVE_TRIS=N moves the crossover down to N triangle lanes on
    both."""
    if device.type == "cpu":
        with_bvh = n_tri > CPU_BVH_ABOVE_LANES
    else:
        with_bvh = (n_sph + n_tri > CUDA_BVH_ABOVE_LANES
                    or (counts_route(n_sph, n_pln, n_tri) == SMALL
                        and sweep_shared_bytes(n_sph, n_pln, n_tri, n_mat) > SWEEP_MAX_SHARED))
    thresh = os.environ.get("RT_BVH_ABOVE_TRIS")
    if not with_bvh and thresh and n_tri > int(thresh):
        with_bvh = True
    return with_bvh


def chunk_cluster() -> str:
    """RT_CHUNK_CLUSTER (default morton), checked: ValueError for a value
    that is not one of CLUSTER_ORDERS."""
    cluster = os.environ.get("RT_CHUNK_CLUSTER", "morton")
    if cluster not in CLUSTER_ORDERS:
        raise ValueError(f"RT_CHUNK_CLUSTER={cluster!r}: expected morton|bvh|treelet")
    return cluster


def cluster_triangles(vertices, tris, cluster):
    """(triangles in the order `cluster` names, their valid mask or None):
    Morton or the BVH's depth-first order permute them; treelet also
    pads each chunk and returns its mask (scene/cluster.py)."""
    if cluster == "morton":
        return tris[_morton_order(vertices, tris)], None
    from rsoderh_raytracing_tpu_torch.scene import cluster as orders

    if cluster == "bvh":
        return tris[orders.bvh_dfs_order(vertices, tris)], None
    return orders.treelet_pack(vertices, tris, TRI_CHUNK)


@tracing.traced("scene.build")
def build_device_scene(
    scene: Scene, device=_device.DEFAULT, pad_to: int = 8, with_bvh: "bool | str" = False
) -> DeviceScene:
    """Flatten + pad a host Scene into a DeviceScene on `device`.

    with_bvh=True also builds the SAH BVH (accel/bvh.py, its native
    builder where g++ is available) and attaches it, so the scene takes
    the BVH route; "auto" attaches it by auto_bvh. A scene with a BVH
    keeps the host's triangle order (leaf slots name host triangles), as
    the reference's does; every field still equals the reference's lane
    for lane. Without a BVH the scene takes the route of
    device_scene_from_arrays, CHUNKED or SMALL; nothing raises for a
    scene's size."""
    device = _device.resolve(device)
    cluster = chunk_cluster()
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
    # exceeds the unroll budget; such scenes are stored in the order
    # RT_CHUNK_CLUSTER picks (Morton by default), unless a BVH is attached
    # (its leaf slots name host triangles, as the reference keeps them) or
    # RT_DISABLE_MORTON=1 keeps the host's order, so the fields match the
    # reference's lane for lane.
    tris = scene.meshes.triangles
    total_small = s_n + p_n + _round_up(len(tris), pad_to)
    tri_pad = pad_to if total_small <= MAX_UNROLL_PRIMS else TRI_CHUNK
    if with_bvh == "auto":
        with_bvh = auto_bvh(s_n, p_n, _round_up(len(tris), tri_pad), device, m)
    explicit_valid = None
    if (total_small > MAX_UNROLL_PRIMS and len(tris) > 0 and not with_bvh
            and os.environ.get("RT_DISABLE_MORTON") != "1"):
        tris, explicit_valid = cluster_triangles(scene.meshes.vertices, tris, cluster)
    elif cluster != "morton":
        _device.warn_once(
            "RT_CHUNK_CLUSTER",
            f"RT_CHUNK_CLUSTER={cluster!r} orders the triangles of a chunked scene only; this "
            "scene keeps its order (it has no triangles, is within the unroll budget, has a "
            "BVH, or RT_DISABLE_MORTON=1 is set)",
        )

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
        # treelet_pack's pad rows lie between real triangles: its mask
        # replaces the fill that marks only the tail
        tri_valid[: len(tris)] = True if explicit_valid is None else explicit_valid

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
    if not with_bvh:
        return device_scene_from_arrays(arrays, device)
    start = time.perf_counter()
    flat = build_bvh(scene)
    seconds = time.perf_counter() - start
    out = device_scene_from_arrays(arrays, device, flat)
    out.bvh.build_seconds = seconds
    return out


def device_scene_from_arrays(arrays: dict, device=_device.DEFAULT, bvh=None) -> DeviceScene:
    """Build a DeviceScene on `device` from a dict of numpy arrays keyed
    by field name (for example the fields of the JAX package's
    DeviceScene). Float fields become float32, material ids int32, valid
    masks bool. With `bvh`, a FlatBVH over the arrays' primitive order,
    the scene takes the BVH route and gets its tables (ops/bvh.py).
    Otherwise the scene gets the tables of its route (counts_route): the
    chunk tables (CHUNKED) or the packed table of the sweep kernels
    (SMALL)."""
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
    if bvh is not None:
        scene.bvh = device_bvh(bvh, scene)
    picked = BVH if bvh is not None else counts_route(*_counts(scene))
    if picked == SMALL:
        scene.trace_table = pack_rows(scene)
    elif picked == CHUNKED:
        scene.chunks = _chunk_tables(host, scene)
    if picked in (CHUNKED, BVH):
        scene.winner, scene.materials = winner_rows(scene), material_rows(scene)
    return scene
