"""The sweep kernels' wrappers: CHUNKED_CLOSEST and CHUNKED_ANY (the
big-mesh route), CLOSEST, ANY and FUSED (the small route, over a packed
table of any size: staged in a block's shared memory up to
SWEEP_MAX_SHARED, read from global memory past it), and the BVH route's
walks, BVH_CLOSEST and BVH_ANY.

Counterpart of rsoderh_raytracing_tpu/ops/pallas_intersect.py's entry
points (``chunked_closest_tiles``, ``chunked_any_tiles``,
``closest_sweep``, ``any_sweep``, ``fused_trace``). The wrappers take
flat (n,) tensors: ray components as 3-tuples and an int32 lane mask
(optional for CLOSEST and ANY). For CPU tensors they run the plain
versions (``intersect.chunked_closest_plain`` / ``chunked_any_plain`` /
``closest_record`` / ``any_sweep`` / ``trace_attrs``); for CUDA tensors
they launch the kernels in ``csrc/chunked.cu``, ``csrc/sweep.cu`` and
``csrc/bvh.cu`` or raise (also under RT_DISABLE_PALLAS=1:
``_device.use_plain``). ``LAUNCHES`` counts the kernel launches of each
wrapper. The BVH wrappers' plain versions are ``bvh.closest_plain`` and
``bvh.any_plain`` (ops/bvh.py), and their tables the scene's DeviceBVH.
Under RT_DEBUG_NANS=1 every wrapper checks its float outputs, whichever
ran (``_device.check_nans``).

The scene data are the DeviceScene's chunk tables (scene/device.py:
bounds, 20-float window rows, and the unrolled primitives, planes and
spheres unless they are chunked, packed like the TRACE kernel's table).
"""

from __future__ import annotations

import ctypes

import torch

from rsoderh_raytracing_tpu_torch import _device
from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.scene.device import BVH, CHUNKED, route

# Kernel launches of each wrapper (CUDA tensors only).
LAUNCHES = {"chunked_closest": 0, "chunked_any": 0, "closest": 0, "any": 0, "fused": 0,
            "bvh_closest": 0, "bvh_any": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch_args(scene, rays, mask, what):
    """Checked pointers and scene arguments common to both launchers."""
    if route(scene) != CHUNKED:
        raise ValueError(f"{what}: the scene does not take the chunked route")
    n = mask.shape[0]
    dev = mask.device
    for i, t in enumerate(rays):
        cw._check(f"{what} ray input {i}", t, n, torch.float32, dev)
    cw._check(f"{what} lane mask", mask, n, torch.int32, dev)
    ch = scene.chunks
    n_sph = 0 if ch.n_sph_chunks else scene.sph_radius.shape[0]
    scene_args = (
        ch.small.data_ptr(), ch.small.numel(), n_sph, scene.pln_valid.shape[0],
        ch.bounds.data_ptr(), ch.windows.data_ptr(), ch.n_tri_chunks, ch.count,
    )
    return n, dev, cw._ptrs((*rays, mask)), scene_args


def chunked_shared_bytes(scene) -> int:
    """Dynamic shared memory a block of the chunked kernels asks for on
    this scene, bytes (builds the kernels)."""
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    ch = scene.chunks
    return _kernels.library().rt_chunked_shared_bytes(ch.small.numel(), ch.count)


def chunked_batch() -> int:
    """Chunks a batch of the chunked kernels' walk, the `batch` that
    intersect.chunked_*_model takes to count what they sweep (builds the
    kernels)."""
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    return _kernels.library().rt_chunked_batch()


def chunked_closest_call(scene, ro, rd, live, union_batches=0):
    """Closest hit of rays (ro, rd) over the whole scene for lanes with
    live != 0, over the unrolled primitives only for the others.
    Returns (t f32, type i32, index i32); type -1 is a miss.
    union_batches > 0 caps the batches whose union boxes a block of the
    kernel holds at once (0: as many as its shared memory holds), which
    changes no output: a check drives the kernel's restaging with it."""
    if _device.use_plain(live, "chunked_closest_call"):
        out = intersect.chunked_closest_plain(scene, ro, rd, live)
    else:
        out = _chunked_closest_launch(scene, ro, rd, live, union_batches)
    return _device.check_nans("CHUNKED_CLOSEST", out, ("t", "type", "index"))


def _chunked_closest_launch(scene, ro, rd, live, union_batches):
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n, dev, ptrs, scene_args = _launch_args(scene, (*ro, *rd), live, "chunked_closest_call")
    t = torch.empty(n, device=dev, dtype=torch.float32)
    ptype = torch.empty(n, device=dev, dtype=torch.int32)
    pidx = torch.empty(n, device=dev, dtype=torch.int32)
    rc = _kernels.library().rt_chunked_closest_launch(
        ptrs, *scene_args, t.data_ptr(), ptype.data_ptr(), pidx.data_ptr(), n, union_batches,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cw._raise_on(rc, "CHUNKED_CLOSEST")
    LAUNCHES["chunked_closest"] += 1
    return t, ptype, pidx


def chunked_any_call(scene, p, d, mask, union_batches=0):
    """Occlusion (i32 0/1) of rays from p along d by any primitive, the
    chunked ones only for lanes with mask != 0; union_batches as for
    chunked_closest_call."""
    if _device.use_plain(mask, "chunked_any_call"):
        return intersect.chunked_any_plain(scene, p, d, mask)
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n, dev, ptrs, scene_args = _launch_args(scene, (*p, *d), mask, "chunked_any_call")
    occ = torch.empty(n, device=dev, dtype=torch.int32)
    rc = _kernels.library().rt_chunked_any_launch(
        ptrs, *scene_args, occ.data_ptr(), n, union_batches,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cw._raise_on(rc, "CHUNKED_ANY")
    LAUNCHES["chunked_any"] += 1
    return occ


# FUSED's outputs in launch order (pallas_intersect._fused_kernel); hit
# and occ are int32 in the kernel and bool for the callers.
FUSED_OUT_NAMES = (
    "did_hit", "px", "py", "pz", "nx", "ny", "nz", "cr", "cg", "cb",
    "rough", "metal", "er", "eg", "eb", "occ",
)


def sweep_max_table_bytes() -> int:
    """The dynamic shared memory that each of CLOSEST, ANY and FUSED can
    ask for on this card (its opt-in limit less the kernel's static shared
    memory; TRACE has none), from the kernels' library (builds the
    kernels): what SWEEP_MAX_SHARED mirrors."""
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    return _kernels.library().rt_sweep_max_table_bytes()


def _small_args(scene, rays, what):
    """Check the ray inputs of CLOSEST, ANY or FUSED; returns (lanes,
    device, the packed scene table's launch arguments)."""
    table = cw.check_table(scene, what)
    n = rays[0].shape[0]
    dev = rays[0].device
    for i, t in enumerate(rays):
        cw._check(f"{what} ray input {i}", t, n, torch.float32, dev)
    if table.device != dev:
        raise ValueError(f"{what}: rays on {dev}, scene on {table.device}")
    scene_args = (
        table.data_ptr(), table.numel(), n, scene.sph_radius.shape[0],
        scene.pln_valid.shape[0], scene.tri_valid.shape[0],
    )
    return n, dev, scene_args


# CLOSEST's outputs in launch order: the winner, the hit record of
# intersect._hit_attributes and the 8 material values of material_values.
CLOSEST_OUT_NAMES = (
    "t", "type", "index", "px", "py", "pz", "nx", "ny", "nz", "material_id",
    "cr", "cg", "cb", "rough", "metal", "er", "eg", "eb",
)
CLOSEST_INT_NAMES = frozenset({"type", "index", "material_id"})


def _lane_mask(mask, n, dev, what):
    """The launch pointer of an optional int32 lane mask (0: every lane)."""
    if mask is None:
        return 0
    cw._check(f"{what} lane mask", mask, n, torch.int32, dev)
    return mask.data_ptr()


def closest_call(scene, ro, rd, live=None):
    """CLOSEST over a SMALL scene's packed table: a dict by
    CLOSEST_OUT_NAMES of the closest hit of rays (ro, rd), its point,
    normal, material id and material values, for lanes with live != 0
    (every lane when live is None); a miss is (3e38, -1, 0) with the
    point, normal and material of intersect._hit_attributes. Every other
    lane holds the miss record with zero attributes
    (intersect.closest_record)."""
    if _device.use_plain(ro[0], "closest_call"):
        out = intersect.closest_record(scene, ro, rd, live)
    else:
        out = _closest_launch(scene, ro, rd, live)
    return _device.check_nans("CLOSEST", out)


def _closest_launch(scene, ro, rd, live):
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    rays = (*ro, *rd)
    n, dev, scene_args = _small_args(scene, rays, "closest_call")
    mask = _lane_mask(live, n, dev, "closest_call")
    outs = {
        k: torch.empty(n, device=dev, dtype=torch.int32 if k in CLOSEST_INT_NAMES else torch.float32)
        for k in CLOSEST_OUT_NAMES
    }
    ptrs = [t.data_ptr() for t in rays] + [mask] + [outs[k].data_ptr() for k in CLOSEST_OUT_NAMES]
    rc = _kernels.library().rt_closest_launch(
        (ctypes.c_void_p * len(ptrs))(*ptrs), *scene_args, scene.mat_roughness.shape[0],
        *scene.sweep_rows, torch.cuda.current_stream(dev).cuda_stream,
    )
    cw._raise_on(rc, "CLOSEST")
    LAUNCHES["closest"] += 1
    return outs


def any_call(scene, ro, rd, mask=None):
    """ANY: (n,) bool, some primitive of a SMALL scene is hit, for lanes
    with mask != 0 (every lane when mask is None); False on every other
    lane."""
    rays = (*ro, *rd)
    if _device.use_plain(rays[0], "any_call"):
        occ = intersect.any_sweep(scene, *rays)
        return occ if mask is None else occ & (mask != 0)
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n, dev, scene_args = _small_args(scene, rays, "any_call")
    mask_ptr = _lane_mask(mask, n, dev, "any_call")
    hit = torch.empty(n, device=dev, dtype=torch.int32)
    ptrs = [t.data_ptr() for t in rays] + [mask_ptr, hit.data_ptr()]
    rc = _kernels.library().rt_any_launch(
        (ctypes.c_void_p * len(ptrs))(*ptrs), *scene_args, *scene.sweep_rows,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cw._raise_on(rc, "ANY")
    LAUNCHES["any"] += 1
    return hit != 0


def fused_call(scene, ro, rd, nee_dir):
    """FUSED: closest hit, hit point, winner normal, material values and
    the NEE occlusion from the hit point along nee_dir, over a SMALL
    scene's packed table. Returns a dict by FUSED_OUT_NAMES
    (intersect.trace_attrs's)."""
    rays = (*ro, *rd, *nee_dir)
    if _device.use_plain(rays[0], "fused_call"):
        out = intersect.trace_attrs(scene, *rays)
    else:
        out = _fused_launch(scene, rays)
    return _device.check_nans("FUSED", out)


def _fused_launch(scene, rays):
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n, dev, scene_args = _small_args(scene, rays, "fused_call")
    outs = {
        k: torch.empty(n, device=dev, dtype=torch.int32 if k in ("did_hit", "occ") else torch.float32)
        for k in FUSED_OUT_NAMES
    }
    rc = _kernels.library().rt_fused_launch(
        cw._ptrs(rays + tuple(outs[k] for k in FUSED_OUT_NAMES)), *scene_args,
        scene.mat_roughness.shape[0], torch.cuda.current_stream(dev).cuda_stream,
    )
    cw._raise_on(rc, "FUSED")
    LAUNCHES["fused"] += 1
    outs["did_hit"] = outs["did_hit"] != 0
    outs["occ"] = outs["occ"] != 0
    return outs


def _bvh_depth(scene, what):
    if route(scene) != BVH:
        raise ValueError(f"{what}: the scene carries no BVH")
    if scene.bvh.depth > bvh_ops.MAX_DEPTH:
        raise ValueError(f"{what}: the BVH is {scene.bvh.depth} deep, the walks' stack holds "
                         f"{bvh_ops.MAX_DEPTH} entries")


def _bvh_args(scene, rays, mask, what):
    """Check the inputs of BVH_CLOSEST or BVH_ANY; returns (lanes, device,
    the tree's launch arguments, the counters of the walk's lanes and of the
    fallback pass's tiles: two int32 of scratch, which must outlive the
    launch call)."""
    n = mask.shape[0]
    dev = mask.device
    for i, t in enumerate(rays):
        cw._check(f"{what} ray input {i}", t, n, torch.float32, dev)
    cw._check(f"{what} lane mask", mask, n, torch.int32, dev)
    b = scene.bvh
    if b.nodes.device != dev:
        raise ValueError(f"{what}: rays on {dev}, BVH on {b.nodes.device}")
    tree = (b.nodes.data_ptr(), b.pairs.data_ptr(), b.prims.data_ptr())
    return n, dev, tree, torch.empty(2, dtype=torch.int32, device=dev)


def bvh_closest_call(scene, ro, rd, live, *, fallback_lanes=None):
    """BVH_CLOSEST: the closest hit of rays (ro, rd) by the BVH walk, and
    on a BVH miss by the sphere and plane sweep, for lanes with live != 0;
    (3e38, -1, 0) on the others. Returns (t f32, type i32, index i32).
    fallback_lanes: an int64 scalar tensor on the lanes' device, which
    gets the number of lanes the sweep took added in place (None: not
    counted)."""
    _bvh_depth(scene, "bvh_closest_call")
    if _device.use_plain(live, "bvh_closest_call"):
        out = bvh_ops.closest_plain(scene, ro, rd, live, fallback_lanes=fallback_lanes)
    else:
        out = _bvh_closest_launch(scene, ro, rd, live, fallback_lanes)
    return _device.check_nans("BVH_CLOSEST", out, ("t", "type", "index"))


def _bvh_closest_launch(scene, ro, rd, live, fallback_lanes):
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n, dev, tree, fetch = _bvh_args(scene, (*ro, *rd), live, "bvh_closest_call")
    if fallback_lanes is not None and (fallback_lanes.device != dev or fallback_lanes.dtype != torch.int64
                                       or fallback_lanes.numel() != 1):
        raise ValueError(f"bvh_closest_call: fallback_lanes must be one int64 on {dev}, got "
                         f"{tuple(fallback_lanes.shape)} {fallback_lanes.dtype} on {fallback_lanes.device}")
    t = torch.empty(n, device=dev, dtype=torch.float32)
    ptype = torch.empty(n, device=dev, dtype=torch.int32)
    pidx = torch.empty(n, device=dev, dtype=torch.int32)
    b = scene.bvh
    rc = _kernels.library().rt_bvh_closest_launch(
        cw._ptrs((*ro, *rd, live, t, ptype, pidx)), *tree, b.prim_type.data_ptr(),
        b.prim_index.data_ptr(), b.small.data_ptr(), scene.sph_radius.shape[0],
        *scene.sweep_rows[:2], b.root, b.depth, fetch.data_ptr(),
        None if fallback_lanes is None else fallback_lanes.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cw._raise_on(rc, "BVH_CLOSEST")
    LAUNCHES["bvh_closest"] += 1
    return t, ptype, pidx


def bvh_any_call(scene, p, d, mask):
    """BVH_ANY: occlusion (i32 0/1) of rays from p along d by the BVH walk
    (no fallback), for lanes with mask != 0; 0 on the others."""
    _bvh_depth(scene, "bvh_any_call")
    if _device.use_plain(mask, "bvh_any_call"):
        return bvh_ops.any_plain(scene, p, d, mask)
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n, dev, tree, fetch = _bvh_args(scene, (*p, *d), mask, "bvh_any_call")
    occ = torch.empty(n, device=dev, dtype=torch.int32)
    b = scene.bvh
    rc = _kernels.library().rt_bvh_any_launch(
        cw._ptrs((*p, *d, mask, occ)), *tree, b.root, b.depth, fetch.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cw._raise_on(rc, "BVH_ANY")
    LAUNCHES["bvh_any"] += 1
    return occ


# The big-mesh routes' closest and occlusion wrappers, each with its plain
# version, by Wavefront.step keyword: what Wavefront.step launches on each
# route, and what profiling.capture_step wraps.
ROUTE_CALLS = {
    CHUNKED: {"closest": (chunked_closest_call, intersect.chunked_closest_plain),
              "occlusion": (chunked_any_call, intersect.chunked_any_plain)},
    BVH: {"closest": (bvh_closest_call, bvh_ops.closest_plain),
          "occlusion": (bvh_any_call, bvh_ops.any_plain)},
}
