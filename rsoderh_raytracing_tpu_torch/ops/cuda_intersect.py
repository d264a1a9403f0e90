"""The sweep kernels' wrappers: CHUNKED_CLOSEST and CHUNKED_ANY (the
big-mesh route), CLOSEST, ANY and FUSED (scenes within the unroll budget).

Counterpart of rsoderh_raytracing_tpu/ops/pallas_intersect.py's entry
points (``chunked_closest_tiles``, ``chunked_any_tiles``,
``closest_sweep``, ``any_sweep``, ``fused_trace``). The wrappers take
flat (n,) tensors: ray components as 3-tuples and an int32 lane mask
(optional for CLOSEST and ANY). For CPU tensors they run the plain versions
(``intersect.chunked_closest_plain`` / ``chunked_any_plain`` /
``closest_record`` / ``any_sweep`` / ``trace_attrs``); for CUDA tensors
they launch the kernels in ``csrc/chunked.cu`` and ``csrc/sweep.cu`` or
raise. ``LAUNCHES`` counts the kernel launches of each wrapper.

The scene data are the DeviceScene's chunk tables (scene/device.py:
bounds, 20-float window rows, and the unrolled primitives, planes and
spheres unless they are chunked, packed like the TRACE kernel's table).
"""

from __future__ import annotations

import ctypes

import torch

from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.scene.device import CHUNKED, SMALL, route

# Kernel launches of each wrapper (CUDA tensors only).
LAUNCHES = {"chunked_closest": 0, "chunked_any": 0, "closest": 0, "any": 0, "fused": 0}


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


def chunked_closest_call(scene, ro, rd, live):
    """Closest hit of rays (ro, rd) over the whole scene for lanes with
    live != 0, over the unrolled primitives only for the others.
    Returns (t f32, type i32, index i32); type -1 is a miss."""
    if live.device.type == "cpu":
        return intersect.chunked_closest_plain(scene, ro, rd, live)
    if live.device.type != "cuda":
        raise ValueError(f"chunked_closest_call: unsupported device {live.device}")
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n, dev, ptrs, scene_args = _launch_args(scene, (*ro, *rd), live, "chunked_closest_call")
    t = torch.empty(n, device=dev, dtype=torch.float32)
    ptype = torch.empty(n, device=dev, dtype=torch.int32)
    pidx = torch.empty(n, device=dev, dtype=torch.int32)
    rc = _kernels.library().rt_chunked_closest_launch(
        ptrs, *scene_args, t.data_ptr(), ptype.data_ptr(), pidx.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cw._raise_on(rc, "CHUNKED_CLOSEST")
    LAUNCHES["chunked_closest"] += 1
    return t, ptype, pidx


def chunked_any_call(scene, p, d, mask):
    """Occlusion (i32 0/1) of rays from p along d by any primitive, the
    chunked ones only for lanes with mask != 0."""
    if mask.device.type == "cpu":
        return intersect.chunked_any_plain(scene, p, d, mask)
    if mask.device.type != "cuda":
        raise ValueError(f"chunked_any_call: unsupported device {mask.device}")
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n, dev, ptrs, scene_args = _launch_args(scene, (*p, *d), mask, "chunked_any_call")
    occ = torch.empty(n, device=dev, dtype=torch.int32)
    rc = _kernels.library().rt_chunked_any_launch(
        ptrs, *scene_args, occ.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
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


def _small_args(scene, rays, what):
    """Check the ray inputs of CLOSEST, ANY or FUSED; returns (lanes,
    device, the packed scene table's launch arguments)."""
    if route(scene) != SMALL:
        raise ValueError(f"{what}: the scene is past the unroll budget; it takes the chunked route")
    n = rays[0].shape[0]
    dev = rays[0].device
    for i, t in enumerate(rays):
        cw._check(f"{what} ray input {i}", t, n, torch.float32, dev)
    table = scene.trace_table
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
    """CLOSEST over a scene within the unroll budget: a dict by
    CLOSEST_OUT_NAMES of the closest hit of rays (ro, rd), its point,
    normal, material id and material values, for lanes with live != 0
    (every lane when live is None); a miss is (3e38, -1, 0) with the
    point, normal and material of intersect._hit_attributes. Every other
    lane holds the miss record with zero attributes
    (intersect.closest_record)."""
    rays = (*ro, *rd)
    if rays[0].device.type == "cpu":
        return intersect.closest_record(scene, ro, rd, live)
    if rays[0].device.type != "cuda":
        raise ValueError(f"closest_call: unsupported device {rays[0].device}")
    from rsoderh_raytracing_tpu_torch.ops import _kernels

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
    """ANY: (n,) bool, some primitive of a scene within the unroll
    budget is hit, for lanes with mask != 0 (every lane when mask is
    None); False on every other lane."""
    rays = (*ro, *rd)
    if rays[0].device.type == "cpu":
        occ = intersect.any_sweep(scene, *rays)
        return occ if mask is None else occ & (mask != 0)
    if rays[0].device.type != "cuda":
        raise ValueError(f"any_call: unsupported device {rays[0].device}")
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
    the NEE occlusion from the hit point along nee_dir, over a scene
    within the unroll budget. Returns a dict by FUSED_OUT_NAMES
    (intersect.trace_attrs's)."""
    rays = (*ro, *rd, *nee_dir)
    if rays[0].device.type == "cpu":
        return intersect.trace_attrs(scene, *rays)
    if rays[0].device.type != "cuda":
        raise ValueError(f"fused_call: unsupported device {rays[0].device}")
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
