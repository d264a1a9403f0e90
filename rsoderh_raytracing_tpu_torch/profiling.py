"""Where the main path's device time goes, on a GPU: the per-kernel tool
beside the benchmark (portbench, which measures end to end).

    python -m rsoderh_raytracing_tpu_torch.profiling [--path loop|split|spans]
                                                    [--scene NAME] [--intersector auto|sweep|bvh]
                                                    [--out DIR]

Runs assets/scenes/NAME.toml (default house; or a generated scene of
TILED_SCENES) at 2048x2048, 8 bounces, procedural_sky(2048, 1024), and
prints one line per measurement, each with the card's name and power
limit. With ``--path loop`` (the default), the free-run kernel loop on
the route ``--intersector`` picks (as the CLI's; 'sweep' keeps a mesh
past the card's crossover, such as suzanne_hi, on the chunked route):

- ``kernel``: one free-run call of budget 16 under torch.profiler; device
  ms per iteration for each kernel name (the 12 largest), then a
  ``group`` line for the kernels (TRACE and SHADE, or ENV_DRAW, the
  closest and occlusion pair and BIG_SHADE on the big-mesh routes), the
  row gathers (index_select) and the other glue, kernel launches per
  iteration, and the device busy share: the union of device intervals
  over the window from the first one's start to the last one's end (the
  window holds the call's set-up and its final host check too);
- ``sweep`` (small route): on the loop state of the third iteration,
  TRACE, CLOSEST, ANY and FUSED ms at 2048^2 lanes (CUDA events), the
  sweeps on TRACE's rays as ``sweep_calls`` builds them;
- ``cull`` (chunked route): on the same state, the slab tests and the
  (lane, chunk) pairs that pass the cull of each chunked kernel, from a
  plain pass (``cull_counts``), and the bound they give;
- ``walk`` (BVH route: a mesh past the card's crossover under 'auto'):
  on the same state, BVH_CLOSEST and BVH_ANY ms, the node visits, box
  tests and leaf tests of the plain walk, and the bound they give
  (``bvh_bound``); then ``fallback``: BVH_CLOSEST's walk and fallback
  pass apart (device ms a call under torch.profiler), the lanes the walk
  leaves pending, their warp fill in lane order and the pass's bound
  (``fallback_report``; ``--scene rtiow_final`` for the sphere scene
  whose pass it is).

With ``--path split``, the multi-device split (parallel/sharding.py)
over every card of the machine, house:

- ``split_cards``: the cards as nvidia-smi reports them;
- ``split`` (two cards or more) at 256x256: the tile-only mesh over every
  card bitwise the unsharded render_freerun on card 0 (image and
  counts); dp:N and, for an even N >= 4, tile:2,dp:N/2 with
  max_bounces=1 (counts exact, the image allclose(2e-5) to the unsharded
  render of the same samples); render_spp_sharded on dp:N allclose(1e-4)
  to the sum of render_sample over samples 0..N-1; the memory each card
  holds after them (the scene's replica);
- ``split_scale``: Mrays/s of ShardedRenderer dp:k step_freerun(512) at
  2048x2048, 8 bounces, for k = 1, 2, 4, ... up to N and back down (one
  call each way), and each k's speed-up over dp:1.

With ``--path spans``, the port's spans and counters (tracing.py) over
NAME at 2048x2048: ``tracing_cost``, the median host ms of a
step_freerun(64) call with tracing off and on (six calls each, by turns);
``spans``, one call profiled with the card's activity alone and tracing
on, through ``span_report``: host enqueue ms and launches an iteration,
the device-idle ms a call put down to the innermost span open at each
gap's start, syncs a call, and the share of the step kernels' launches
that lie inside their ``wavefront.step`` span on the profiler's clock.

The Chrome traces are written under DIR (default ``build/profile``).
Needs one CUDA device; imports nothing of jax. The helpers that capture
a loop state or a scan state, build the sweeps' calls, count a cull and
give a kernel's bound serve chip_smoke.py and the tests as well.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import os
import subprocess
import time
import tomllib
from unittest import mock

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.env.environment import (
    Environment, EnvironmentMaps, device_environment,
)
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import envmap, intersect, rng
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree, render_sample
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import NO_LIMIT, Wavefront, render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import (
    BVH, CHUNKED, TRI_CHUNK, build_device_scene, fallback_shared_bytes, route,
)
from rsoderh_raytracing_tpu_torch.scene.toml_loader import build_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 2048
BOUNCES = 8

# Published H100 SXM peaks (NVIDIA's data sheet, at the full 700 W): HBM3
# bandwidth and f32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Operations of one test, counted by hand from csrc/wavefront_common.cuh
# and csrc/chunked.cu: every add, multiply, divide, square root, compare,
# min/max and select is one (a divide or square root costs the card
# more, so a bound built on these counts stays a lower bound).
OPS_SPHERE = 38
OPS_PLANE = 33
OPS_TRIANGLE = 47
OPS_TRI_OCCLUDED = 45
OPS_SLAB = 33
# The BVH walks' tests (csrc/bvh.cu), counted the same way: a child's box
# (slab_axis three times, the entry and exit reductions, the hit and
# best-t compares, the near/far selects) and each leaf test with its
# kind select and winner compare (sphere_t, plane_t, triangle_t).
OPS_BOX = 39
OPS_LEAF = {"spheres": 49, "planes": 48, "triangles": 61}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# The generated scenes (--scene): tiled_house(k) by name. house_tiled16
# (256 planes; 8 + 256 + 64 padded lanes, a packed table of 26,112 bytes)
# takes the small route past the unroll budget;
# house_tiled64 (4,096 planes; a table of 271,872 bytes, past a block's
# shared memory, so the sweep kernels read it from global memory) the small
# route under intersector='sweep', the BVH under 'auto' on the card.
TILED_SCENES = {"house_tiled16": 16, "house_tiled64": 64}
HOUSE_GROUND = 60.0  # house.toml's ground: the square [-30, 30]^2 at y = 0


def tiled_house(k):
    """house.toml with its two identical ground planes replaced by a k x k
    checkerboard of finite planes over the same 60 x 60 square, in the
    ground and red_plastic materials by turns (a host Scene)."""
    path = os.path.join(ROOT, "assets", "scenes", "house.toml")
    with open(path, "rb") as f:
        descriptor = tomllib.load(f)
    side = HOUSE_GROUND / k
    tiles = [{"Plane": {"material": "ground" if (i + j) % 2 == 0 else "red_plastic",
                        "pos": [-HOUSE_GROUND / 2 + i * side, 0.0, -HOUSE_GROUND / 2 + j * side],
                        "forward": [0.0, 0.0, side], "right": [side, 0.0, 0.0]}}
             for i in range(k) for j in range(k)]
    descriptor["object"] = [o for o in descriptor["object"] if "Plane" not in o] + tiles
    return build_scene(descriptor, path)


def named_scene(name):
    """The host Scene of assets/scenes/NAME.toml, or of a generated scene
    of TILED_SCENES."""
    if name in TILED_SCENES:
        return tiled_house(TILED_SCENES[name])
    return load_scene(os.path.join(ROOT, "assets", "scenes", f"{name}.toml"))


def scene_setup(name, device, env=None, with_bvh=False):
    """(device scene, environment, camera) of named_scene(NAME) under
    `env` (default procedural_sky(2048, 1024), the bench's sky), built
    with `with_bvh` (build_device_scene)."""
    scene = named_scene(name)
    if env is None:
        env = device_environment(Environment.from_texture("sky", procedural_sky(2048, 1024)), device)
    return (build_device_scene(scene, device, with_bvh=with_bvh), env,
            camera_pytree(scene.camera, device))


# The chunked route's kernels: Wavefront.step's keyword, the wrapper and
# its plain version (the closest and occlusion pair of each big-mesh route
# is ci.ROUTE_CALLS's).
KERNELS = {
    "trace": (cw.trace_call, cw.trace_plain),
    "shade": (cw.shade_call, cw.shade_plain),
    "env_draw": (cw.env_draw_call, cw.env_draw_plain),
    **ci.ROUTE_CALLS[CHUNKED],
    "big_shade": (cw.big_shade_call, cw.big_shade_plain),
}


def route_kernels(scene):
    """The kernels of the scene's route, as KERNELS: the closest and
    occlusion pair from ci.ROUTE_CALLS."""
    return {**KERNELS, **ci.ROUTE_CALLS.get(route(scene), {})}


def capture_step(wave, it, plain=False):
    """Run iteration `it` of `wave` through the wrappers (or, with
    `plain`, the plain versions); returns the arguments each kernel of
    the route was called with, by Wavefront.step keyword."""
    captured = {}

    def capture(key, fn):
        def wrapped(*args, **kwargs):
            captured[key] = args
            return fn(*args, **kwargs)
        return wrapped

    wave.step(it, **{k: capture(k, fns[1] if plain else fns[0])
                     for k, fns in route_kernels(wave.scene).items()})
    return captured


def _as_int(outputs):
    return {k: v.to(torch.int32) if v.dtype == torch.bool else v for k, v in outputs.items()}


def sweep_calls(trace_args):
    """(kernel call, plain call, integer outputs) of CLOSEST, ANY and
    FUSED on the rays of TRACE's arguments (scene, env, carry), with the
    NEE direction of the carry's alias draw (the plain glue); ANY's rays
    start at the hit points, as the integrators call it. Each call returns
    its outputs by name. Also returns ANY's rays."""
    scene, env, carry = trace_args
    ro = (carry["ro0"], carry["ro1"], carry["ro2"])
    rd = (carry["rd0"], carry["rd1"], carry["rd2"])
    nd = tuple(c.contiguous() for c in envmap.env_draw(rng.from_bits(carry["state"]), env)[4])
    hit = intersect.closest_sweep(scene, *ro, *rd)
    t_safe = torch.where(hit[1] >= 0, hit[0], 0.0)
    p = tuple((ro[k] + rd[k] * t_safe).contiguous() for k in range(3))
    return {
        "closest": (lambda: ci.closest_call(scene, ro, rd),
                    lambda: intersect.closest_record(scene, ro, rd), ci.CLOSEST_INT_NAMES),
        "any": (lambda: {"occ": ci.any_call(scene, p, nd).to(torch.int32)},
                lambda: {"occ": intersect.any_sweep(scene, *p, *nd).to(torch.int32)}, {"occ"}),
        "fused": (lambda: _as_int(ci.fused_call(scene, ro, rd, nd)),
                  lambda: _as_int(intersect.trace_attrs(scene, *ro, *rd, *nd)), {"did_hit", "occ"}),
    }, (*p, *nd)


def cull_counts(scene, ro, rd, mask, closest):
    """What a chunked kernel's cull lets through on these inputs, from a
    plain pass that repeats its per-lane loop: (slab tests, (lane, chunk)
    pairs that pass, of them on triangle chunks). CHUNKED_CLOSEST
    (`closest`) bounds each slab by the running best t of live lanes;
    CHUNKED_ANY skips lanes once occluded."""
    rays = (*ro, *rd)
    small = intersect._sweep(scene, rays, intersect._unrolled_kinds(scene))[0]
    lanes = torch.nonzero((mask != 0) if closest else (mask != 0) & ~(small < intersect.INF)).squeeze(1)
    sub = [c.index_select(0, lanes) for c in rays]
    best = small.index_select(0, lanes)
    ch = scene.chunks
    tests = pairs = tri_pairs = 0
    for c in range(ch.count):
        tests += lanes.shape[0]
        passing, t0 = (x[:, 0] for x in intersect.slab_entry(ch.bounds[c:c + 1], sub))
        if closest:
            passing &= t0 <= best * (1.0 + 1e-3) + 1e-4
        k = torch.nonzero(passing).squeeze(1)
        pairs += k.shape[0]
        is_tri = c < ch.n_tri_chunks
        tri_pairs += k.shape[0] if is_tri else 0
        if k.numel() == 0:
            continue
        kind = intersect.TRIANGLE if is_tri else intersect.SPHERE
        first = (c if is_tri else c - ch.n_tri_chunks) * TRI_CHUNK
        terms = intersect._ray_terms(*(x.index_select(0, k) for x in sub))
        t, hit = intersect._hits(scene, kind, first, first + TRI_CHUNK, terms)
        if closest:
            best[k] = torch.minimum(best[k], torch.where(hit, t, intersect.INF).min(dim=1).values)
        else:
            if is_tri:
                hit = intersect._tri_occluded(scene, first, first + TRI_CHUNK, terms)
            keep = torch.ones(lanes.shape[0], dtype=torch.bool, device=lanes.device)
            keep[k] = ~hit.any(dim=1)
            lanes, best = lanes[keep], best[keep]
            sub = [x[keep] for x in sub]
    return tests, pairs, tri_pairs


def bound_ms(n_bytes, n_ops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the card's memory rate and the operations over its f32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_ops(scene):
    """Operations of one closest sweep of a lane over every row of a small
    scene's packed table (house_tiled16's 328 as house's 72)."""
    return (scene.sph_radius.shape[0] * OPS_SPHERE + scene.pln_valid.shape[0] * OPS_PLANE
            + scene.tri_valid.shape[0] * OPS_TRIANGLE)


def first_hit_ops(scene, rays, extents=None):
    """Operations an occlusion sweep of `rays` (6 (n,) components) needs
    on a small scene: each lane's primitive tests in
    sweep order up to and including its first hit, all of them when it
    hits nothing; with `extents` (sphere, plane, triangle rows, as
    DeviceScene.sweep_rows holds them) only the rows below them count. From a
    plain pass over the same inputs."""
    ops = {intersect.SPHERE: OPS_SPHERE, intersect.PLANE: OPS_PLANE, intersect.TRIANGLE: OPS_TRIANGLE}
    done = torch.zeros(rays[0].shape[0], dtype=torch.bool, device=rays[0].device)
    total = torch.zeros((), dtype=torch.int64, device=rays[0].device)
    for sl, r, kind, lo, hi in intersect._blocks(scene, rays, tuple(ops)):
        t, hit = intersect._hits(scene, kind, lo, hi, r)
        hit = hit & (t < intersect.INF)
        some = hit.any(dim=1)
        width = hi - lo if extents is None else max(0, min(hi, extents[kind]) - lo)
        tests = torch.where(some, hit.to(torch.int8).argmax(dim=1) + 1, width)
        total = total + torch.where(done[sl], 0, tests).sum() * ops[kind]
        done[sl] |= some
    return int(total)


def chunked_bound(scene, args, closest):
    """bound_ms of one CHUNKED_CLOSEST (`closest`) or CHUNKED_ANY launch
    on `args` (the arguments of the route's closest or occlusion call,
    ci.ROUTE_CALLS): 7 four-byte inputs a lane and 3 (or 1) outputs, the
    tables once; the unrolled step on every lane, then the slab tests and
    64 primitive tests a passing pair."""
    if closest:
        _, ro, rd, mask = args
    else:
        _, ro_closest, rd_closest, t, ptype, in_path, rd = args
        ro, mask = intersect.shadow_origins(ro_closest, rd_closest, t, ptype, in_path)
    n = mask.shape[0]
    tests, pairs, tri_pairs = cull_counts(scene, ro, rd, mask, closest)
    ch = scene.chunks
    n_bytes = n * 4 * (7 + (3 if closest else 1)) + 4 * (ch.bounds.numel() + ch.windows.numel())
    n_small_sph = 0 if ch.n_sph_chunks else scene.sph_radius.shape[0]
    small_ops = n * (n_small_sph * OPS_SPHERE + scene.pln_valid.shape[0] * OPS_PLANE)
    tri_op = OPS_TRIANGLE if closest else OPS_TRI_OCCLUDED
    n_ops = (small_ops + tests * OPS_SLAB
             + TRI_CHUNK * (tri_pairs * tri_op + (pairs - tri_pairs) * OPS_SPHERE))
    return bound_ms(n_bytes, n_ops) + (dict(slab_tests=tests, pairs=pairs),)


def bvh_bound(scene, n, counts, closest):
    """bound_ms of one BVH_CLOSEST (`closest`) or BVH_ANY launch over n
    lanes whose plain walk counted `counts` (ops/bvh.COUNT_KEYS): 7
    four-byte inputs a lane and 3 outputs (BVH_ANY: each lane's closest
    type and its output, and 11 four-byte inputs of each lane it walks,
    the root box tests less two an interior visit), the tables once; the box
    tests, the leaf tests of each kind and the
    fallback sweep over the valid sphere and plane rows of the lanes the
    walk missed; the tables are the root's box, the child-pair rows and the
    leaf rows (and the slot and fallback rows). Also returns the counts
    with the bytes of the rows the walk reads lane by lane (a 64-byte
    child-pair row an interior visit, a 64-byte leaf row a leaf test)."""
    b = scene.bvh
    tables = (8 + b.pairs.numel() + b.prims.numel()
              + (2 * b.prim_type.numel() + b.small.numel() if closest else 0))
    walked = counts["boxes"] - 2 * counts["interior"]
    n_bytes = 4 * (n * (7 + 3) if closest else n * 2 + walked * 11) + 4 * tables
    leaf_tests = sum(counts[k] for k in OPS_LEAF)
    n_sph, n_pln, _ = scene.sweep_rows
    fallback = n_sph * OPS_SPHERE + n_pln * OPS_PLANE
    n_ops = (counts["boxes"] * OPS_BOX + sum(counts[k] * v for k, v in OPS_LEAF.items())
             + counts["fallback_lanes"] * fallback)
    row_bytes = 64 * counts["interior"] + 64 * leaf_tests
    return bound_ms(n_bytes, n_ops) + (dict(counts, leaf_tests=leaf_tests, row_bytes=row_bytes),)


def fallback_bound(scene, n, pending):
    """bound_ms of BVH_CLOSEST's fallback pass over n lanes of which
    `pending` were left to it by the walk: each lane's type read, a pending
    lane's 6 ray inputs read and 3 outputs written, the valid sphere and
    plane rows once; the sweep of those rows for each pending lane."""
    n_sph, n_pln, _ = scene.sweep_rows
    n_bytes = 4 * (n + 9 * pending + n_sph * 8 + n_pln * 16)
    return bound_ms(n_bytes, pending * (n_sph * OPS_SPHERE + n_pln * OPS_PLANE))


def fallback_report(scene, args, out_dir, reps=5):
    """BVH_CLOSEST's fallback pass on one closest query `args` (scene, ro,
    rd, live) of the BVH route: the walk's and the pass's device ms a call
    (torch.profiler over `reps` calls), the lanes the walk leaves pending,
    the warp fill of those lanes in lane order (pending lanes over 32 x the
    32-lane groups that hold one: what one thread a lane in lane order
    would run), the bytes of rows it stages (0: read from global memory)
    and the pass's bound (fallback_bound)."""
    _, ro, rd, live = args
    n = live.shape[0]
    _, slot = bvh_ops.traverse_closest(scene.bvh, ro, rd, live)
    pending = (live != 0) & (slot < 0)
    groups = torch.nn.functional.pad(pending, (0, -n % 32)).view(-1, 32)
    lanes, busy_groups = int(pending.sum()), int(groups.any(1).sum())
    ci.bvh_closest_call(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ci.bvh_closest_call(*args)
        torch.cuda.synchronize()
    path = os.path.join(out_dir, "fallback_trace.json")
    prof.export_chrome_trace(path)
    per_call = kernel_breakdown(path, reps)[0]
    walk_ms = sum(v for k, v in per_call.items() if "walk_kernel" in k)
    pass_ms = sum(v for k, v in per_call.items() if "fallback_kernel" in k)
    ms, by = fallback_bound(scene, n, lanes)
    rows = scene.sweep_rows[:2]
    return dict(lanes=n, pending=lanes, rows=rows, staged_bytes=fallback_shared_bytes(*rows),
                lane_order_fill=lanes / max(32 * busy_groups, 1), walk_ms=walk_ms,
                fallback_ms=pass_ms, bound_ms=ms, bound_by=by, share=ms / max(pass_ms, 1e-9))


def time_ms(fn, reps):
    """Mean device ms of `fn` over `reps` calls after one warm-up call
    (CUDA events on the current stream)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bvh_group(name):
    """bvh_closest or bvh_any for a kernel of csrc/bvh.cu (the walk,
    templated on the walk's kind, and BVH_CLOSEST's fallback pass), else
    None."""
    if "fallback_kernel" in name:
        return "bvh_closest"
    if "walk_kernel" in name:
        return "bvh_closest" if "Closest" in name else "bvh_any"
    return None


def _group(name):
    if _bvh_group(name):
        return _bvh_group(name)
    for kernel in ("trace_kernel", "env_draw_kernel", "big_shade_kernel",
                   "chunked_closest_kernel", "chunked_any_kernel", "shade_kernel"):
        if kernel in name:
            return kernel[: -len("_kernel")]
    # index_select's kernel (vectorized_gather_kernel, or indexSelect* in
    # older builds); not elementwise_kernel_with_index (arange)
    if "gather" in name or "indexselect" in name.lower():
        return "gather"
    return "other_glue"


def kernel_breakdown(trace_path, iterations, group=_group, group_launches=None):
    """Per-kernel and per-group device ms per iteration, kernel launches
    per iteration and the busy share, from an exported Chrome trace;
    `group` names a kernel's group, and `group_launches`, a dict, gets
    each group's launches per iteration."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not spans:
        raise RuntimeError("the profiler recorded no device events")
    by_name = collections.Counter()
    for e in spans:
        by_name[e["name"]] += e["dur"]
    intervals = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans)
    busy, cur_start, cur_end = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy += cur_end - cur_start
    window = intervals[-1][1] - intervals[0][0]
    per_iter = {k: v / 1e3 / iterations for k, v in by_name.items()}
    groups = collections.Counter({"gather": 0.0} if group is _group else {})
    for k, v in per_iter.items():
        groups[group(k)] += v
    if group_launches is not None:
        for e in spans:
            if e.get("cat") == "kernel":
                group_launches[group(e["name"])] = group_launches.get(group(e["name"]), 0) + 1 / iterations
    launches = sum(e.get("cat") == "kernel" for e in spans) / iterations
    return per_iter, dict(groups), launches, busy / window


def capture_scan(ds, env, cam, size, bounces, at=(0, 3), sample=0):
    """{bounce: {"closest": (ro, rd, live), "any": (p, nee_dir, mask)}}:
    the arguments of the scan integrator's closest-hit and occlusion
    queries (intersect.closest_hit, any_hit) at the bounces `at` of one
    render_sample at size^2; live or mask is None where the integrator
    passes none."""
    seen = {"closest": 0, "any": 0}
    states = {b: {} for b in at}
    originals = {"closest": intersect.closest_hit, "any": intersect.any_hit}

    def wrap(key):
        def query(scene, ro, rd, *mask):
            b = seen[key]
            seen[key] += 1
            if b in states:
                states[b][key] = (tuple(c.clone() for c in ro), tuple(c.clone() for c in rd),
                                  mask[0].clone() if mask and mask[0] is not None else None)
            return originals[key](scene, ro, rd, *mask)
        return query

    with mock.patch.object(intersect, "closest_hit", wrap("closest")), \
            mock.patch.object(intersect, "any_hit", wrap("any")):
        render_sample(ds, env, cam, sample, (size, size), bounces)
    return states


def valid_sweep_ops(scene):
    """Operations of one closest sweep of a lane over the valid rows."""
    n_sph, n_pln, n_tri = scene.sweep_rows
    return n_sph * OPS_SPHERE + n_pln * OPS_PLANE + n_tri * OPS_TRIANGLE


def scan_bounds(scene, state):
    """(CLOSEST's bound, ANY's bound, live lanes, masked lanes) on a
    capture_scan state; each bound is bound_ms's (ms, by). CLOSEST: the
    live lanes' sweeps over the valid rows; its bytes are every lane's
    mask and 18 outputs and the live lanes' 6 ray inputs. ANY: the masked
    lanes' tests up to their first hit over the valid rows in sweep order;
    every lane's mask and output and the masked lanes' rays."""
    ro, rd, live = state["closest"]
    p, nd, mask = state["any"]
    n = ro[0].shape[0]
    live = torch.ones_like(ro[0], dtype=torch.bool) if live is None else live != 0
    mask = torch.ones_like(p[0], dtype=torch.bool) if mask is None else mask != 0
    n_live, n_mask = int(live.sum()), int(mask.sum())
    sel = torch.nonzero(mask).flatten()
    shadow_ops = first_hit_ops(scene, tuple(c.index_select(0, sel) for c in (*p, *nd)),
                               extents=scene.sweep_rows)
    closest = bound_ms(n * 4 * (1 + 18) + n_live * 4 * 6, n_live * valid_sweep_ops(scene))
    occlusion = bound_ms(n * 4 * 2 + n_mask * 4 * 6, shadow_ops)
    return closest, occlusion, n_live, n_mask


def scene_gathers(scene, fn):
    """Run fn(); returns the index_select calls in it whose source tensor
    is (a view of) a field of the DeviceScene `scene`."""
    fields = [getattr(scene, f.name) for f in dataclasses.fields(scene)]
    ptrs = {t.untyped_storage().data_ptr() for t in fields if isinstance(t, torch.Tensor)}
    count = [0]
    method, function = torch.Tensor.index_select, torch.index_select

    def counted(orig):
        def index_select(src, *args, **kwargs):
            if src.untyped_storage().data_ptr() in ptrs:
                count[0] += 1
            return orig(src, *args, **kwargs)
        return index_select

    with mock.patch.object(torch.Tensor, "index_select", counted(method)), \
            mock.patch.object(torch, "index_select", counted(function)):
        fn()
    return count[0]


SPLIT_SIZE = 256  # --path split: the parity checks
SPLIT_BUDGET = 512  # --path split: iterations of a timed step


def split_main(dev, card) -> int:
    """--path split: the multi-device split over every card."""
    from rsoderh_raytracing_tpu_torch.parallel.sharding import (
        ShardedRenderer, make_mesh, render_freerun_sharded, render_spp_sharded,
    )
    from rsoderh_raytracing_tpu_torch.render.wavefront import render_wavefront

    n = torch.cuda.device_count()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"[split_cards] count={n} cards={[c for c in cards.strip().splitlines()]!r}", flush=True)
    ds, env, cam = scene_setup("house", dev)
    res = (SPLIT_SIZE, SPLIT_SIZE)
    if n >= 2:
        ref, ref_counts = render_freerun(ds, env, cam, 0, res, 16, BOUNCES)
        img, counts, _ = render_freerun_sharded(ds, env, cam, 0, make_mesh(n, tile=n), res, 16, BOUNCES)
        differ = int((img.to(dev).view(torch.int32) != ref.view(torch.int32)).sum())
        counts_differ = int((counts.to(dev) != ref_counts).sum())
        print(f"[split] mesh=tile:{n} size={SPLIT_SIZE} values_differ={differ} "
              f"counts_differ={counts_differ} card={card!r}", flush=True)
        if differ or counts_differ:
            raise AssertionError(f"the tile-only split over {n} cards is not the unsharded render")
        specs = [(f"dp:{n}", 1)] + ([(f"tile:2,dp:{n // 2}", 2)] if n % 2 == 0 and n >= 4 else [])
        for spec, tile in specs:
            mesh = make_mesh(n, tile=tile)
            s_n = mesh.shape["sample"]
            img, counts, _ = render_freerun_sharded(ds, env, cam, 0, mesh, res, 4, 1)
            same = render_wavefront(ds, env, cam, 0, res, 4 * s_n, 1)
            exact = bool((counts == 4 * s_n).all())
            close = bool(torch.allclose(img.to(dev), same, rtol=2e-5, atol=2e-5))
            print(f"[split] mesh={spec} size={SPLIT_SIZE} max_bounces=1 counts_exact={exact} "
                  f"allclose_2e5={close} card={card!r}", flush=True)
            if not (exact and close):
                raise AssertionError(f"{spec}: counts or image differ from the unsharded render")
        summed = render_spp_sharded(ds, env, cam, 0, make_mesh(n), res, BOUNCES)
        seq = sum(render_sample(ds, env, cam, s, res, BOUNCES) for s in range(n))
        close = bool(torch.allclose(summed.to(dev), seq, rtol=1e-4, atol=1e-4))
        held = ",".join(f"{torch.cuda.memory_allocated(i) / 2**20:.1f}" for i in range(n))
        print(f"[split] mesh=dp:{n} path=render_spp_sharded size={SPLIT_SIZE} allclose_1e4={close} "
              f"held_mib_by_card={held} card={card!r}", flush=True)
        if not close:
            raise AssertionError(f"render_spp_sharded on dp:{n} is not the render_sample sum")

    scene = load_scene(os.path.join(ROOT, "assets", "scenes", "house.toml"))
    sky = Environment.from_texture("sky", procedural_sky(2048, 1024))
    ks = [k for k in (1, 2, 4, 8) if k < n] + [n]
    rates = collections.defaultdict(list)
    for k in ks + ks[::-1]:
        renderer = Renderer(scene, SIZE, SIZE, environments=EnvironmentMaps([sky]),
                            max_bounces=BOUNCES, device=dev)
        sharded = ShardedRenderer(renderer, make_mesh(k))
        sharded.step_freerun(16)
        for i in range(k):
            torch.cuda.synchronize(i)
        start = time.perf_counter()
        sharded.step_freerun(SPLIT_BUDGET)
        rays = sharded.last_stats["closest_rays"] + sharded.last_stats["shadow_rays"]
        rates[k].append(rays / (time.perf_counter() - start) / 1e6)
        del renderer, sharded
    base = sum(rates[1]) / len(rates[1])
    for k in ks:
        mean = sum(rates[k]) / len(rates[k])
        print(f"[split_scale] scene=house size={SIZE} bounces={BOUNCES} budget={SPLIT_BUDGET} "
              f"mesh=dp:{k} mrays_per_s={','.join(f'{r:.2f}' for r in rates[k])} "
              f"speedup={mean / base:.3f} card={card!r}", flush=True)
    return 0


# --path spans: the port's spans and counters (tracing.py) laid over a
# torch.profiler trace of the same calls.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
# The kernels an iteration launches inside its wavefront.step span on each
# route: TRACE, SHADE and BIG_SHADE ("shade_kernel" names both), ENV_DRAW,
# the walks and BVH_CLOSEST's fallback.
STEP_KERNELS = ("trace_kernel", "shade_kernel", "env_draw_kernel", "walk_kernel", "fallback_kernel")
SPANS_CALLS = 6  # --path spans: calls a side of the tracing-cost comparison
SPANS_ITERATIONS = 64


def chrome_events(path):
    """(device operations [(name, device, start, end, correlation)], CUDA
    runtime calls [(name, start, end, correlation)], annotations {name:
    (start, end)}) of a torch.profiler Chrome trace, in wall-clock
    nanoseconds (ts * 1000 + baseTimeNanoseconds): the clock of the spans
    of tracing.take()."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    ops, runtime, notes = [], [], {}
    for e in trace["traceEvents"]:
        if e.get("ph") != "X":
            continue
        start = base + round(e["ts"] * 1000.0)
        end = start + round(e.get("dur", 0) * 1000.0)
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.append((e["name"], int(args.get("device", 0)), start, end, args.get("correlation")))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            runtime.append((e["name"], start, end, args.get("correlation")))
        elif cat == "user_annotation":
            notes[e["name"]] = (start, end)
    return ops, runtime, notes


def _innermost(spans, points):
    """The name of the innermost span open at each of `points` (sorted),
    None where none is: spans of one thread nest, so a sweep with a stack
    finds it."""
    order = sorted(spans, key=lambda sp: (sp["start"], -sp["end"]))
    stack, names, i = [], [], 0
    for t in points:
        while i < len(order) and order[i]["start"] <= t:
            while stack and stack[-1]["end"] <= order[i]["start"]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1]["end"] <= t:
            stack.pop()
        names.append(stack[-1]["name"] if stack else None)
    return names


def _idle_gaps(ops, window):
    """The stretches of `window` (start, end) in which a device ran
    nothing: [(start, end)], over each device in turn."""
    lo, hi = window
    gaps = []
    for dev in sorted({o[1] for o in ops}):
        cursor = lo
        for _, _, s, e, _ in sorted((o for o in ops if o[1] == dev), key=lambda o: o[2]):
            if e <= lo or s >= hi:
                continue
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if hi > cursor:
            gaps.append((cursor, hi))
    return sorted(gaps)


def span_report(spans, counters, ops, runtime, window) -> dict:
    """The tracing metrics of one profiled stretch `window` (start, end in
    wall-clock ns) of calls or frames, from tracing.take()'s spans and
    counters and chrome_events' operations and runtime calls:

    - enqueue_ms_per_iter: host ms inside each wavefront.step span less
      the time inside CUDA runtime calls within it (a launch that blocks
      on a full queue is not enqueue cost), over the step spans;
    - launches_per_iter: device operations whose runtime call (by
      correlation) starts inside a wavefront.step span, over those spans;
    - stall_ms: device-idle ms a call (renderer.step_freerun span) whose
      gap starts inside a program span; idle_ms: {innermost span at the
      gap's start, or "outside": ms a call}; inside_share: stall over all
      idle time;
    - syncs_per_call: the sync.* counters summed, a call;
    - clock_share: the share of the launches of STEP_KERNELS whose
      runtime call lies inside a wavefront.step span, and clock_max_ms
      the farthest such call lies outside every one."""
    lo, hi = window
    inside = [sp for sp in spans if sp["end"] > lo and sp["start"] < hi]
    steps = sorted((sp for sp in inside if sp["name"] == "wavefront.step"), key=lambda sp: sp["start"])
    calls = sum(1 for sp in inside if sp["name"] == "renderer.step_freerun") or 1
    n = len(steps) or 1
    bounds = [(sp["start"], sp["end"]) for sp in steps]
    starts = [b[0] for b in bounds]

    def outside(t0, t1):
        """0 where a step span holds [t0, t1], else the ns by which it
        pokes out of the nearest one."""
        k = bisect.bisect_right(starts, t0) - 1
        near = [j for j in (k, k + 1) if 0 <= j < len(bounds)]
        return min((max(0, bounds[j][0] - t0) + max(0, t1 - bounds[j][1]) for j in near),
                   default=float("inf"))

    enqueue = 0
    for s0, s1 in bounds:
        inner = sorted((max(r[1], s0), min(r[2], s1)) for r in runtime if r[2] > s0 and r[1] < s1)
        busy, cur = 0, None
        for a, b in inner:
            if cur is None or a > cur[1]:
                busy += 0 if cur is None else cur[1] - cur[0]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        busy += 0 if cur is None else cur[1] - cur[0]
        enqueue += (s1 - s0) - busy
    launch_at = {r[3]: (r[0], r[1], r[2]) for r in runtime if r[3] is not None}
    launched, own, own_inside, worst = 0, 0, 0, 0
    for name, _, _, _, corr in ops:
        call = launch_at.get(corr)
        if call is None:
            continue
        if outside(call[1], call[1]) == 0:
            launched += 1
        if call[0] in LAUNCH_CALLS and any(key in name for key in STEP_KERNELS):
            own += 1
            off = outside(call[1], call[2])
            own_inside += off == 0
            worst = max(worst, off)
    gaps = _idle_gaps(ops, window)
    idle = collections.Counter()
    for (g0, g1), name in zip(gaps, _innermost(inside, [g[0] for g in gaps])):
        idle[name or "outside"] += g1 - g0
    total = sum(idle.values())
    stall = total - idle["outside"]
    syncs = sum(v for k, v in counters.items() if k.startswith("sync."))
    return dict(
        calls=calls, steps=len(steps),
        enqueue_ms_per_iter=enqueue / n / 1e6,
        launches_per_iter=launched / n,
        stall_ms=stall / calls / 1e6,
        idle_ms={k: v / calls / 1e6 for k, v in idle.most_common()},
        inside_share=stall / total if total else 0.0,
        syncs_per_call=syncs / calls,
        clock_share=own_inside / own if own else None,
        clock_max_ms=worst / 1e6,
    )


def spans_main(args, dev, card) -> int:
    """--path spans: SPANS_CALLS calls of step_freerun(SPANS_ITERATIONS)
    with tracing off and on by turns (their host seconds: the cost of
    tracing), then one call profiled (the card's activity alone) with
    tracing on, reported by span_report."""
    from rsoderh_raytracing_tpu_torch import tracing

    scene = named_scene(args.scene)
    env = Environment.from_texture("sky", procedural_sky(2048, 1024))
    renderer = Renderer(scene, SIZE, SIZE, environments=EnvironmentMaps([env]), max_bounces=BOUNCES,
                        intersector=args.intersector, device=dev)
    renderer.step_freerun(SPANS_ITERATIONS)  # build + warm-up
    seconds = {False: [], True: []}
    for on in [False, True, True, False] * (SPANS_CALLS // 2):
        if on:
            tracing.enable()
        torch.cuda.synchronize()
        start = time.perf_counter()
        renderer.step_freerun(SPANS_ITERATIONS)
        torch.cuda.synchronize()
        seconds[on].append(time.perf_counter() - start)
        tracing.disable()
        tracing.take()
    off, on = (sorted(seconds[k])[len(seconds[k]) // 2] for k in (False, True))
    print(f"[tracing_cost] scene={args.scene} size={SIZE} iterations={SPANS_ITERATIONS} "
          f"off_ms={off * 1e3:.3f} on_ms={on * 1e3:.3f} on_over_off={on / off:.5f} card={card!r}",
          flush=True)
    tracing.enable()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("spans"):
            renderer.step_freerun(SPANS_ITERATIONS)
            torch.cuda.synchronize()
    tracing.disable()
    rec = tracing.take()
    path = os.path.join(args.out, f"{args.scene}_spans_trace.json")
    prof.export_chrome_trace(path)
    ops, runtime, notes = chrome_events(path)
    # a profile of the card's activity alone holds no host annotation: the
    # stretch runs from its first runtime call to its last operation's end
    window = notes.get("spans") or (min(r[1] for r in runtime), max(o[3] for o in ops))
    report = span_report(rec["spans"], rec["counters"], ops, runtime, window)
    print(f"[spans] scene={args.scene} {json.dumps(report)} card={card!r}", flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("loop", "split", "spans"), default="loop",
                        help="the free-run kernel loop, the split over every card, or the port's "
                             "spans over a profile")
    parser.add_argument("--scene", default="house",
                        help="a scene of assets/scenes or a generated one (house_tiled16, "
                             "house_tiled64)")
    parser.add_argument("--intersector", choices=("auto", "sweep", "bvh"), default="auto",
                        help="the route of the default path, as the CLI's --intersector "
                             "(sweep: the small or chunked route, whatever the scene's size)")
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: profiling needs a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    if args.path == "split":
        return split_main(dev, card)
    if args.path == "spans":
        return spans_main(args, dev, card)
    ds, env, cam = scene_setup(args.scene, dev,
                               with_bvh={"auto": "auto", "sweep": False, "bvh": True}[args.intersector])
    res = (SIZE, SIZE)
    zeros = np.zeros(res, np.uint32)

    render_freerun(ds, env, cam, zeros, res, 16, BOUNCES)  # build + warm-up
    torch.cuda.synchronize()
    budget = 16
    iterations = budget + BOUNCES - 1
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        render_freerun(ds, env, cam, zeros, res, budget, BOUNCES)
        torch.cuda.synchronize()
    trace_path = os.path.join(args.out, f"{args.scene}_trace.json")
    prof.export_chrome_trace(trace_path)
    per_iter, groups, launches, busy = kernel_breakdown(trace_path, iterations)
    total = sum(per_iter.values())
    for name, ms in sorted(per_iter.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[kernel] ms_per_iter={ms:.4f} share={ms / total:.4f} name={name[:110]}", flush=True)
    print("[group] scene=%s iterations=%d total_ms_per_iter=%.4f %s launches_per_iter=%.1f "
          "busy_share=%.4f card=%r" % (
              args.scene, iterations, total,
              " ".join(f"{k}_ms={v:.4f}" for k, v in sorted(groups.items())),
              launches, busy, card), flush=True)

    wave = Wavefront(ds, env, cam, zeros, res, NO_LIMIT, 64, BOUNCES)
    for it in range(2):
        wave.step(it)
    captured = capture_step(wave, 2)
    if route(ds) == CHUNKED:
        for key, closest in (("closest", True), ("occlusion", False)):
            ms, by, counts = chunked_bound(ds, captured[key], closest)
            print(f"[cull] scene={args.scene} kernel={key} lanes={SIZE * SIZE} "
                  f"slab_tests={counts['slab_tests']} pairs={counts['pairs']} "
                  f"pairs_per_lane={counts['pairs'] / (SIZE * SIZE):.3f} "
                  f"bound_ms={ms:.4f} bound_by={by} card={card!r}", flush=True)
        return 0
    if route(ds) == BVH:
        for key, closest in (("closest", True), ("occlusion", False)):
            kfn, pfn = ci.ROUTE_CALLS[BVH][key]
            counts = {}
            pfn(*captured[key], counts=counts)
            ms, by, info = bvh_bound(ds, SIZE * SIZE, counts, closest)
            print(f"[walk] scene={args.scene} kernel={key} lanes={SIZE * SIZE} "
                  f"ms={time_ms(lambda: kfn(*captured[key]), 5):.4f} "
                  + " ".join(f"{k}={v}" for k, v in info.items())
                  + f" bound_ms={ms:.4f} bound_by={by} card={card!r}", flush=True)
        fb = fallback_report(ds, captured["closest"], args.out)
        print(f"[fallback] scene={args.scene} "
              + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in fb.items())
              + f" card={card!r}", flush=True)
        return 0

    tr_args = captured["trace"]
    calls = {"trace": lambda: cw.trace_call(*tr_args)}
    calls.update({k: fns[0] for k, fns in sweep_calls(tr_args)[0].items()})
    print(f"[sweep] scene={args.scene} lanes={SIZE * SIZE} "
          + " ".join(f"{k}_ms={time_ms(fn, 20):.4f}" for k, fn in calls.items())
          + f" card={card!r}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
