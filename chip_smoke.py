"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's paths (rsoderh_raytracing_tpu_torch) on the card and
exits non-zero at the first failure. Phases, one line each or more:

1. device: requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from csrc/ with nvcc, one process a
   source, in parallel;
3. house (small-scene route: TRACE, SHADE): parity of each kernel with its
   plain version, output by output, at 256x256 lanes after 3 plain
   iterations; the main path at 2048x2048, 8 bounces,
   procedural_sky(2048, 1024), render_freerun with base counts carried
   between calls (Mrays/s in all and per call, launch counts, peak device
   memory, the TRACE/SHADE split, and a short profiled call that must show
   no row gather); parity again on a 2048^2 loop state (TRACE's NEE pmf,
   quad row and NEE uv bitwise), then each kernel's time beside its plain
   version's;
4. big-mesh parity (ENV_DRAW, CHUNKED_CLOSEST, CHUNKED_ANY, BIG_SHADE):
   suzanne_hi and spheres at 256x256 lanes after 3 plain iterations,
   spheres and suzanne at 2048x2048 lanes; ENV_DRAW output by output and
   its state, NEE uv and pmf bitwise on every lane, the closest hit
   compared on live lanes, occlusion on masked lanes, BIG_SHADE (its quad
   row read at the fused uv) output by output;
5. big-mesh main path: suzanne_hi (15,488 triangles, 242 chunks) at
   2048x2048, 8 bounces, a warm-up call then timed calls carrying counts,
   as the reference's bench runs it with BENCH_SCENE=suzanne_hi; the four
   big-mesh kernels must have launched and TRACE/SHADE not; the
   env_draw/closest/glue/occlusion/big_shade split; then a short spheres
   run at 2048x2048;
6. timing: each big-mesh kernel against its plain version on a
   suzanne_hi 2048^2 loop state, with its bound from the inputs' cull
   counts (profiling.chunked_bound), and beside it the pairs, candidates
   and slab tests of a walk in the chunked kernels' batches (the traversal
   model intersect.chunked_*_model) and a block's shared memory; the plain
   version's outputs of that one timed call are the parity reference of
   suzanne_hi at 2048^2;
7. goldens: render_wavefront through the kernels against
   tests/goldens/{default,house}_64_8spp.npy and the oracle anchors
   suzanne_hi_anchor_24_2spp.npy and spheres_anchor_32_4spp.npy, and
   suzanne_xhi_anchor_16_2spp.npy through the chunked and the BVH routes
   (suzanne_xhi generated as in phase 12), each by the flip-aware
   criteria;
8. the sweep kernels (CLOSEST, ANY, FUSED; within phase 3, on the house
   loop states at 256x256 and 2048x2048): parity with their plain
   versions, then each one's time beside its plain version's and its
   bound; then CLOSEST and ANY on the scan integrator's own states
   (bounces 0 and 3 of one render_sample, profiling.capture_scan) at
   256x256 and 2048x2048: every output by the parity gate, t, type,
   index, material id and occlusion bitwise on every lane, the dead
   lanes' fixed record; at 2048x2048 their times and the bounds of
   profiling.scan_bounds (bounce 0's go to the kernels line);
9. scan path: Renderer on house at 2048x2048, 8 bounces, a few step()
   calls through the scan integrator (CLOSEST and ANY once a bounce, no
   TRACE or SHADE), seconds a sample and Mrays/s; no index_select on a
   table of the scene in a step (profiling.scene_gathers); a 256x256
   sample on the card against the plain path on the CPU (relative RMSE
   below GOLDEN_REL_RMSE_MAX);
10. composed body: render_freerun at 2048x2048 with the float32 legacy
   quad (FUSED once an iteration, no TRACE or SHADE), Mrays/s and the ms
   split; then the RGBE quad under RT_DISABLE_WFKERNELS=1 against the
   kernel loop at 128x128;
11. command line: cli.main on house at 256x256, 8 spp, exact and freerun
   to PNG, .hdr with --save-checkpoint, and --checkpoint resume; the files
   are read back (under build/chip_smoke/);
12. the BVH route (ENV_DRAW, BVH_CLOSEST, BVH_ANY, BIG_SHADE): generates
   assets/suzanne_xxhi.obj (991,232 triangles, past the chunked route's
   ceilings) and assets/suzanne_xhi.obj with scripts/subdivide_obj.py when
   they are absent; builds suzanne_xxhi's BVH (seconds, the native
   builder, nodes, depth < 64); renders it at 2048x2048, 8 bounces,
   free-run through the BVH route (Mrays/s, peak memory); holds BVH_CLOSEST
   and BVH_ANY bitwise to their plain twins (ops/bvh.py) on every lane of
   a 256x256 and a 2048x2048 loop state, then times them beside the plain
   twins and the bound of their walks' counts (profiling.bvh_bound), with
   each walk's ptxas registers and stack and the lanes it walks (masked
   lanes whose ray enters the root's box); ENV_DRAW and BIG_SHADE (its
   quad row read at the fused uv) against their plain twins on both loop
   states, as in phase 4;
   compares suzanne_hi at 256x256 through the BVH and the chunked routes
   (the anchors' flip-aware criteria); then the crossover: house, spheres,
   and suzanne at 968, 3,872, 15,488, 61,952 and 247,808 triangles (levels
   1 and 3 generated under build/chip_smoke/), each through its sweep
   route and through the BVH, the routes in turns, a warm-up call then
   three calls a route (Mrays/s median and spread, each route's kernels
   only); a Renderer with the default intersector on each scene reports
   the route of auto_bvh's rule (the BVH past CUDA_BVH_ABOVE_LANES sphere
   and triangle lanes), and suzanne_xhi through 'auto' runs the BVH
   route's kernels at its rate. Its seconds on a line of their own;
13. sync rounds (render_spp_sync): at 256x256 on house against
   render_wavefront(spp=2) (counts equal everywhere, the bit-equal share,
   the anchors' flip-aware criteria: SHADE regenerates render_wavefront's
   later camera rays in-kernel, the rounds take theirs from tensor code),
   then at 2048x2048, 8 bounces, house (32 rounds a call) and suzanne_hi
   (4 rounds a call), a warm-up call then timed calls carrying the counts
   (bench.py's BENCH_MODE=sync settings and ray accounting), beside one
   free-run call of the same scene; the launch counts of each;
14. multi-device (parallel/sharding.py) on slots of the one card: dryrun(4);
   at 256x256 on house the tile-only split over 2 and 4 slots bitwise the
   unsharded render_freerun (image and counts), dp:2 and tile:2,dp:2 with
   exact counts (max_bounces=1) and images allclose(2e-5) to the unsharded
   render of the same samples, render_spp_sharded on dp:2 allclose(1e-4)
   to render_sample 0 + 1; then house at 2048x2048, 8 bounces, through
   ShardedRenderer dp:1 and Renderer.step_freerun in turns (Mrays/s each
   and their ratio: the single controller's cost on one card), and one
   dp:2 run on two slots of the card (Mrays/s, peak memory: no scaling
   figure, both slots share the card);
15. viewer: the CLI's --view on house at 256x144 on a pseudo-terminal of
   120x40 cells, frames watched for 10 s, then 'p', a key, dev views 2, 3
   and 1, and 'q'; exit code 0, frames a second, the last spp= and the
   fitted resolution; then python -m rsoderh_raytracing_tpu_torch.viewer.fps
   on default and house at 256x144, 60 frames: frames a second with the
   camera still and moving, platform gpu, each above 0;
16. chunk orders (RT_CHUNK_CLUSTER=morton|bvh|treelet, and the OBJ order
   of RT_DISABLE_MORTON=1, each set and unset by the phase): suzanne_hi
   in the bvh and treelet orders, CHUNKED_CLOSEST, CHUNKED_ANY and
   BIG_SHADE against their plain versions at 256x256 (after 3 plain
   iterations) and 2048x2048, t, type, index and occlusion bitwise on
   every lane; each order's 256x256 free-run image against Morton's
   (counts, the bit-equal share, the anchors' flip-aware criteria); the
   lines of profiling --path cluster (chunks, surface area, host
   seconds, CHUNKED_CLOSEST and CHUNKED_ANY ms and the pairs of the
   kernels' batch model on a 2048^2 loop state, Mrays/s of a 32-iteration
   free-run call) for suzanne_hi and suzanne_xhi in every order,
   suzanne_xhi under RT_MAX_CHUNKED_TRIS=1048576 (its treelet order
   passes the default ceiling); then suzanne_xxhi under that ceiling:
   'sweep' takes the chunked route ('auto' walks its BVH under either
   ceiling), the shared-memory mirror equals the kernels' figure, parity
   at 256x256, the three kernels' ms at 2048^2 and one short 2048^2 call
   (budget 16) beside phase 12's BVH-route Mrays/s;
17. every scene (profiling.tiled_house; the phase sets and unsets its
   knobs): house_tiled16 (256 ground tiles, 328 padded lanes, a 26 KB
   table: the small route past Mosaic's 192-lane budget) with the sweep
   mirror against the card's limit, TRACE, SHADE, FUSED, CLOSEST and ANY
   against their plain versions at 256x256 (and CLOSEST/ANY on the scan
   states, t, type and index bitwise) and 2048x2048, the main path at
   2048x2048, 8 bounces, free-run (TRACE and SHADE only), TRACE and SHADE
   ms with their bounds, Mrays/s beside the BVH route's, and the 256x256
   images of both routes by the flip-aware criteria; house_tiled64 (4,096
   tiles, a 272 KB table past a block's shared memory, which the sweep
   kernels read from global memory) under intersector='sweep': the small
   route with the BVH under 'auto', TRACE, SHADE, FUSED, CLOSEST and ANY
   against their plain versions at 256x256 (CLOSEST/ANY also on the scan
   states), the main path at 2048x2048 (TRACE and SHADE only; Mrays/s
   beside the BVH route's), TRACE ms with its bound, and its 256x256 image
   against the BVH route's; CHUNKED_CLOSEST and CHUNKED_ANY on suzanne_hi
   with a block that holds one or three batches' union boxes at a time,
   bitwise their plain versions; RT_DISABLE_PALLAS=1: on the card house,
   suzanne_hi and suzanne_xxhi (BVH) refuse to run (RuntimeError, no
   kernel launched), and the same scene tables copied to the CPU render
   there with no kernel launched, each image against the card's kernel
   route by the flip-aware criteria (house 128x128, the others 64x64);
   RT_DEBUG_NANS=1: the three scenes at 256x256 raise nothing,
   a NaN ray lane handed to CLOSEST raises FloatingPointError naming it,
   and house at 2048x2048 Mrays/s with the knob on and off;
18. the lane layout (render/wavefront.lane_order, compact_every): at
   2048x2048, 8 bounces, free-run, from counts 0, each setting a warm-up
   call then three calls in turns (Mrays/s median and spread, the
   permutations a call), every call's image, counts and stats bitwise the
   first's: house block-major (the default) against
   RT_DISABLE_BLOCK_REMAP=1; suzanne_hi and suzanne_xhi at K = 0, the
   reference's default cadence (2 and 1) and K = 4, and the card's default
   beside them; on a loop state without and with a permutation,
   CHUNKED_CLOSEST and CHUNKED_ANY ms and the batch model's pairs,
   candidates and busy (block, batch) pairs, the three big-mesh kernels'
   permuted outputs the unpermuted ones moved with the lanes; one
   permutation's key, sort, gather and whole ms at 4.2M lanes; suzanne_hi
   at 256x256 under each RT_COMPACT_KEY bitwise K = 0; spheres' default
   permutes nothing.
Each of 13-18 logs its seconds.

Then the run's seconds, a JSON line with each of the eleven kernels' launches, largest absolute and
relative errors (and the outputs that hold them), times and bound, the
card line again, and last {"ok": true, "device": {...}}. Imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import pty
import re
import select
import struct
import subprocess
import sys
import termios
import time
import tomllib
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from rsoderh_raytracing_tpu_torch import cli, load_scene, tracing, write_png  # noqa: E402
from rsoderh_raytracing_tpu_torch.accel import bvh as accel_bvh  # noqa: E402
from rsoderh_raytracing_tpu_torch.accel import native as accel_native  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops  # noqa: E402
from rsoderh_raytracing_tpu_torch.env.environment import (  # noqa: E402
    Environment, EnvironmentMaps, device_environment, load_default_environments,
)
from rsoderh_raytracing_tpu_torch.env.hdr_io import read_hdr  # noqa: E402
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import _kernels  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import intersect  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops.tonemap import aces_tonemap, linear_to_srgb  # noqa: E402
from rsoderh_raytracing_tpu_torch.parallel.sharding import (  # noqa: E402
    ShardedRenderer, dryrun, make_mesh, render_freerun_sharded, render_spp_sharded,
)
from rsoderh_raytracing_tpu_torch.profiling import (  # noqa: E402
    CLUSTER_ORDERS, KERNELS, bound_ms, bvh_bound, capture_scan, capture_step, card_line, chunk_order,
    chunked_bound, cluster_report, first_hit_ops, kernel_breakdown, knob_env, named_scene, scan_bounds,
    scan_calls, scene_gathers, scene_setup, shade_outputs, sweep_calls, sweep_ops, time_ms,
    valid_sweep_ops,
)
from rsoderh_raytracing_tpu_torch.render.integrator import (  # noqa: E402
    MAX_BOUNCES, camera_pytree, render_sample,
)
from rsoderh_raytracing_tpu_torch.render import wavefront as wf  # noqa: E402
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer  # noqa: E402
from rsoderh_raytracing_tpu_torch.render.wavefront import (  # noqa: E402
    NO_LIMIT, Wavefront, render_freerun, render_spp_sync, render_wavefront,
)
from rsoderh_raytracing_tpu_torch.scene.device import (  # noqa: E402
    BVH, CHUNKED, CUDA_BVH_ABOVE_LANES, SMALL, SWEEP_MAX_SHARED, TRI_CHUNK, auto_bvh,
    build_device_scene, route, sweep_shared_bytes,
)
from rsoderh_raytracing_tpu_torch.scene.toml_loader import build_scene  # noqa: E402
from rsoderh_raytracing_tpu_torch.utils.png import read_png  # noqa: E402

# Kernel against plain version on the same card, output by output: an
# integer output must be equal, and a float output isclose(RTOL, ATOL),
# on at least PARITY_MIN of the compared lanes. Measured on an H100
# (700 W): TRACE and SHADE agree on every lane (SHADE bitwise, TRACE
# within 6e-8), so this fails a kernel that is wrong in one output on
# 0.01% of the lanes. TRACE's NEE pmf, quad row and NEE uv are held
# bitwise (trace_parity).
PARITY_MIN = 0.9999
RTOL, ATOL = 1e-4, 1e-5
# Relative RMSE against the CPU-made goldens. The CPU test holds the plain
# path to 5e-4 (tests/test_torch_wavefront.py); on the card the kernels'
# sin/cos/sqrt round as CUDA's libdevice does, and a few paths flip.
# Measured on an H100 (700 W): 1.35e-4 (default), 1.04e-4 (house).
GOLDEN_REL_RMSE_MAX = 1e-3

SIZE = 2048
BOUNCES = 8
TIMED_CALLS = 2
CALL_SECONDS = 8.0  # target time of one timed call
SRC_WAVEFRONT = "rsoderh_raytracing_tpu_torch/csrc/wavefront.cu"
SRC_CHUNKED = "rsoderh_raytracing_tpu_torch/csrc/chunked.cu"
SRC_SWEEP = "rsoderh_raytracing_tpu_torch/csrc/sweep.cu"
SRC_BVH = "rsoderh_raytracing_tpu_torch/csrc/bvh.cu"
# The generated meshes of the BVH phase: subdivision level by file.
GENERATED_MESHES = {"suzanne_xxhi.obj": 5, "suzanne_xhi.obj": 4}
# The BVH phase's crossover runs: the scenes, each through its sweep route
# and through the BVH at SIZE^2, BOUNCES, the routes in turns: a warm-up
# call each (16 iterations), then CROSSOVER_CALLS calls of CROSSOVER_BUDGET
# iterations.
# suzanne_lN is suzanne.toml with its mesh subdivided N times
# (scripts/subdivide_obj.py N; suzanne_hi is level 2, suzanne_xhi 4).
CROSSOVER_SCENES = ("house", "spheres", "suzanne", "suzanne_l1", "suzanne_hi", "suzanne_l3",
                    "suzanne_xhi")
CROSSOVER_LEVELS = {"suzanne_l1": 1, "suzanne_l3": 3}
CROSSOVER_BUDGET = 32
CROSSOVER_CALLS = 3
# 'auto' timed on suzanne_xhi through a Renderer: step_freerun's budget.
AUTO_BUDGET = 64
# suzanne_hi through the BVH and the chunked routes at 256x256: the leaf
# tests round apart, so a few paths flip; the suzanne_hi anchor's
# flip-aware criteria (tests/test_reference_estimator.py) hold the rest.
ROUTES_SIZE, ROUTES_SPP = 256, 4
FLIP_ABS = 1e-2
FLIPPED_MAX = 0.03
UNFLIPPED_REL_RMSE_MAX = 0.005
SCAN_STEPS = 3
# Samples of the 256^2 scan image held against the CPU's. One sample
# differs from the CPU's by a relative RMSE of up to a few 1e-3 on an
# H100 (700 W), 1.9e-3 for sample 0, in the tree before the lane masks
# too: the card's and the CPU's tensor glue round apart and a few paths
# flip (`python -m rsoderh_raytracing_tpu_torch.profiling --path
# scan-image` reads it; the kernels equal their plain versions bit for
# bit). The mean over 16 samples averages the flipped paths down.
SCAN_CPU_SPP = 16
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
# The big-mesh kernels by Wavefront.step keyword.
BIG_KERNELS = {"env_draw": "env_draw", "closest": "chunked_closest", "occlusion": "chunked_any",
               "big_shade": "big_shade"}
# The kernels a free-run iteration launches, by route.
ROUTE_LAUNCHES = {SMALL: {"trace", "shade"}, CHUNKED: set(BIG_KERNELS.values()),
                  BVH: {"env_draw", "bvh_closest", "bvh_any", "big_shade"}}
# ENV_DRAW's outputs that are exact by construction (the alias index, its
# jitter and pmf, the state after four draws): bitwise on every lane.
ENV_DRAW_EXACT = ("state", "nee_u", "nee_v", "nee_pmf")


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check_parity(kernel, lanes, got, ref, int_names, where=None):
    """Log and assert the kernel's agreement with its plain version on
    the lanes `where` (all by default); returns the largest absolute and
    relative float differences, each with the output that holds it, as
    {"abs": (value, output), "rel": (value, output)}."""
    if where is not None:
        got = {k: v[where] for k, v in got.items()}
        ref = {k: v[where] for k, v in ref.items()}
    shares, worst_abs, worst_rel = cw.parity(got, ref, int_names, RTOL, ATOL)
    ints = [shares[k] for k in shares if k in int_names]
    floats = [shares[k] for k in shares if k not in int_names]
    log("parity", kernel=kernel, lanes=lanes,
        compared=int(next(iter(got.values())).shape[0]),
        int_equal_min=f"{min(ints):.6f}" if ints else "none",
        float_close_min=f"{min(floats):.6f}" if floats else "none",
        worst=min(shares, key=shares.get), max_rel_diff=f"{worst_rel[0]:.3e}",
        max_rel_output=worst_rel[1], max_abs_diff=f"{worst_abs[0]:.3e}",
        max_abs_output=worst_abs[1])
    bad = sorted(k for k, v in shares.items() if v < PARITY_MIN)
    if bad:
        raise AssertionError(f"{kernel} kernel disagrees with its plain version in {bad}")
    return {"abs": worst_abs, "rel": worst_rel}


def keep_worst(max_err, name, err):
    """Fold a check_parity result into max_err[name], the largest of each."""
    cur = max_err.setdefault(name, {"abs": (0.0, None), "rel": (0.0, None)})
    for k in ("abs", "rel"):
        if err[k][1] is not None and (cur[k][1] is None or err[k][0] > cur[k][0]):
            cur[k] = err[k]


def trace_parity(label, lanes, args, max_err):
    """TRACE against its plain version on `args`: every output by
    check_parity, then the outputs that are exact by construction bitwise:
    the NEE pmf and the quad row on every lane, and the fused uv (the alias
    draw's texel and jitter) on the lanes where both hit."""
    got, ref = cw.trace_call(*args), cw.trace_plain(*args)
    keep_worst(max_err, "trace", check_parity(f"trace:{label}", lanes, got, ref, cw.TRACE_INT_NAMES))
    both_hit = (got["hit"] != 0) & (ref["hit"] != 0)
    differ = {
        "nee_pmf": int((got["nee_pmf"].view(torch.int32) != ref["nee_pmf"].view(torch.int32)).sum()),
        "quad": int((got["quad"] != ref["quad"]).any(dim=1).sum()),
        "quad_miss": int(((got["quad"] != ref["quad"]).any(dim=1) & ~both_hit).sum()),
        **{f"{k}_hit": int((got[k].view(torch.int32) != ref[k].view(torch.int32))[both_hit].sum())
           for k in ("fu", "fv")},
    }
    log("parity", kernel=f"trace:{label}", lanes=lanes, hit_lanes=int(both_hit.sum()),
        **{f"{k}_lanes_differ": v for k, v in differ.items()})
    if any(differ.values()):
        raise AssertionError(f"TRACE's NEE pmf, quad row or NEE uv is not bitwise its plain version's: {differ}")


def kernel_parity(key, label, args, lanes, max_err, ref=None):
    """The big-mesh kernel of Wavefront.step keyword `key` on `args`
    against its plain version's outputs on them (`ref`, computed here
    when not given): CHUNKED_CLOSEST on live lanes, CHUNKED_ANY on masked
    lanes, ENV_DRAW and BIG_SHADE output by output on every lane, and
    ENV_DRAW_EXACT bitwise."""
    kfn, pfn = KERNELS[key]
    got = kfn(*args)
    ref = pfn(*args) if ref is None else ref
    if key == "env_draw":
        differ = {k: int((_bits(got[k]) != _bits(ref[k])).sum()) for k in ENV_DRAW_EXACT}
        log("parity", kernel=f"env_draw:{label}", lanes=lanes,
            **{f"{k}_lanes_differ": v for k, v in differ.items()})
        if any(differ.values()):
            raise AssertionError(f"ENV_DRAW's draw is not bitwise its plain version's on {label}: {differ}")
        ints = {"state"}
        where = None
    elif key == "closest":
        names = ("t", "type", "index")
        got, ref, ints, where = dict(zip(names, got)), dict(zip(names, ref)), {"type", "index"}, args[3] != 0
    elif key == "occlusion":
        got, ref, ints, where = {"occ": got}, {"occ": ref}, {"occ"}, args[3] != 0
    else:
        got, ref, ints, where = shade_outputs(got), shade_outputs(ref), cw.SHADE_INT_NAMES, None
    name = BIG_KERNELS[key]
    keep_worst(max_err, name, check_parity(f"{name}:{label}", lanes, got, ref, ints, where))


def big_parity(label, state, lanes, max_err):
    for key in BIG_KERNELS:
        kernel_parity(key, label, state[key], lanes, max_err)


def reset_launches():
    cw.reset_launches()
    ci.reset_launches()


def launches():
    return {**cw.LAUNCHES, **ci.LAUNCHES}


def timed_main(label, ds, env, cam, card, calls, dev, budget=None):
    """A warm-up call, then `calls` timed free-run calls at SIZE^2 with
    base counts carried; returns (launches of the timed calls, with their
    loop iterations under "iterations", image, counts, warm-up counts)."""
    res = (SIZE, SIZE)
    n_pixels = SIZE * SIZE
    warm_budget = 16 if budget is None else min(budget, 16)
    torch.cuda.synchronize()
    start = time.perf_counter()
    _, counts, _ = render_freerun(ds, env, cam, np.zeros(res, np.uint32), res, warm_budget,
                                  BOUNCES, with_stats=True)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - start) / (warm_budget + BOUNCES - 1)
    warm_counts = counts
    if budget is None:
        budget = int(min(1024, max(8, CALL_SECONDS / per_iter)))
    total_rays, total_spp, image, call_rates = 0, 0.0, None, []
    torch.cuda.reset_peak_memory_stats(dev)
    # allocated before the timed calls: the scene, the environment and
    # whatever earlier phases still hold
    held = torch.cuda.memory_allocated(dev)
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        call_start = time.perf_counter()
        out, counts_dev, stats = render_freerun(ds, env, cam, counts, res, budget, BOUNCES,
                                                with_stats=True)
        counts = counts + counts_dev
        rays = int(stats["closest_rays"] + stats["shadow_rays"])  # synchronizes
        call_rates.append(rays / (time.perf_counter() - call_start) / 1e6)
        total_rays += rays
        total_spp += float(counts_dev.float().mean())
        image = out if image is None else image + out
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counted = launches()
    log("main", scene=label, size=SIZE, bounces=BOUNCES, budget=budget, calls=calls,
        seconds=f"{elapsed:.3f}", mrays_per_s=f"{total_rays / elapsed / 1e6:.2f}",
        per_call_mrays_per_s=",".join(f"{r:.2f}" for r in call_rates),
        rays_per_px_spp=f"{total_rays / (n_pixels * max(total_spp, 1e-9)):.3f}",
        spp=f"{total_spp:.2f}", **{f"{k}_launches": v for k, v in counted.items()},
        peak_allocated_mib=f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f}",
        held_before_mib=f"{held / 2**20:.1f}",
        warmup_ms_per_iter=f"{per_iter * 1e3:.2f}", card=repr(card))
    if not bool(torch.isfinite(image).all()):
        raise AssertionError(f"{label}: non-finite pixels in the main-path image")
    if int(counts.min()) <= 0 or total_rays <= 0:
        raise AssertionError(f"{label}: pixels without samples or no rays traced")
    counted["iterations"] = calls * (budget + BOUNCES - 1)
    counted["mrays_per_s"] = total_rays / elapsed / 1e6
    return counted, image, counts, warm_counts


def split(label, ds, env, cam, counts, card):
    """Device ms per iteration of each part of a short call, from the CUDA
    events of Wavefront.step's part spans (tracing.py)."""
    tracing.enable(device_events=True)
    try:
        render_freerun(ds, env, cam, counts, (SIZE, SIZE), 8, BOUNCES)
        spans = tracing.take()["spans"]
    finally:
        tracing.disable()
    parts = {}
    for sp in spans:
        if sp["name"].startswith("step."):
            part = sp["name"][len("step."):]
            parts[part] = parts.get(part, 0.0) + sp["device_ms"]
    n = sum(1 for sp in spans if sp["name"] == "wavefront.step")
    log("split", scene=label, iterations=n,
        **{f"{k}_ms": f"{v / n:.4f}" for k, v in parts.items()}, card=repr(card))


def no_gather(label, ds, env, cam, counts, card):
    """A short free-run call under torch.profiler: device ms an iteration
    by group, launches an iteration and the busy share; the small route's
    iteration must run TRACE and SHADE and no row gather."""
    budget = 4
    iterations = budget + BOUNCES - 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        render_freerun(ds, env, cam, counts, (SIZE, SIZE), budget, BOUNCES)
        torch.cuda.synchronize()
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{label}_trace.json")
    prof.export_chrome_trace(path)
    per_iter, groups, launches_per_iter, busy = kernel_breakdown(path, iterations)
    os.remove(path)
    trace_calls = sum(1 for k in per_iter if "trace_kernel" in k)
    log("profile", scene=label, iterations=iterations,
        **{f"{k}_ms": f"{v:.4f}" for k, v in sorted(groups.items())},
        launches_per_iter=f"{launches_per_iter:.1f}", busy_share=f"{busy:.4f}", card=repr(card))
    if groups["gather"] != 0.0 or not trace_calls or not groups.get("shade"):
        raise AssertionError(f"{label}: the iteration ran a row gather or missed TRACE/SHADE: {groups}")


def save_png(name, image, counts, warm_counts):
    png_dir = os.path.join(ROOT, "build")
    os.makedirs(png_dir, exist_ok=True)
    # image sums the timed calls; their samples are counts - warm_counts
    mean_img = image / (counts - warm_counts).clamp_min(1).unsqueeze(-1).to(image.dtype)
    write_png(os.path.join(png_dir, f"{name}_2048.png"),
              linear_to_srgb(aces_tonemap(mean_img)).cpu().numpy())


def loop_state(ds, env, cam, size, base, plain_iterations, kernel_iterations=0):
    """The kernels' arguments at one iteration of a free-run loop state at
    size^2 lanes after some plain (or kernel) iterations."""
    wave = Wavefront(ds, env, cam, base, (size, size), NO_LIMIT, 64, BOUNCES)
    for it in range(plain_iterations):
        capture_step(wave, it, plain=True)
    for it in range(plain_iterations, plain_iterations + kernel_iterations):
        wave.step(it)
    it = plain_iterations + kernel_iterations
    return capture_step(wave, it, plain=plain_iterations > 0)


def time_kernel(kfn, pfn, args):
    """((kernel ms, plain ms), the plain version's outputs): the kernel
    timed twice, the plain version once (about 11 s for CHUNKED_CLOSEST
    on suzanne_hi at 2048^2 on an H100)."""
    k1 = time_ms(lambda: kfn(*args), 5)
    k2 = time_ms(lambda: kfn(*args), 5)
    torch.cuda.synchronize()
    start = time.perf_counter()
    ref = pfn(*args)
    torch.cuda.synchronize()
    return ((k1 + k2) / 2, (time.perf_counter() - start) * 1e3), ref


def anchor(name, size, spp, env, dev, with_bvh=False):
    """The oracle anchor golden through the kernels of the sweep route (or
    of the BVH route, `with_bvh`), with the reference's flip-aware
    criteria (tests/test_reference_estimator.py; the meshes' for
    suzanne_xhi too)."""
    scene = load_scene(os.path.join(ROOT, "assets", "scenes", f"{name}.toml"))
    ds = build_device_scene(scene, dev, with_bvh=with_bvh)
    img = render_wavefront(ds, env, camera_pytree(scene.camera, dev), 0, (size, size), spp, MAX_BOUNCES)
    ours = img.cpu().numpy() / spp
    ref = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}_anchor_{size}_{spp}spp.npy"))
    diff = ours - ref
    ad = np.abs(diff).max(-1)
    flipped = ad > 1e-2
    keep = ~flipped
    rel = float(np.sqrt((diff[keep] ** 2).mean()) / np.sqrt((ref[keep] ** 2).mean()))
    mrel = abs(float(ours.mean()) - float(ref.mean())) / float(ref.mean())
    within = float((ad < 1e-4).mean())
    log("golden", scene=f"{name}_anchor", route=route(ds), size=size, spp=spp,
        flipped=f"{flipped.mean():.4f}", within_1e4=f"{within:.4f}", rel_rmse_unflipped=f"{rel:.3e}",
        image_mean_rel=f"{mrel:.3e}")
    if name in ("suzanne_hi", "suzanne_xhi"):
        ok = flipped.mean() < 0.03 and within > 0.95 and rel < 0.005
    else:
        ok = within > 0.45 and rel < 0.005 and mrel < 0.05
    if not ok:
        raise AssertionError(f"{name}: the anchor golden's criteria fail")


def sweep_parity(trace_args, lanes, max_err):
    for name, (kfn, pfn, ints) in sweep_calls(trace_args)[0].items():
        keep_worst(max_err, name, check_parity(name, lanes, kfn(), pfn(), ints))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x.to(torch.int32)


def scan_parity(label, lanes, ds, state, max_err):
    """CLOSEST and ANY on a capture_scan state against their plain
    versions: every output by check_parity; t, type, index, material id
    and occlusion bitwise on every lane; every dead (unmasked) lane holds
    the miss record with zero attributes (0 for ANY)."""
    closest, occlusion = scan_calls(ds, state)
    ro, rd, live = state["closest"]
    p, nd, mask = state["any"]
    live, mask = live.to(torch.int32), mask.to(torch.int32)
    got, ref = closest(), intersect.closest_record(ds, ro, rd, live)
    keep_worst(max_err, "closest",
               check_parity(f"closest:{label}", lanes, got, ref, ci.CLOSEST_INT_NAMES))
    occ, occ_ref = occlusion(), intersect.any_sweep(ds, *p, *nd) & (mask != 0)
    keep_worst(max_err, "any", check_parity(f"any:{label}", lanes, {"occ": occ.to(torch.int32)},
                                            {"occ": occ_ref.to(torch.int32)}, {"occ"}))
    dead = live == 0
    differ = {k: int((_bits(got[k]) != _bits(ref[k])).sum()) for k in ("t", "type", "index", "material_id")}
    differ["occ"] = int((occ != occ_ref).sum())
    differ["dead_not_miss"] = int(sum(
        (_bits(got[k])[dead] != _bits(torch.full_like(got[k][dead], v))).sum()
        for k, v in (("t", intersect.INF), ("type", -1), ("index", 0), ("material_id", 0),
                     *((k, 0.0) for k in ci.CLOSEST_OUT_NAMES[3:9]),
                     *((k, 0.0) for k in intersect.MATERIAL_NAMES))))
    differ["unmasked_occ"] = int(occ[mask == 0].sum())
    log("parity", kernel=f"closest_any:{label}", lanes=lanes, live=int((~dead).sum()),
        masked=int((mask != 0).sum()), **{f"{k}_lanes_differ": v for k, v in differ.items()})
    if any(differ.values()):
        raise AssertionError(f"CLOSEST/ANY on the scan state {label} are not exact: {differ}")


def scan_path(scene, sky_host, sky, card, dev):
    """Renderer.step() on house at SIZE^2: the scan integrator, CLOSEST
    and ANY once a bounce; `sky` is the device copy of `sky_host`.
    Returns the launch counts of the timed steps and the stats sample."""
    n_pixels = SIZE * SIZE
    renderer = Renderer(scene, SIZE, SIZE, environments=EnvironmentMaps([sky_host]),
                        max_bounces=BOUNCES, device=dev)
    renderer.step()  # warm-up: uploads the environment
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    for _ in range(SCAN_STEPS):
        renderer.step()
    torch.cuda.synchronize()
    per_sample = (time.perf_counter() - start) / SCAN_STEPS
    _, stats = render_sample(renderer.device_scene, sky, camera_pytree(scene.camera, dev),
                             renderer.film.sample_count, (SIZE, SIZE), BOUNCES, with_stats=True)
    rays = int(stats["closest_rays"] + stats["shadow_rays"])
    counted = launches()
    log("scan", scene="house", size=SIZE, bounces=BOUNCES, steps=SCAN_STEPS,
        s_per_sample=f"{per_sample:.4f}", rays_per_sample=rays,
        mrays_per_s=f"{rays / per_sample / 1e6:.2f}", rays_per_px_spp=f"{rays / n_pixels:.3f}",
        **{f"{k}_launches": v for k, v in counted.items()},
        peak_allocated_mib=f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f}", card=repr(card))
    expected = (SCAN_STEPS + 1) * BOUNCES
    if counted["closest"] != expected or counted["any"] != expected:
        raise AssertionError(f"the scan path launched CLOSEST {counted['closest']} and ANY "
                             f"{counted['any']} times, expected {expected}")
    if any(counted[k] for k in ("trace", "shade", "fused", "env_draw", "big_shade")):
        raise AssertionError("the scan path launched a wavefront kernel")
    image = renderer.film.mean_radiance()
    if renderer.film.sample_count != SCAN_STEPS + 1 or not np.isfinite(image).all():
        raise AssertionError("the scan path's film is wrong")
    os.makedirs(OUT_DIR, exist_ok=True)
    renderer.save_png(os.path.join(OUT_DIR, "house_scan_2048.png"))

    # no row gather on a scene table: CLOSEST writes the hit record
    gathers = scene_gathers(renderer.device_scene, renderer.step)
    if gathers:
        raise AssertionError(f"the scan path gathered {gathers} rows of scene tables")

    # 256^2 through the scan path: on the card with the kernels, on the
    # card with their plain versions in their place (the same image bit
    # for bit: the kernels equal the plain versions on every lane), and
    # on the CPU (the plain path); one sample and SCAN_CPU_SPP
    def scan_film(device, plain=False):
        r = Renderer(scene, 256, 256, environments=EnvironmentMaps([sky_host]),
                     max_bounces=BOUNCES, device=device)
        patches = contextlib.ExitStack()
        if plain:
            patches.enter_context(mock.patch.object(ci, "closest_call", intersect.closest_record))
            patches.enter_context(mock.patch.object(
                ci, "any_call", lambda s, ro, rd, mask=None: intersect.any_sweep(s, *ro, *rd) & (mask != 0)))
        with patches:
            r.step()
            one = r.film.mean_radiance()
            for _ in range(SCAN_CPU_SPP - 1):
                r.step()
        return one, r.film.mean_radiance()

    def rel_rmse(got, ref):
        return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))

    kernels, plain, cpu = scan_film(dev), scan_film(dev, plain=True), scan_film("cpu")
    differ = sum(int((a.view(np.uint32) != b.view(np.uint32)).sum()) for a, b in zip(kernels, plain))
    log("scan", scene="house", size=256, scene_table_index_selects=gathers,
        kernels_vs_plain_on_card_values_differ=differ,
        card_vs_cpu_rel_rmse_1spp=f"{rel_rmse(kernels[0], cpu[0]):.3e}",
        card_vs_cpu_rel_rmse=f"{rel_rmse(kernels[1], cpu[1]):.3e}", spp=SCAN_CPU_SPP,
        bound=GOLDEN_REL_RMSE_MAX)
    if differ:
        raise AssertionError(f"the scan path's image through CLOSEST/ANY differs from the plain "
                             f"versions' in {differ} values")
    if not rel_rmse(kernels[1], cpu[1]) < GOLDEN_REL_RMSE_MAX:
        raise AssertionError("the scan image on the card against the CPU's: relative RMSE "
                             f"{rel_rmse(kernels[1], cpu[1]):.3e}")
    return counted


def composed_path(scene_name, ds, sky_host, sky, cam, card, dev):
    """The composed body at SIZE^2 with the float32 legacy quad, then the
    RGBE quad through both bodies at 128^2. Returns the launch counts of
    the timed call."""
    env_f32 = device_environment(sky_host, dev, "float32")
    log("composed", quad_dtype=str(env_f32.quad.dtype), quad_shape=tuple(env_f32.quad.shape),
        quad_mib=f"{env_f32.quad.numel() * 4 / 2**20:.0f}")
    counted, image, counts, warm = timed_main(f"{scene_name}_composed_f32", ds, env_f32, cam, card,
                                              1, dev)
    if counted["fused"] != counted["iterations"] or any(
            counted[k] for k in ("trace", "shade", "closest", "any")):
        raise AssertionError(f"the composed body did not launch FUSED once an iteration: {counted}")
    save_png(f"{scene_name}_composed", image, counts, warm)
    split(f"{scene_name}_composed_f32", ds, env_f32, cam, counts, card)
    del env_f32

    res, budget = (128, 128), 16
    reset_launches()
    k_img, k_cnt, k_st = render_freerun(ds, sky, cam, 0, res, budget, BOUNCES, with_stats=True)
    if launches()["trace"] != budget + BOUNCES - 1:
        raise AssertionError("the kernel loop did not run TRACE once an iteration")
    os.environ["RT_DISABLE_WFKERNELS"] = "1"
    try:
        reset_launches()
        c_img, c_cnt, c_st = render_freerun(ds, sky, cam, 0, res, budget, BOUNCES, with_stats=True)
        fused = launches()
    finally:
        del os.environ["RT_DISABLE_WFKERNELS"]
    if fused["fused"] != budget + BOUNCES - 1 or fused["trace"] or fused["shade"]:
        raise AssertionError(f"RT_DISABLE_WFKERNELS=1 did not take the composed body: {fused}")
    k_mean = (k_img / k_cnt.unsqueeze(-1)).cpu().numpy()
    c_mean = (c_img / c_cnt.unsqueeze(-1)).cpu().numpy()
    rel = float(np.sqrt(np.mean((c_mean - k_mean) ** 2)) / np.sqrt(np.mean(k_mean ** 2)))
    same = float((c_cnt == k_cnt).double().mean())
    log("composed", compare="rgbe_composed_vs_kernel_loop", size=res[0], budget=budget,
        counts_equal=f"{same:.6f}", iterations=(int(c_st["iterations"]), int(k_st["iterations"])),
        closest_rays=(int(c_st["closest_rays"]), int(k_st["closest_rays"])),
        rel_rmse=f"{rel:.3e}", bound=GOLDEN_REL_RMSE_MAX)
    if same < PARITY_MIN or int(c_st["iterations"]) != int(k_st["iterations"]):
        raise AssertionError("composed body and kernel loop disagree in counts or iterations")
    if not rel < GOLDEN_REL_RMSE_MAX:
        raise AssertionError(f"composed body against kernel loop: relative RMSE {rel:.3e}")
    return counted


def cli_phase(dev):
    """cli.main end to end on the card: PNG in both modes, .hdr with a
    checkpoint, and resume; every file is read back."""
    os.makedirs(OUT_DIR, exist_ok=True)
    scene_path = os.path.join(ROOT, "assets", "scenes", "house.toml")
    base = ["--scene", scene_path, "--resolution", "256x256", "--quiet"]

    def run(*args):
        rc = cli.main(base + list(args))
        if rc != 0:
            raise AssertionError(f"cli.main {args} returned {rc}")

    def out(name):
        return os.path.join(OUT_DIR, name)

    start = time.perf_counter()
    run("--spp", "8", "--output", out("cli_exact.png"))
    renderer = Renderer(load_scene(scene_path), 256, 256, device=dev)
    renderer.render(spp=8)
    if not np.array_equal(read_png(out("cli_exact.png")), renderer.film.srgb8()):
        raise AssertionError("the exact-mode PNG is not the film's srgb8")
    run("--spp", "8", "--mode", "freerun", "--output", out("cli_freerun.png"))
    renderer = Renderer(load_scene(scene_path), 256, 256, device=dev)
    renderer.render(spp=8, mode="freerun")
    if not np.array_equal(read_png(out("cli_freerun.png")), renderer.film.srgb8()):
        raise AssertionError("the freerun-mode PNG is not the film's srgb8")
    freerun_spp = renderer.film.sample_count

    run("--spp", "8", "--output", out("cli.hdr"), "--save-checkpoint", out("cli_8.npz"))
    hdr = read_hdr(out("cli.hdr"))
    if hdr.shape != (256, 256, 3) or not np.isfinite(hdr).all() or not hdr.mean() > 0:
        raise AssertionError("the .hdr output is wrong")
    run("--spp", "8", "--checkpoint", out("cli_8.npz"), "--output", out("cli_same.png"),
        "--save-checkpoint", out("cli_8b.npz"))
    run("--spp", "12", "--checkpoint", out("cli_8.npz"), "--output", out("cli_12.png"),
        "--save-checkpoint", out("cli_12.npz"))
    with np.load(out("cli_8.npz")) as a, np.load(out("cli_8b.npz")) as b, np.load(out("cli_12.npz")) as c:
        saved = int(a["sample_count"])
        if saved != 8 or a["counts"].dtype != np.uint32 or "state_stamp" not in a.files:
            raise AssertionError("the checkpoint's fields are wrong")
        if int(b["sample_count"]) != saved or not np.array_equal(a["cumulative"], b["cumulative"]):
            raise AssertionError("resuming at the saved count rendered more samples")
        if int(c["sample_count"]) != 12 or not (c["counts"] == 12).all():
            raise AssertionError("resuming to 12 spp did not reach 12 everywhere")
    log("cli", runs=5, seconds=f"{time.perf_counter() - start:.2f}", exact_spp=8,
        freerun_min_spp=freerun_spp, resumed_from=saved, resumed_to=12,
        files=",".join(sorted(os.listdir(OUT_DIR))))


def generated_mesh(name):
    """assets/NAME, generated by scripts/subdivide_obj.py when absent."""
    path = os.path.join(ROOT, "assets", name)
    if not os.path.exists(path):
        start = time.perf_counter()
        subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "subdivide_obj.py"),
                        str(GENERATED_MESHES[name]), path], check=True, cwd=ROOT, timeout=600)
        log("mesh", file=name, level=GENERATED_MESHES[name],
            seconds=f"{time.perf_counter() - start:.2f}")
    return path


def crossover_scene(name):
    """The host Scene of a crossover scene: assets/scenes/NAME.toml, or
    suzanne.toml with its mesh subdivided CROSSOVER_LEVELS[name] times
    (written under OUT_DIR when absent)."""
    if name not in CROSSOVER_LEVELS:
        return load_scene(os.path.join(ROOT, "assets", "scenes", f"{name}.toml"))
    level = CROSSOVER_LEVELS[name]
    mesh = os.path.join(OUT_DIR, f"{name}.obj")
    if not os.path.exists(mesh):
        os.makedirs(OUT_DIR, exist_ok=True)
        subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "subdivide_obj.py"), str(level), mesh],
                       check=True, cwd=ROOT, timeout=600, stdout=subprocess.DEVNULL)
    path = os.path.join(ROOT, "assets", "scenes", "suzanne.toml")
    with open(path, "rb") as f:
        descriptor = tomllib.load(f)
    for obj in descriptor["object"]:
        if "Mesh" in obj:
            obj["Mesh"]["path"] = mesh
    return build_scene(descriptor, path)


def route_calls(label, routes, env, cam, card):
    """Each route's scene (name -> DeviceScene): a warm-up call of 16
    iterations, then CROSSOVER_CALLS free-run calls at SIZE^2, BOUNCES, CROSSOVER_BUDGET
    iterations from counts 0, the routes in turns; each route must launch
    its own kernels and no other route's. Logs and returns
    {name: (median Mrays/s, spread)}."""
    res = (SIZE, SIZE)
    rates = {name: [] for name in routes}
    for turn in range(CROSSOVER_CALLS + 1):
        for name, ds in routes.items():
            reset_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            image, counts, stats = render_freerun(ds, env, cam, 0, res, CROSSOVER_BUDGET if turn else 16,
                                                  BOUNCES, with_stats=True)
            rays = int(stats["closest_rays"] + stats["shadow_rays"])  # synchronizes
            seconds = time.perf_counter() - start
            ran = {k for k, v in launches().items() if v}
            if ran != ROUTE_LAUNCHES[route(ds)] or int(counts.min()) <= 0:
                raise AssertionError(f"{label} on the {name} route launched {sorted(ran)}, expected "
                                     f"{sorted(ROUTE_LAUNCHES[route(ds)])}, or left a pixel unsampled")
            if turn:
                rates[name].append(rays / seconds / 1e6)
            if not bool(torch.isfinite(image).all()):
                raise AssertionError(f"{label} on the {name} route: non-finite pixels")
    got = {}
    for name in routes:
        r = sorted(rates[name])
        got[name] = (r[len(r) // 2], r[-1] - r[0])
        log("crossover", scene=label, route=name, sphere_lanes=routes[name].sph_radius.shape[0],
            triangle_lanes=routes[name].tri_valid.shape[0],
            size=SIZE, bounces=BOUNCES, budget=CROSSOVER_BUDGET, mrays_per_s=f"{got[name][0]:.2f}",
            spread=f"{got[name][1]:.2f}", per_call=",".join(f"{x:.2f}" for x in rates[name]),
            card=repr(card))
    return got


def crossover(sky_host, sky, card, dev):
    """The sweep/BVH crossover (phase 12): Mrays/s of each crossover scene
    through its sweep route and through the BVH, median and spread; then
    a Renderer with the default intersector on each scene must report the
    route auto_bvh's rule names, and suzanne_xhi through 'auto' must run at
    the BVH route's rate."""
    start = time.perf_counter()
    medians, lanes = {}, {}
    for name in CROSSOVER_SCENES:
        sc = crossover_scene(name)
        routes = {"sweep": build_device_scene(sc, dev, with_bvh=False),
                  "bvh": build_device_scene(sc, dev, with_bvh=True)}
        lanes[name] = (routes["sweep"].sph_radius.shape[0], routes["sweep"].tri_valid.shape[0])
        medians[name] = route_calls(name, routes, sky, camera_pytree(sc.camera, dev), card)
        del routes
    measured_s = time.perf_counter() - start
    envs = EnvironmentMaps([sky_host])
    for name in CROSSOVER_SCENES:
        sc = crossover_scene(name)
        renderer = Renderer(sc, SIZE, SIZE, environments=envs, max_bounces=BOUNCES, device=dev)
        expect = "bvh" if sum(lanes[name]) > CUDA_BVH_ABOVE_LANES else "sweep"
        sweep, bvh = medians[name]["sweep"], medians[name]["bvh"]
        log("auto", scene=name, sphere_lanes=lanes[name][0], triangle_lanes=lanes[name][1],
            above_lanes=CUDA_BVH_ABOVE_LANES,
            intersector=renderer.intersector, expected=expect,
            faster="bvh" if bvh[0] > sweep[0] else "sweep", card=repr(card))
        if renderer.intersector != expect:
            raise AssertionError(f"'auto' took the {renderer.intersector} route on {name}, "
                                 f"the rule names {expect}")
        if name != "suzanne_xhi":
            del renderer
            continue
        renderer.step_freerun(16)  # warm-up
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.step_freerun(AUTO_BUDGET)
        rays = renderer.last_stats["closest_rays"] + renderer.last_stats["shadow_rays"]
        torch.cuda.synchronize()
        rate = rays / (time.perf_counter() - t0) / 1e6
        ran = {k for k, v in launches().items() if v}
        log("auto", scene=name, size=SIZE, bounces=BOUNCES, budget=AUTO_BUDGET,
            intersector=renderer.intersector, mrays_per_s=f"{rate:.2f}",
            bvh_route_mrays_per_s=f"{bvh[0]:.2f}", sweep_route_mrays_per_s=f"{sweep[0]:.2f}",
            launched=",".join(sorted(ran)), card=repr(card))
        if ran != ROUTE_LAUNCHES[BVH] or abs(rate - bvh[0]) > abs(rate - sweep[0]):
            raise AssertionError(f"suzanne_xhi through 'auto' ran {sorted(ran)} at {rate:.2f} Mrays/s, "
                                 f"not the BVH route's {bvh[0]:.2f}")
        del renderer
    log("crossover", seconds=f"{time.perf_counter() - start:.1f}", measured_s=f"{measured_s:.1f}")


def bvh_parity(label, lanes, state, max_err):
    """BVH_CLOSEST and BVH_ANY on a loop state (capture_step's arguments)
    against their plain twins: every output by check_parity, then t, type,
    index and occlusion bitwise on every lane, the masked-out ones
    included. Returns {Wavefront.step keyword: (the plain twin's ms, its
    walk counts)}."""
    out = {}
    for key, name, kfn, pfn, ints in (
        ("closest", "bvh_closest", ci.bvh_closest_call, bvh_ops.closest_plain, {"type", "index"}),
        ("occlusion", "bvh_any", ci.bvh_any_call, bvh_ops.any_plain, {"occ"}),
    ):
        args = state[key]
        got = kfn(*args)
        counts = {}
        torch.cuda.synchronize()
        start = time.perf_counter()
        ref = pfn(*args, counts=counts)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - start) * 1e3
        names = ("t", "type", "index") if key == "closest" else ("occ",)
        got = dict(zip(names, got if key == "closest" else (got,)))
        ref = dict(zip(names, ref if key == "closest" else (ref,)))
        keep_worst(max_err, name, check_parity(f"{name}:{label}", lanes, got, ref, ints))
        differ = {k: int((_bits(got[k]) != _bits(ref[k])).sum()) for k in names}
        mask = args[3] != 0
        log("parity", kernel=f"{name}:{label}", lanes=lanes, masked=int(mask.sum()),
            **{f"{k}_lanes_differ": v for k, v in differ.items()},
            **({"unmasked_not_miss": int((got["type"][~mask] != -1).sum())} if key == "closest"
               else {"unmasked_occ": int(got["occ"][~mask].sum())}))
        if any(differ.values()):
            raise AssertionError(f"{name} is not bitwise its plain twin on {label}: {differ}")
        out[key] = (plain_ms, counts)
    return out


def walked_lanes(scene, ro, rd, mask):
    """The lanes a BVH walk starts: mask set and the ray enters the
    root's box."""
    root = scene.bvh.nodes[0:1]
    enters, _ = bvh_ops.slab(ro, tuple(1.0 / c for c in rd), root[:, 0:3], root[:, 4:7])
    return int((enters & (mask != 0)).sum())


def image_of(ds, env, cam, size, spp):
    img = render_wavefront(ds, env, cam, 0, (size, size), spp, BOUNCES)
    return img.cpu().numpy() / spp


def bvh_phase(sky_host, sky, card, dev, max_err, times, bounds):
    """The BVH route (phase 12). Returns the launch counts of the
    suzanne_xxhi main run."""
    phase_start = time.perf_counter()
    for name in GENERATED_MESHES:
        generated_mesh(name)
    scene = load_scene(os.path.join(ROOT, "assets", "scenes", "suzanne_xxhi.toml"))
    start = time.perf_counter()
    xx_ds = build_device_scene(scene, dev, with_bvh="auto")
    scene_s = time.perf_counter() - start
    if route(xx_ds) != BVH:
        raise AssertionError("with_bvh='auto' did not route suzanne_xxhi to the BVH")
    b = xx_ds.bvh
    log("bvh_build", scene="suzanne_xxhi", triangles=len(scene.meshes.triangles),
        primitives=b.prim_type.shape[0], seconds=f"{b.build_seconds:.3f}",
        native=accel_native.available(), nodes=b.num_nodes, depth=b.depth, max_leaf=b.max_leaf)
    if not accel_native.available():
        raise AssertionError("the native BVH builder did not build or load")
    if not b.depth < accel_bvh.TRAVERSAL_STACK_DEPTH:
        raise AssertionError(f"suzanne_xxhi's BVH is {b.depth} deep")
    log("bvh_scene", scene="suzanne_xxhi", route=route(xx_ds), seconds=f"{scene_s:.3f}",
        lanes=xx_ds.num_lanes, node_mib=f"{b.nodes.numel() * 4 / 2**20:.1f}",
        leaf_mib=f"{b.prims.numel() * 4 / 2**20:.1f}")
    cam = camera_pytree(scene.camera, dev)

    # parity of both walks with their twins at 256^2 and at 2048^2, and of
    # ENV_DRAW and BIG_SHADE (its quad row read at the fused uv) on the
    # same states
    small = loop_state(xx_ds, sky, cam, 256, 0, 3)
    bvh_parity("suzanne_xxhi", 256 * 256, small, max_err)
    state = loop_state(xx_ds, sky, cam, SIZE, 0, 0, kernel_iterations=2)
    plain = bvh_parity("suzanne_xxhi", SIZE * SIZE, state, max_err)
    for key in ("env_draw", "big_shade"):
        kernel_parity(key, "suzanne_xxhi", small[key], 256 * 256, max_err)
        kernel_parity(key, "suzanne_xxhi", state[key], SIZE * SIZE, max_err)
    del small
    ptxas = [ln.split("ptxas info    : ")[-1] for ln in _kernels.BUILD_INFO.get("ptxas", [])]
    for key, name, closest in (("closest", "bvh_closest", True), ("occlusion", "bvh_any", False)):
        kfn = ci.bvh_closest_call if closest else ci.bvh_any_call
        k1 = time_ms(lambda: kfn(*state[key]), 5)
        k2 = time_ms(lambda: kfn(*state[key]), 5)
        plain_ms, counts = plain[key]
        times[name] = ((k1 + k2) / 2, plain_ms)
        ms, by, info = bvh_bound(xx_ds, SIZE * SIZE, counts, closest)
        bounds[name] = (ms, by)
        log("timing", kernel=name, scene="suzanne_xxhi", lanes=SIZE * SIZE,
            masked=int((state[key][3] != 0).sum()), ms=f"{times[name][0]:.4f}",
            plain_ms=f"{plain_ms:.1f}", bound_ms=f"{ms:.4f}", bound_by=by,
            **{k: v for k, v in info.items()},
            visits_per_lane=f"{info['visits'] / SIZE ** 2:.2f}", card=repr(card))
        # each of its kernels' registers and stack (ptxas), and the lanes it
        # walks: masked, and the ray enters the root's box
        kind = "Closest" if closest else "Any"
        regs = {}
        for i, ln in enumerate(ptxas[:-2]):
            found = re.search(r"(walk_kernel)INS_\d+(Closest|Any)E|(fallback_kernel)", ln)
            if "Compiling" not in ln or not found:
                continue
            if found.group(2) == kind or (closest and found.group(3)):
                regs[found.group(1) or found.group(3)] = (f"{ptxas[i + 2].strip()}; "
                                                          f"{ptxas[i + 1].strip()}")
        log("bvh_walk", kernel=name, walked_lanes=walked_lanes(*state[key]),
            ptxas=json.dumps(regs))
    del state, plain

    # the main path: suzanne_xxhi at 2048^2, 8 bounces, free-run
    counted, image, counts, warm = timed_main("suzanne_xxhi_bvh", xx_ds, sky, cam, card, 1, dev)
    for k in ("env_draw", "bvh_closest", "bvh_any", "big_shade"):
        if counted[k] <= 0:
            raise AssertionError(f"the suzanne_xxhi main path did not launch {k}")
    if any(counted[k] for k in ("trace", "shade", "chunked_closest", "chunked_any")):
        raise AssertionError(f"the suzanne_xxhi main path left the BVH route: {counted}")
    save_png("suzanne_xxhi", image, counts, warm)
    split("suzanne_xxhi_bvh", xx_ds, sky, cam, counts, card)
    del xx_ds, image

    # suzanne_hi through both routes at 256^2: the same image but for flips
    hi = load_scene(os.path.join(ROOT, "assets", "scenes", "suzanne_hi.toml"))
    hi_cam = camera_pytree(hi.camera, dev)
    via_bvh = image_of(build_device_scene(hi, dev, with_bvh=True), sky, hi_cam, ROUTES_SIZE, ROUTES_SPP)
    via_chunks = image_of(build_device_scene(hi, dev), sky, hi_cam, ROUTES_SIZE, ROUTES_SPP)
    diff = via_bvh - via_chunks
    flipped = np.abs(diff).max(-1) > FLIP_ABS
    keep = ~flipped
    rel = float(np.sqrt((diff[keep] ** 2).mean()) / np.sqrt((via_chunks[keep] ** 2).mean()))
    log("bvh_image", scene="suzanne_hi", size=ROUTES_SIZE, spp=ROUTES_SPP,
        flipped=f"{flipped.mean():.5f}", rel_rmse_unflipped=f"{rel:.3e}",
        pixels_equal=f"{float((diff == 0).all(-1).mean()):.5f}",
        image_mean_rel=f"{abs(float(via_bvh.mean()) / float(via_chunks.mean()) - 1):.3e}")
    if not (flipped.mean() < FLIPPED_MAX and rel < UNFLIPPED_REL_RMSE_MAX):
        raise AssertionError("suzanne_hi through the BVH route is not the chunked route's image")

    crossover(sky_host, sky, card, dev)
    log("bvh_phase", seconds=f"{time.perf_counter() - phase_start:.1f}")
    return counted


# Phase 13: BENCH_MODE=sync's samples a call by scene (bench.py:116-117)
# and the timed calls after the warm-up one.
SYNC_ROUNDS = {"house": 32, "suzanne_hi": 4}
SYNC_CALLS = 3
SYNC_SIZE, SYNC_CHECK_ROUNDS = 256, 2
# Phase 14: house at SPLIT_SIZE^2; then 2048^2 turns of this budget.
SPLIT_SIZE = 256
SPLIT_BUDGET = 512
# Phase 15: the viewer's pseudo-terminal and its watch window.
VIEW_ROWS, VIEW_COLS = 40, 120
VIEW_WATCH_SECONDS = 10.0
VIEW_STATUS = re.compile(rb"(\d+)x(\d+) spp=(\d+) env=\d+ dev=(\d)")
# Phase 15: the viewer frame-rate tool (viewer/fps.py) by scene, its
# resolution and frames, and the keys of its lines (scripts/viewer_fps.py's).
FPS_SCENES = ("default", "house")
FPS_ARGS = ("256", "144", "60")
FPS_KEYS = {"metric", "scene", "resolution", "platform", "value", "unit", "ms_per_frame"}


def flip_criteria(got, ref):
    """(flipped share, unflipped relative RMSE) of two mean images, the
    anchors' criteria (tests/test_reference_estimator.py)."""
    diff = got - ref
    flipped = np.abs(diff).max(-1) > FLIP_ABS
    keep = ~flipped
    rel = float(np.sqrt((diff[keep] ** 2).mean()) / np.sqrt((ref[keep] ** 2).mean()))
    return float(flipped.mean()), rel


def timed_sync(label, ds, env, cam, card, rounds, dev):
    """A warm-up render_spp_sync call, then SYNC_CALLS timed calls at
    SIZE^2 carrying the counts, counted as bench.py counts; returns
    (launches of the timed calls, Mrays/s)."""
    res = (SIZE, SIZE)
    _, counts = render_spp_sync(ds, env, cam, np.zeros(res, np.uint32), res, rounds, BOUNCES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    total_rays, total_spp = 0, 0.0
    start = time.perf_counter()
    for _ in range(SYNC_CALLS):
        _, counts_dev, stats = render_spp_sync(ds, env, cam, counts, res, rounds, BOUNCES,
                                               with_stats=True)
        counts = counts + counts_dev
        total_rays += int(stats["closest_rays"] + stats["shadow_rays"])  # synchronizes
        total_spp += float(counts_dev.float().mean())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counted = launches()
    rate = total_rays / elapsed / 1e6
    log("sync", scene=label, size=SIZE, bounces=BOUNCES, rounds=rounds, calls=SYNC_CALLS,
        seconds=f"{elapsed:.3f}", mrays_per_s=f"{rate:.2f}",
        rays_per_px_spp=f"{total_rays / (SIZE * SIZE * max(total_spp, 1e-9)):.3f}",
        spp=f"{total_spp:.2f}", **{f"{k}_launches": v for k, v in counted.items() if v},
        peak_allocated_mib=f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f}", card=repr(card))
    if total_spp != SYNC_CALLS * rounds or int(counts.min()) != (SYNC_CALLS + 1) * rounds:
        raise AssertionError(f"{label}: sync calls did not complete {rounds} samples a pixel each")
    return counted, rate


def sync_phase(sky, card, dev):
    """Phase 13: bounce-synchronized rounds."""
    phase_start = time.perf_counter()
    ds, _, cam = scene_setup("house", dev, sky)
    res = (SYNC_SIZE, SYNC_SIZE)
    img, counts = render_spp_sync(ds, sky, cam, 0, res, SYNC_CHECK_ROUNDS, BOUNCES)
    ref = render_wavefront(ds, sky, cam, 0, res, SYNC_CHECK_ROUNDS, BOUNCES)
    bit_equal = float((img.view(torch.int32) == ref.view(torch.int32)).double().mean())
    flipped, rel = flip_criteria(img.cpu().numpy() / SYNC_CHECK_ROUNDS,
                                 ref.cpu().numpy() / SYNC_CHECK_ROUNDS)
    log("sync", scene="house", size=SYNC_SIZE, rounds=SYNC_CHECK_ROUNDS, compare="render_wavefront",
        counts_equal=bool((counts == SYNC_CHECK_ROUNDS).all()), bit_equal_share=f"{bit_equal:.6f}",
        flipped=f"{flipped:.5f}", rel_rmse_unflipped=f"{rel:.3e}")
    if not bool((counts == SYNC_CHECK_ROUNDS).all()):
        raise AssertionError("render_spp_sync did not complete its rounds on every pixel")
    if not (flipped < FLIPPED_MAX and rel < UNFLIPPED_REL_RMSE_MAX):
        raise AssertionError("render_spp_sync is not render_wavefront's image within the anchors' criteria")

    for name, rounds in SYNC_ROUNDS.items():
        if name != "house":
            ds, _, cam = scene_setup(name, dev, sky)
        counted, rate = timed_sync(name, ds, sky, cam, card, rounds, dev)
        free, _, _, _ = timed_main(f"{name}_freerun_beside_sync", ds, sky, cam, card, 1, dev)
        iterations = SYNC_CALLS * rounds * BOUNCES
        kernels = ("trace", "shade") if name == "house" else ("env_draw", "chunked_closest",
                                                               "chunked_any", "big_shade")
        if any(counted[k] != iterations for k in kernels) or any(
                v for k, v in counted.items() if k not in kernels):
            raise AssertionError(f"{name}: the sync calls launched {counted}, expected "
                                 f"{iterations} of each of {kernels}")
        log("sync", scene=name, sync_mrays_per_s=f"{rate:.2f}",
            freerun_mrays_per_s=f"{free['mrays_per_s']:.2f}",
            sync_over_freerun=f"{rate / free['mrays_per_s']:.4f}", card=repr(card))
        del ds
    log("sync_phase", seconds=f"{time.perf_counter() - phase_start:.1f}")


def renderer_mrays(renderer, dev):
    """One timed step_freerun(SPLIT_BUDGET) call: (Mrays/s, MiB the call
    added at its peak to what was allocated before it)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    renderer.step_freerun(SPLIT_BUDGET)
    rays = renderer.last_stats["closest_rays"] + renderer.last_stats["shadow_rays"]
    torch.cuda.synchronize()
    return (rays / (time.perf_counter() - start) / 1e6,
            (torch.cuda.max_memory_allocated(dev) - held) / 2**20)


def multi_device_phase(sky_host, sky, card, dev):
    """Phase 14: the multi-device split on slots of the one card."""
    phase_start = time.perf_counter()
    dryrun(4, device=dev)
    ds, _, cam = scene_setup("house", dev, sky)
    res = (SPLIT_SIZE, SPLIT_SIZE)
    budget = 16
    ref, ref_counts = render_freerun(ds, sky, cam, 0, res, budget, BOUNCES)
    for n in (2, 4):
        reset_launches()
        img, counts, _ = render_freerun_sharded(ds, sky, cam, 0, make_mesh(n, tile=n, devices=[dev] * n),
                                                res, budget, BOUNCES)
        counted = launches()
        differ = int((img.view(torch.int32) != ref.view(torch.int32)).sum())
        counts_differ = int((counts != ref_counts).sum())
        log("split", mesh=f"tile:{n}", size=SPLIT_SIZE, budget=budget, values_differ=differ,
            counts_differ=counts_differ, trace_launches=counted["trace"],
            shade_launches=counted["shade"])
        if differ or counts_differ:
            raise AssertionError(f"the tile-only split over {n} slots is not the unsharded render")
        if counted["trace"] != n * (budget + BOUNCES - 1):
            raise AssertionError(f"the tile-only split launched TRACE {counted['trace']} times")

    exact_budget = 4
    for spec, tile in (("dp:2", 1), ("tile:2,dp:2", 2)):
        mesh = make_mesh(2 * tile, tile=tile, devices=[dev] * (2 * tile))
        reset_launches()
        img, counts, shard_counts = render_freerun_sharded(ds, sky, cam, 0, mesh, res, exact_budget, 1)
        counted = launches()
        same = render_wavefront(ds, sky, cam, 0, res, exact_budget * 2, 1)
        close = bool(torch.allclose(img, same, rtol=2e-5, atol=2e-5))
        exact = bool((counts == exact_budget * 2).all() and (shard_counts == exact_budget).all())
        log("split", mesh=spec, size=SPLIT_SIZE, budget=exact_budget, max_bounces=1,
            counts_exact=exact, allclose_2e5=close,
            max_abs_diff=f"{float((img - same).abs().max()):.3e}",
            **{f"{k}_launches": v for k, v in counted.items() if v})
        if not (exact and close):
            raise AssertionError(f"{spec}: counts or image differ from the unsharded render")
    mesh = make_mesh(2, devices=[dev] * 2)
    reset_launches()
    summed = render_spp_sharded(ds, sky, cam, 0, mesh, res, BOUNCES)
    counted = launches()
    seq = render_sample(ds, sky, cam, 0, res, BOUNCES) + render_sample(ds, sky, cam, 1, res, BOUNCES)
    close = bool(torch.allclose(summed, seq, rtol=1e-4, atol=1e-4))
    log("split", mesh="dp:2", path="render_spp_sharded", size=SPLIT_SIZE, allclose_1e4=close,
        max_abs_diff=f"{float((summed - seq).abs().max()):.3e}",
        **{f"{k}_launches": v for k, v in counted.items() if v})
    if not close or counted["closest"] != 2 * BOUNCES or counted["any"] != 2 * BOUNCES:
        raise AssertionError(f"render_spp_sharded on dp:2: close={close}, launches {counted}")
    del ds

    # 2048^2: ShardedRenderer dp:1 against Renderer.step_freerun, in turns
    house = load_scene(os.path.join(ROOT, "assets", "scenes", "house.toml"))

    def renderer():
        r = Renderer(house, SIZE, SIZE, environments=EnvironmentMaps([sky_host]), max_bounces=BOUNCES,
                     device=dev)
        r.step_freerun(16)  # warm-up: uploads the environment
        return r

    plain, sharded = renderer(), ShardedRenderer.wrap(renderer(), "dp:1")
    sharded.step_freerun(16)
    runs = {"renderer": [], "dp1": []}
    for kind in ("renderer", "dp1", "dp1", "renderer"):
        runs[kind].append(renderer_mrays(plain if kind == "renderer" else sharded, dev))
    ratio = sum(r for r, _ in runs["dp1"]) / sum(r for r, _ in runs["renderer"])
    log("split", scene="house", size=SIZE, bounces=BOUNCES, budget=SPLIT_BUDGET,
        renderer_mrays_per_s=",".join(f"{r:.2f}" for r, _ in runs["renderer"]),
        dp1_mrays_per_s=",".join(f"{r:.2f}" for r, _ in runs["dp1"]),
        dp1_over_renderer=f"{ratio:.4f}",
        renderer_call_peak_mib=",".join(f"{m:.1f}" for _, m in runs["renderer"]),
        dp1_call_peak_mib=",".join(f"{m:.1f}" for _, m in runs["dp1"]), card=repr(card))
    del plain, sharded
    torch.cuda.empty_cache()
    two = ShardedRenderer(renderer(), make_mesh(2, devices=[dev] * 2))
    two.step_freerun(16)
    reset_launches()
    rate, peak = renderer_mrays(two, dev)
    counted = launches()
    log("split", scene="house", mesh="dp:2 on one card", size=SIZE, bounces=BOUNCES,
        budget=SPLIT_BUDGET, mrays_per_s=f"{rate:.2f}", call_peak_mib=f"{peak:.1f}",
        peak_allocated_mib=f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f}",
        **{f"{k}_launches": v for k, v in counted.items() if v}, card=repr(card))
    if counted["trace"] != 2 * (SPLIT_BUDGET + BOUNCES - 1):
        raise AssertionError(f"dp:2 launched TRACE {counted['trace']} times")
    del two
    log("multi_device_phase", seconds=f"{time.perf_counter() - phase_start:.1f}")


def viewer_phase(card, dev):
    """Phase 15: the CLI's viewer on a pseudo-terminal, on the card."""
    phase_start = time.perf_counter()
    master, slave = pty.openpty()
    fcntl.ioctl(master, termios.TIOCSWINSZ, struct.pack("HHHH", VIEW_ROWS, VIEW_COLS, 0, 0))
    cmd = [sys.executable, "-m", "rsoderh_raytracing_tpu_torch", "--scene",
           os.path.join(ROOT, "assets", "scenes", "house.toml"), "--view", "--resolution", "256x144"]
    if dev.type != "cuda":
        cmd += ["--device", dev.type]
    proc = subprocess.Popen(cmd, stdin=slave, stdout=slave, stderr=slave, cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT), close_fds=True)
    os.close(slave)
    out, frames, scanned = bytearray(), [], 0

    def read(until, timeout, exits=False):
        """Read until `until()` holds (or, with `exits`, the viewer has
        exited: it blocks on a full terminal otherwise); frames gets
        (time, w, h, spp, dev)."""
        nonlocal scanned
        end = time.monotonic() + timeout
        while not until():
            if time.monotonic() > end or (proc.poll() is not None and not exits):
                raise AssertionError(f"viewer: timed out or exited (rc {proc.poll()}): "
                                     f"{bytes(out[-600:])!r}")
            if select.select([master], [], [], 0.1)[0]:
                try:
                    out.extend(os.read(master, 1 << 20))
                except OSError:  # EIO: the viewer has closed the terminal
                    proc.wait(timeout=10)
                    continue
                now = time.monotonic()
                for m in VIEW_STATUS.finditer(out, scanned):
                    frames.append((now, *(int(g) for g in m.groups())))
                    scanned = m.end()

    def key(k):
        os.write(master, k)
        return len(frames), len(out)

    try:
        read(lambda: any(f[4] == 1 for f in frames), 300)
        t_first = frames[-1][0]
        read(lambda: time.monotonic() > t_first + VIEW_WATCH_SECONDS, 60)
        watched = [f for f in frames if t_first <= f[0] <= t_first + VIEW_WATCH_SECONDS and f[4] == 1]
        if len(watched) < 2:
            raise AssertionError(f"viewer: {len(watched)} frames in {VIEW_WATCH_SECONDS} s")
        fps = (len(watched) - 1) / (watched[-1][0] - watched[0][0])
        _, at = key(b"p")
        read(lambda: b"for use with --state" in out[at:], 30)
        n, _ = key(b" ")
        read(lambda: len(frames) > n, 30)
        for k, dev_index in ((b"2", 2), (b"3", 3), (b"1", 1)):
            n, _ = key(k)
            read(lambda: any(f[4] == dev_index for f in frames[n:]), 30)
        key(b"q")
        read(lambda: proc.poll() is not None, 30, exits=True)
        rc = proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        os.close(master)
    last = [f for f in frames if f[4] == 1][-1]
    log("viewer", scene="house", requested="256x144", pty=f"{VIEW_COLS}x{VIEW_ROWS}",
        fitted=f"{last[1]}x{last[2]}", frames_per_s=f"{fps:.2f}", watched_frames=len(watched),
        last_spp=last[3], dev_views=sorted({f[4] for f in frames}), rc=rc,
        seconds=f"{time.perf_counter() - phase_start:.1f}", card=repr(card))
    if rc != 0 or sorted({f[4] for f in frames}) != [1, 2, 3] or last[3] < 1:
        raise AssertionError(f"viewer: rc {rc}, dev views {sorted({f[4] for f in frames})}, "
                             f"last spp {last[3]}")
    viewer_fps(card, dev)


def viewer_fps(card, dev):
    """python -m rsoderh_raytracing_tpu_torch.viewer.fps on each of
    FPS_SCENES: one JSON line a scenario with the reference script's keys,
    platform gpu and frames/s above 0."""
    for scene in FPS_SCENES:
        start = time.perf_counter()
        cmd = [sys.executable, "-m", "rsoderh_raytracing_tpu_torch.viewer.fps", scene, *FPS_ARGS]
        if dev.type != "cuda":
            cmd += ["--device", dev.type]
        out = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                             text=True, timeout=600)
        records = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
        got = {r.get("metric"): r for r in records}
        for r in records:
            log("viewer_fps", scene=r.get("scene"), scenario=r.get("metric"), resolution=r.get("resolution"),
                frames=FPS_ARGS[2], platform=r.get("platform"), frames_per_s=r.get("value"),
                ms_per_frame=r.get("ms_per_frame"), device=repr(r.get("device")), card=repr(card))
        log("viewer_fps", scene=scene, rc=out.returncode, seconds=f"{time.perf_counter() - start:.1f}")
        want = {"viewer_fps_converge", "viewer_fps_moving"}
        if (out.returncode != 0 or set(got) != want
                or any(not FPS_KEYS <= set(r) or r["platform"] != dev.type.replace("cuda", "gpu")
                       or not r["value"] > 0 for r in records)):
            raise AssertionError(f"viewer.fps on {scene}: rc {out.returncode}, {out.stdout[-600:]!r} "
                                 f"{out.stderr[-1200:]!r}")


# Phase 16: the chunk orders (profiling.CLUSTER_ORDERS), the scenes of the
# speed lines, suzanne_xxhi's raised ceiling and its short call's budget.
CLUSTER_PARITY_ORDERS = ("bvh", "treelet")
CLUSTER_SCENES = ("suzanne_hi", "suzanne_xhi")
CLUSTER_IMAGE_BUDGET = 32
CLUSTER_SPEED_BUDGET = 32
RAISED_TRIS = "1048576"
RAISED_BUDGET = 16


def chunked_parity(label, lanes, state, max_err):
    """ENV_DRAW, CHUNKED_CLOSEST, CHUNKED_ANY and BIG_SHADE on a loop state
    against their plain versions: each by kernel_parity, then
    CHUNKED_CLOSEST's t, type and index and CHUNKED_ANY's occlusion
    bitwise on every lane."""
    for key in BIG_KERNELS:
        kfn, pfn = KERNELS[key]
        args = state[key]
        got, ref = kfn(*args), pfn(*args)
        kernel_parity(key, label, args, lanes, max_err, ref)
        if key in ("env_draw", "big_shade"):
            continue
        got, ref = (got, ref) if key == "closest" else ((got,), (ref,))
        differ = sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, ref))
        log("parity", kernel=f"{BIG_KERNELS[key]}:{label}", lanes=lanes, lanes_differ_bitwise=differ)
        if differ:
            raise AssertionError(f"{BIG_KERNELS[key]} is not bitwise its plain version on {label}")


def freerun_image(ds, env, cam, size, budget):
    """(mean image, counts) of one free-run call at size^2 from counts 0."""
    img, counts = render_freerun(ds, env, cam, 0, (size, size), budget, BOUNCES)
    return (img / counts.clamp_min(1).unsqueeze(-1).to(img.dtype)).cpu().numpy(), counts.cpu().numpy()


def cluster_phase(sky, card, dev, max_err, bvh_mrays):
    """Phase 16: the chunk orders and the raised ceiling."""
    phase_start = time.perf_counter()
    hi = load_scene(os.path.join(ROOT, "assets", "scenes", "suzanne_hi.toml"))
    cam = camera_pytree(hi.camera, dev)
    base = None
    for order in CLUSTER_ORDERS:
        with chunk_order(order):
            ds = build_device_scene(hi, dev)
        valid = ds.tri_valid.reshape(-1, TRI_CHUNK)
        if order in CLUSTER_PARITY_ORDERS:
            chunked_parity(f"suzanne_hi_{order}", 256 * 256, loop_state(ds, sky, cam, 256, 0, 3), max_err)
            chunked_parity(f"suzanne_hi_{order}", SIZE * SIZE,
                           loop_state(ds, sky, cam, SIZE, 0, 0, kernel_iterations=2), max_err)
        # the 256^2 image against Morton's: storage order only
        img, counts = freerun_image(ds, sky, cam, ROUTES_SIZE, CLUSTER_IMAGE_BUDGET)
        if base is None:
            base = (img, counts)
        flipped, rel = flip_criteria(img, base[0])
        counts_equal = float((counts == base[1]).mean())
        log("cluster_image", scene="suzanne_hi", order=order, size=ROUTES_SIZE,
            budget=CLUSTER_IMAGE_BUDGET, chunks=ds.chunks.count,
            pad_rows=int((~ds.tri_valid).sum()), interleaved_pads=int((~valid[:-1]).sum()),
            counts_equal=f"{counts_equal:.6f}",
            bit_equal_share=f"{float((img.view(np.uint32) == base[0].view(np.uint32)).mean()):.6f}",
            flipped=f"{flipped:.5f}", rel_rmse_unflipped=f"{rel:.3e}")
        if not (counts_equal >= 0.999 and flipped < FLIPPED_MAX and rel < UNFLIPPED_REL_RMSE_MAX):
            raise AssertionError(f"suzanne_hi in the {order} order is not Morton's image")
        del ds

    parity_s = time.perf_counter() - phase_start

    # Mrays/s, pairs and kernel ms in each order (profiling --path cluster's
    # lines, without the cull's bound); suzanne_xhi under the raised
    # ceiling, which its treelet order (350,848 lanes) passes by default
    start = time.perf_counter()
    for name in CLUSTER_SCENES:
        with knob_env({"RT_MAX_CHUNKED_TRIS": RAISED_TRIS if name == "suzanne_xhi" else None}):
            for order in CLUSTER_ORDERS:
                got = cluster_report(name, order, dev, card, sky, bounds=False,
                                     budget=CLUSTER_SPEED_BUDGET)
                if got is None or not all(int(k) > 0 for k in got["launches"].split("/")):
                    raise AssertionError(f"{name} in the {order} order left the chunked route")
    speed_s = time.perf_counter() - start

    # suzanne_xxhi on the chunked route under the raised ceiling
    start = time.perf_counter()
    xx = load_scene(os.path.join(ROOT, "assets", "scenes", "suzanne_xxhi.toml"))
    xx_cam = camera_pytree(xx.camera, dev)
    with knob_env({"RT_MAX_CHUNKED_TRIS": RAISED_TRIS}):
        start = time.perf_counter()
        ds = build_device_scene(xx, dev, with_bvh=False)
        build_s = time.perf_counter() - start
        if route(ds) != CHUNKED:
            raise AssertionError("RT_MAX_CHUNKED_TRIS=1048576 did not route suzanne_xxhi to the chunked route")
        counts_xx = (ds.sph_radius.shape[0], ds.pln_valid.shape[0], ds.tri_valid.shape[0])
        # past CUDA_BVH_ABOVE_LANES 'auto' walks the BVH under any ceiling
        if not auto_bvh(*counts_xx, dev):
            raise AssertionError("under the raised ceiling 'auto' does not route suzanne_xxhi to the BVH")
    mirror, built = ci.chunked_shared_bytes_of(ds), ci.chunked_shared_bytes(ds)
    log("cluster_ceiling", scene="suzanne_xxhi", max_chunked_tris=RAISED_TRIS, chunks=ds.chunks.count,
        seconds=f"{build_s:.3f}", shared_bytes=built, shared_mirror=mirror,
        window_mib=f"{ds.chunks.windows.numel() * 4 / 2**20:.1f}")
    if mirror != built:
        raise AssertionError(f"the shared-memory mirror says {mirror} bytes, the kernels {built}")
    chunked_parity("suzanne_xxhi", 256 * 256, loop_state(ds, sky, xx_cam, 256, 0, 0, kernel_iterations=2),
                   max_err)
    state = loop_state(ds, sky, xx_cam, SIZE, 0, 0, kernel_iterations=2)
    log("timing", scene="suzanne_xxhi", max_chunked_tris=RAISED_TRIS, lanes=SIZE * SIZE,
        **{f"{name}_ms": f"{time_ms(lambda: KERNELS[key][0](*state[key]), 3):.4f}"
           for key, name in BIG_KERNELS.items()}, card=repr(card))
    del state
    counted, image, counts, warm = timed_main("suzanne_xxhi_chunked", ds, sky, xx_cam, card, 1, dev,
                                              budget=RAISED_BUDGET)
    if not all(counted[k] for k in BIG_KERNELS.values()) or counted["bvh_closest"] or counted["bvh_any"]:
        raise AssertionError(f"the raised-ceiling suzanne_xxhi run left the chunked route: {counted}")
    log("cluster_ceiling", scene="suzanne_xxhi", chunked_mrays_per_s=f"{counted['mrays_per_s']:.2f}",
        bvh_mrays_per_s=f"{bvh_mrays:.2f}", chunked_over_bvh=f"{counted['mrays_per_s'] / bvh_mrays:.4f}",
        card=repr(card))
    del ds, image
    if not auto_bvh(*counts_xx, dev):
        raise AssertionError("with the default ceiling 'auto' does not route suzanne_xxhi to the BVH")
    log("cluster_phase", seconds=f"{time.perf_counter() - phase_start:.1f}", parity_s=f"{parity_s:.1f}",
        speed_s=f"{speed_s:.1f}", ceiling_s=f"{time.perf_counter() - start:.1f}")


# Phase 17: every scene. The tiled scenes' image checks (size, free-run
# budget), the BVH route's speed call on house_tiled16, house_tiled64's
# 2048^2 calls, the union-box caps of the chunked parity, the knobs'
# scenes (intersector, free-run budget, size of the CPU image under
# RT_DISABLE_PALLAS) and RT_DEBUG_NANS's 2048^2 calls.
EVERY_SIZE, EVERY_BUDGET = 256, 8
TILED_BVH_BUDGET = 64
TILED64_BUDGET = 16
UNION_CAPS = (1, 3)
KNOB_SCENES = {"house": (False, 8, 128), "suzanne_hi": (False, 2, 64), "suzanne_xxhi": ("auto", 2, 64)}
NANS_MAIN_BUDGET = 64


def image_check(label, got, ref):
    """Log and assert the flip-aware criteria of two (mean image, counts)
    pairs of the same samples."""
    flipped, rel = flip_criteria(got[0], ref[0])
    counts_equal = float((got[1] == ref[1]).mean())
    log("every_image", compare=label, flipped=f"{flipped:.5f}", rel_rmse_unflipped=f"{rel:.3e}",
        counts_equal=f"{counts_equal:.6f}",
        bit_equal_share=f"{float((got[0].view(np.uint32) == ref[0].view(np.uint32)).mean()):.6f}")
    if not (counts_equal >= 0.999 and flipped < FLIPPED_MAX and rel < UNFLIPPED_REL_RMSE_MAX):
        raise AssertionError(f"{label}: the images fail the flip-aware criteria")


def no_launches(label):
    counted = launches()
    if any(counted.values()):
        raise AssertionError(f"{label} launched a kernel: {counted}")


def freerun_rate(ds, env, cam, budget, dev):
    """(seconds, Mrays/s, peak MiB) of one free-run call at SIZE^2 from
    counts 0."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    _, counts, stats = render_freerun(ds, env, cam, 0, (SIZE, SIZE), budget, BOUNCES, with_stats=True)
    rays = int(stats["closest_rays"] + stats["shadow_rays"])  # synchronizes
    seconds = time.perf_counter() - start
    if int(counts.min()) <= 0:
        raise AssertionError("a free-run call left pixels without samples")
    return seconds, rays / seconds / 1e6, torch.cuda.max_memory_allocated(dev) / 2**20


def every_scene_phase(sky, card, dev, max_err, paths):
    """Phase 17: the small route past the unroll budget, staged and read
    from global memory, the chunked kernels' union-box restaging,
    RT_DISABLE_PALLAS and RT_DEBUG_NANS. Adds house_tiled16's and
    house_tiled64's TRACE and SHADE launches to `paths`."""
    phase_start = time.perf_counter()
    n_pixels = SIZE * SIZE
    with knob_env({"RT_DISABLE_PALLAS": None, "RT_DEBUG_NANS": None}):
        # house_tiled16: the small route past the budget
        start = time.perf_counter()
        ds, env, cam = scene_setup("house_tiled16", dev, sky)
        counts4 = (ds.sph_radius.shape[0], ds.pln_valid.shape[0], ds.tri_valid.shape[0],
                   ds.mat_roughness.shape[0])
        card_max = ci.sweep_max_table_bytes()
        log("every_scene", scene="house_tiled16", route=route(ds), lanes=ds.num_lanes, counts=counts4,
            sweep_rows=ds.sweep_rows, table_bytes=ds.trace_table.numel() * 4,
            mirror_bytes=sweep_shared_bytes(*counts4), mirror_max=SWEEP_MAX_SHARED, card_max=card_max)
        if route(ds) != SMALL or ds.num_lanes != 328 or card_max != SWEEP_MAX_SHARED:
            raise AssertionError("house_tiled16 is not on the small route, or the mirror is not the card's")
        small = loop_state(ds, env, cam, 256, 0, 3)
        trace_parity("house_tiled16", 256 * 256, small["trace"], max_err)
        keep_worst(max_err, "shade", check_parity(
            "shade:house_tiled16", 256 * 256, shade_outputs(cw.shade_call(*small["shade"])),
            shade_outputs(cw.shade_plain(*small["shade"])), cw.SHADE_INT_NAMES))
        sweep_parity(small["trace"], 256 * 256, max_err)
        for size in (256, SIZE):
            for bounce, state in capture_scan(ds, env, cam, size, BOUNCES).items():
                scan_parity(f"house_tiled16_scan{bounce}", size * size, ds, state, max_err)
        del small
        counted, image, counts, warm = timed_main("house_tiled16", ds, env, cam, card, 1, dev)
        others = {k: counted[k] for k in launches() if k not in ("trace", "shade")}
        if not counted["trace"] == counted["shade"] == counted["iterations"] or any(others.values()):
            raise AssertionError(f"the house_tiled16 main path is not TRACE and SHADE alone: {counted}")
        paths["trace"]["house_tiled16"] = counted["trace"]
        paths["shade"]["house_tiled16"] = counted["shade"]
        small_mrays = counted["mrays_per_s"]
        save_png("house_tiled16", image, counts, warm)
        del image
        main_args = loop_state(ds, env, cam, SIZE, 0, 0, kernel_iterations=2)
        trace_parity("house_tiled16", n_pixels, main_args["trace"], max_err)
        keep_worst(max_err, "shade", check_parity(
            "shade:house_tiled16", n_pixels, shade_outputs(cw.shade_call(*main_args["shade"])),
            shade_outputs(cw.shade_plain(*main_args["shade"])), cw.SHADE_INT_NAMES))
        sweep_parity(main_args["trace"], n_pixels, max_err)
        # TRACE and SHADE ms with the bounds of phase 3, on this table
        calls, shadow_rays = sweep_calls(main_args["trace"])
        trace_ops = n_pixels * sweep_ops(ds) + first_hit_ops(ds, shadow_rays)
        for name, kfn, n_bytes, n_ops in (
            ("trace", cw.trace_call,
             n_pixels * (4 * len(cw.TRACE_CARRY_IN) + 16 + 16 + 4 * (len(cw.TRACE_OUT_NAMES) - 1) + 16),
             trace_ops),
            ("shade", cw.shade_call, n_pixels * 4 * (len(cw.SHADE_IN) + 4 + len(cw.SHADE_OUT_NAMES)), 0),
        ):
            args = main_args[name]
            ms = (time_ms(lambda: kfn(*args), 10) + time_ms(lambda: kfn(*args), 10)) / 2
            bound = bound_ms(n_bytes, n_ops)
            log("timing", kernel=name, scene="house_tiled16", lanes=n_pixels, ms=f"{ms:.4f}",
                bound_ms=f"{bound[0]:.4f}", bound_by=bound[1], ops_per_lane=f"{n_ops / n_pixels:.1f}",
                card=repr(card))
        del calls, shadow_rays, main_args
        hi_img = freerun_image(ds, env, cam, EVERY_SIZE, EVERY_BUDGET)
        bvh_ds = build_device_scene(named_scene("house_tiled16"), dev, with_bvh=True)
        image_check("house_tiled16_small_vs_bvh", hi_img, freerun_image(bvh_ds, env, cam, EVERY_SIZE,
                                                                        EVERY_BUDGET))
        bvh_counted = timed_main("house_tiled16_bvh", bvh_ds, env, cam, card, 1, dev,
                                 budget=TILED_BVH_BUDGET)[0]
        log("every_scene", scene="house_tiled16", small_mrays_per_s=f"{small_mrays:.2f}",
            bvh_mrays_per_s=f"{bvh_counted['mrays_per_s']:.2f}",
            small_over_bvh=f"{small_mrays / bvh_counted['mrays_per_s']:.4f}",
            seconds=f"{time.perf_counter() - start:.1f}", card=repr(card))
        del ds, bvh_ds

        # house_tiled64 under intersector='sweep': the small route, its
        # table read from global memory
        start = time.perf_counter()
        scene64 = named_scene("house_tiled64")
        cam64 = camera_pytree(scene64.camera, dev)
        big = build_device_scene(scene64, dev, with_bvh=False)
        counts64 = (big.sph_radius.shape[0], big.pln_valid.shape[0], big.tri_valid.shape[0],
                    big.mat_roughness.shape[0])
        table64 = big.trace_table.numel() * 4
        log("every_scene", scene="house_tiled64", route=route(big), lanes=big.num_lanes, counts=counts64,
            table_bytes=table64, staged=table64 <= card_max)
        if route(big) != SMALL or table64 <= SWEEP_MAX_SHARED or not auto_bvh(*counts64[:3], dev,
                                                                            counts64[3]):
            raise AssertionError("house_tiled64 is not small under 'sweep' and BVH under 'auto'")
        state = loop_state(big, env, cam64, 256, 0, 3)
        trace_parity("house_tiled64", 256 * 256, state["trace"], max_err)
        keep_worst(max_err, "shade", check_parity(
            "shade:house_tiled64", 256 * 256, shade_outputs(cw.shade_call(*state["shade"])),
            shade_outputs(cw.shade_plain(*state["shade"])), cw.SHADE_INT_NAMES))
        sweep_parity(state["trace"], 256 * 256, max_err)
        for bounce, scan_state in capture_scan(big, env, cam64, 256, BOUNCES).items():
            scan_parity(f"house_tiled64_scan{bounce}", 256 * 256, big, scan_state, max_err)
        del state
        counted, image, counts, warm = timed_main("house_tiled64", big, env, cam64, card, 1, dev,
                                                  budget=TILED64_BUDGET)
        others = {k: counted[k] for k in launches() if k not in ("trace", "shade")}
        if not counted["trace"] == counted["shade"] == counted["iterations"] or any(others.values()):
            raise AssertionError(f"the house_tiled64 main path is not TRACE and SHADE alone: {counted}")
        paths["trace"]["house_tiled64"] = counted["trace"]
        paths["shade"]["house_tiled64"] = counted["shade"]
        big_mrays = counted["mrays_per_s"]
        save_png("house_tiled64", image, counts, warm)
        del image
        main_args = loop_state(big, env, cam64, SIZE, 0, 0, kernel_iterations=2)
        calls, shadow_rays = sweep_calls(main_args["trace"])
        trace_ops = n_pixels * sweep_ops(big) + first_hit_ops(big, shadow_rays)
        n_bytes = n_pixels * (4 * len(cw.TRACE_CARRY_IN) + 16 + 16 + 4 * (len(cw.TRACE_OUT_NAMES) - 1) + 16)
        args = main_args["trace"]
        ms = (time_ms(lambda: cw.trace_call(*args), 3) + time_ms(lambda: cw.trace_call(*args), 3)) / 2
        bound = bound_ms(n_bytes + table64, trace_ops)
        log("timing", kernel="trace", scene="house_tiled64", lanes=n_pixels, ms=f"{ms:.4f}",
            bound_ms=f"{bound[0]:.4f}", bound_by=bound[1], ops_per_lane=f"{trace_ops / n_pixels:.1f}",
            card=repr(card))
        del calls, shadow_rays, main_args, args
        big_img = freerun_image(big, env, cam64, EVERY_SIZE, EVERY_BUDGET)
        bvh_ds = build_device_scene(scene64, dev, with_bvh="auto")
        if route(bvh_ds) != BVH:
            raise AssertionError("'auto' did not walk house_tiled64's BVH on the card")
        image_check("house_tiled64_small_vs_bvh", big_img,
                    freerun_image(bvh_ds, env, cam64, EVERY_SIZE, EVERY_BUDGET))
        bvh_counted = timed_main("house_tiled64_bvh", bvh_ds, env, cam64, card, 1, dev,
                                 budget=TILED64_BUDGET)[0]
        log("every_scene", scene="house_tiled64", small_mrays_per_s=f"{big_mrays:.2f}",
            bvh_mrays_per_s=f"{bvh_counted['mrays_per_s']:.2f}",
            small_over_bvh=f"{big_mrays / bvh_counted['mrays_per_s']:.4f}",
            seconds=f"{time.perf_counter() - start:.1f}", card=repr(card))
        del big, bvh_ds

        # the chunked kernels past the union boxes a block holds: a cap of
        # one or three batches restages them as the walk goes on
        start = time.perf_counter()
        hi = named_scene("suzanne_hi")
        hi_ds = build_device_scene(hi, dev)
        state = loop_state(hi_ds, env, camera_pytree(hi.camera, dev), 256, 0, 3)
        for cap in UNION_CAPS:
            got = ci.chunked_closest_call(*state["closest"], union_batches=cap)
            ref = intersect.chunked_closest_plain(*state["closest"])
            differ = sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, ref))
            occ = ci.chunked_any_call(*state["occlusion"], union_batches=cap)
            differ += int((occ != intersect.chunked_any_plain(*state["occlusion"])).sum())
            log("parity", kernel="chunked_closest+chunked_any:suzanne_hi", lanes=256 * 256,
                union_batches=cap, chunks=hi_ds.chunks.count, lanes_differ_bitwise=differ)
            if differ:
                raise AssertionError(f"the chunked kernels under a union cap of {cap} disagree")
        log("every_scene", union_caps=repr(UNION_CAPS), seconds=f"{time.perf_counter() - start:.1f}")
        del hi_ds, state

        # RT_DISABLE_PALLAS=1: refused on the card; the plain path on the CPU
        start = time.perf_counter()
        cpu_env = env.to("cpu")
        for name, (with_bvh, budget, size) in KNOB_SCENES.items():
            scene = named_scene(name)
            kernel_ds = build_device_scene(scene, dev, with_bvh=with_bvh)
            ref = freerun_image(kernel_ds, env, camera_pytree(scene.camera, dev), size, budget)
            with knob_env({"RT_DISABLE_PALLAS": "1"}):
                reset_launches()
                try:
                    freerun_image(kernel_ds, env, camera_pytree(scene.camera, dev), size, budget)
                except RuntimeError as err:
                    refused = str(err)
                else:
                    refused = None
                no_launches(f"{name} on the card under RT_DISABLE_PALLAS=1")
                if refused is None or "device='cpu'" not in refused:
                    raise AssertionError(f"{name}: the card did not refuse RT_DISABLE_PALLAS=1")
                cpu_start = time.perf_counter()
                got = freerun_image(kernel_ds.to("cpu"), cpu_env, camera_pytree(scene.camera, "cpu"),
                                    size, budget)
                no_launches(f"{name} on the CPU under RT_DISABLE_PALLAS=1")
                log("every_scene", scene=name, knob="RT_DISABLE_PALLAS=1", route=route(kernel_ds),
                    card_refused=repr(refused[:60]), cpu_size=size, budget=budget,
                    cpu_seconds=f"{time.perf_counter() - cpu_start:.1f}")
            del kernel_ds
            image_check(f"{name}_disable_pallas_cpu_vs_kernels", got, ref)
        log("every_scene", knob="RT_DISABLE_PALLAS=1", seconds=f"{time.perf_counter() - start:.1f}")

        # RT_DEBUG_NANS=1: clean runs raise nothing; a NaN ray lane does
        start = time.perf_counter()
        for name, (with_bvh, budget, _) in KNOB_SCENES.items():
            scene = named_scene(name)
            nds = build_device_scene(scene, dev, with_bvh=with_bvh)
            with knob_env({"RT_DEBUG_NANS": "1"}):
                freerun_image(nds, env, camera_pytree(scene.camera, dev), EVERY_SIZE, budget)
            if name == "house":
                house_ds = nds
            del nds
        hcam = camera_pytree(named_scene("house").camera, dev)
        carry = loop_state(house_ds, env, hcam, 256, 0, 0, kernel_iterations=1)["trace"][2]
        ro = [carry[k].clone() for k in ("ro0", "ro1", "ro2")]
        rd = tuple(carry[k] for k in ("rd0", "rd1", "rd2"))
        ro[0][7] = float("nan")
        with knob_env({"RT_DEBUG_NANS": "1"}):
            reset_launches()
            try:
                ci.closest_call(house_ds, tuple(ro), rd)
            except FloatingPointError as err:
                raised = str(err)
            else:
                raised = None
        log("every_scene", knob="RT_DEBUG_NANS=1", injected="a NaN ray origin in lane 7 of CLOSEST",
            closest_launches=launches()["closest"], raised=repr(raised))
        if raised is None or "CLOSEST output" not in raised or launches()["closest"] != 1:
            raise AssertionError("the NaN in CLOSEST's outputs did not raise FloatingPointError")
        rates = {}
        for knob in (None, "1", "1", None):
            with knob_env({"RT_DEBUG_NANS": knob}):
                rates.setdefault(knob, []).append(
                    freerun_rate(house_ds, env, hcam, NANS_MAIN_BUDGET, dev)[1])
        log("every_scene", knob="RT_DEBUG_NANS", scene="house", size=SIZE, budget=NANS_MAIN_BUDGET,
            off_mrays_per_s=",".join(f"{r:.2f}" for r in rates[None]),
            on_mrays_per_s=",".join(f"{r:.2f}" for r in rates["1"]),
            seconds=f"{time.perf_counter() - start:.1f}", card=repr(card))
        del house_ds
    log("every_scene_phase", seconds=f"{time.perf_counter() - phase_start:.1f}")


# Phase 18: the lane layout. The 2048^2 free-run budget by scene, the
# calls of each setting (in turns, after a warm-up call each), the
# cadence compared beside K = 0 and the reference's default, and the
# size and budget of the key modes' images.
LANES_BUDGET = {"house": 64, "suzanne_hi": 32, "suzanne_xhi": 16, "spheres": 16}
LANES_CALLS = 3
LANES_K = 4
LANES_MODES_SIZE, LANES_MODES_BUDGET = 256, 16


@contextlib.contextmanager
def counted_permutations():
    """A list that gains one entry each time Wavefront.permute runs."""
    calls, real = [], Wavefront.permute

    def permute(self):
        calls.append(1)
        return real(self)

    with mock.patch.object(Wavefront, "permute", permute):
        yield calls


def same_render(a, b):
    """Whether two (image, counts, stats) are bitwise the same."""
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and torch.equal(a[1], b[1])
            and all(int(a[2][k]) == int(b[2][k]) for k in a[2]))


def lane_calls(label, ds, env, cam, size, budget, settings, calls, card):
    """Each setting (name, knobs, compact_every): a warm-up call, then
    `calls` free-run calls at size^2 from counts 0, the settings in turns;
    every call's image, counts and stats must be bitwise the first's.
    Logs and returns {name: (median Mrays/s, spread)}."""
    res = (size, size)
    rates, perms, ref = {name: [] for name, _, _ in settings}, {}, None
    for turn in range(calls + 1):
        for name, knobs, every in settings:
            with knob_env(knobs), counted_permutations() as permuted:
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = render_freerun(ds, env, cam, 0, res, budget, BOUNCES, with_stats=True,
                                     compact_every=every)
                rays = int(out[2]["closest_rays"] + out[2]["shadow_rays"])  # synchronizes
                seconds = time.perf_counter() - start
            ref = out if ref is None else ref
            if not same_render(out, ref):
                raise AssertionError(f"{label}: {name} is not bitwise {settings[0][0]}'s render")
            perms[name] = len(permuted)
            if turn:
                rates[name].append(rays / seconds / 1e6)
    got = {}
    for name, _, every in settings:
        r = sorted(rates[name])
        got[name] = (r[len(r) // 2], r[-1] - r[0])
        log("lanes", scene=label, size=size, budget=budget, setting=name, compact_every=every,
            permutations_a_call=perms[name], bitwise=True, mrays_per_s=f"{got[name][0]:.2f}",
            spread=f"{got[name][1]:.2f}", per_call=",".join(f"{x:.2f}" for x in rates[name]),
            card=repr(card))
    return got


def permuted_state(ds, env, cam, compact_every):
    """(wave, the chunked kernels' arguments at iteration 2) of a 2048^2
    free-run loop state; compact_every=2 permutes the lanes before it."""
    wave = Wavefront(ds, env, cam, 0, (SIZE, SIZE), NO_LIMIT, 64, BOUNCES, compact_every=compact_every)
    for it in range(2):
        wave.step(it)
    return wave, capture_step(wave, 2)


def lane_kernels(label, ds, env, cam, card):
    """CHUNKED_CLOSEST and CHUNKED_ANY on a 2048^2 loop state without and
    with a permutation: ms a launch, the batch model's pairs, candidates
    and busy (block, batch) pairs; the permuted outputs must be the
    unpermuted ones moved with the lanes (closest on live lanes, occlusion
    on masked lanes, BIG_SHADE on every lane). Then one permutation's ms:
    key, stable sort, gather, and the whole."""
    (plain_wave, plain), (wave, permuted) = (permuted_state(ds, env, cam, k) for k in (0, 2))
    home = wave.carry["home"].to(torch.int64)
    if torch.equal(home, torch.arange(home.shape[0], device=home.device)):
        raise AssertionError(f"{label}: the loop state was not permuted")
    for key in BIG_KERNELS:
        kfn = KERNELS[key][0]
        outs = {}
        for name, state in (("unpermuted", plain), ("permuted", permuted)):
            outs[name] = kfn(*state[key])
            if key in ("env_draw", "big_shade"):
                continue
            model = intersect.chunked_closest_model if key == "closest" else intersect.chunked_any_model
            walked = {}
            model(*state[key], ci.chunked_batch(), counts=walked)
            log("lanes_kernel", scene=label, kernel=BIG_KERNELS[key], state=name, lanes=SIZE * SIZE,
                ms=f"{time_ms(lambda: kfn(*state[key]), 5):.4f}",
                **{f"model_{k}": v for k, v in walked.items()}, card=repr(card))
        got = outs["permuted"]
        ref = outs["unpermuted"]
        if key == "closest":
            where = permuted[key][3] != 0
            pairs = zip(got, ref)
        elif key == "occlusion":
            where = permuted[key][3] != 0
            pairs = [(got, ref)]
        elif key == "env_draw":
            where = torch.ones_like(home, dtype=torch.bool)
            pairs = [(got[k], ref[k]) for k in cw.ENV_DRAW_OUT_NAMES]
        else:
            where = torch.ones_like(home, dtype=torch.bool)
            pairs = [(got[0][k], ref[0][k]) for k in cw.CARRY_NAMES] + [(got[1], ref[1]), (got[2], ref[2])]
        differ = sum(int((_bits(a) != _bits(b.index_select(0, home)))[where].sum()) for a, b in pairs)
        log("lanes_kernel", scene=label, kernel=BIG_KERNELS[key], compared=int(where.sum()),
            lanes_differ_after_permutation=differ)
        if differ:
            raise AssertionError(f"{label}: {BIG_KERNELS[key]} does not move with its lanes")
    key = wf.compact_key(wave.carry, *wave.grid, wave.key_bits, wave.key_mode)
    order = torch.argsort(key, stable=True)
    log("lanes_permutation", scene=label, lanes=SIZE * SIZE, columns=len(wave.carry),
        key_ms=f"{time_ms(lambda: wf.compact_key(wave.carry, *wave.grid, wave.key_bits, wave.key_mode), 5):.4f}",
        sort_ms=f"{time_ms(lambda: torch.argsort(key, stable=True), 5):.4f}",
        gather_ms=f"{time_ms(lambda: wf.permute_carry(wave.carry, order), 5):.4f}",
        permute_ms=f"{time_ms(wave.permute, 5):.4f}", card=repr(card))
    del plain_wave, wave, plain, permuted


def lanes_phase(sky, card, dev):
    """Phase 18: block-major lanes and lane compaction."""
    phase_start = time.perf_counter()
    # house: block-major (the default) against row-major lanes
    ds, env, cam = scene_setup("house", dev, sky)
    lane_calls("house", ds, env, cam, SIZE, LANES_BUDGET["house"],
               [("block", {}, None), ("row", {"RT_DISABLE_BLOCK_REMAP": "1"}, None)], LANES_CALLS, card)
    del ds
    generated_mesh("suzanne_xhi.obj")
    decision = {}
    for name in ("suzanne_hi", "suzanne_xhi"):
        ds, env, cam = scene_setup(name, dev, sky)
        ref_k = wf.reference_cadence(ds)
        if route(ds) != CHUNKED or ref_k == 0:
            raise AssertionError(f"{name} does not take the chunked route with a compacting default")
        got = lane_calls(name, ds, env, cam, SIZE, LANES_BUDGET[name],
                         [("K0", {}, 0), ("reference", {}, ref_k), (f"K{LANES_K}", {}, LANES_K)],
                         LANES_CALLS, card)
        decision[name] = got["reference"][0] / got["K0"][0]
        log("lanes_default", scene=name, chunks=ds.chunks.count, reference_k=ref_k,
            card_default_k=wf.compact_every_default(ds),
            reference_over_k0=f"{decision[name]:.4f}", card=repr(card))
        lane_kernels(name, ds, env, cam, card)
        if name == "suzanne_hi":
            modes = [("K0", {}, 0)] + [(mode, {"RT_COMPACT_KEY": mode}, 1) for mode in wf.COMPACT_KEYS]
            lane_calls(name, ds, env, cam, LANES_MODES_SIZE, LANES_MODES_BUDGET, modes, 1, card)
        del ds
    # spheres (16 chunks): the default compacts nothing
    ds, env, cam = scene_setup("spheres", dev, sky)
    with counted_permutations() as permuted:
        render_freerun(ds, env, cam, 0, (SIZE, SIZE), LANES_BUDGET["spheres"], BOUNCES)
        torch.cuda.synchronize()
    log("lanes_default", scene="spheres", chunks=ds.chunks.count, card_default_k=wf.compact_every_default(ds),
        permutations=len(permuted))
    if permuted:
        raise AssertionError("spheres' default permuted its lanes")
    del ds
    log("lanes_phase", seconds=f"{time.perf_counter() - phase_start:.1f}",
        reference_over_k0=",".join(f"{k}:{v:.4f}" for k, v in decision.items()))


def main() -> int:
    smoke_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())

    # 2. build
    start = time.perf_counter()
    _kernels.library()
    log("build", seconds=f"{time.perf_counter() - start:.2f}",
        nvcc_seconds=f"{_kernels.BUILD_INFO.get('seconds', 0.0):.2f}",
        flags=repr(" ".join(_kernels.NVCC_FLAGS)),
        ptxas=json.dumps(_kernels.BUILD_INFO.get("ptxas", [])))

    sky_host = Environment.from_texture("sky", procedural_sky(2048, 1024))
    sky = device_environment(sky_host, dev)
    n_pixels = SIZE * SIZE
    max_err, times, bounds = {}, {}, {}

    # 3. house: the small-scene route
    ds, env, cam = scene_setup("house", dev, sky)
    small = loop_state(ds, env, cam, 256, 0, 3)
    trace_parity("house", 256 * 256, small["trace"], max_err)
    keep_worst(max_err, "shade", check_parity(
        "shade", 256 * 256, shade_outputs(cw.shade_call(*small["shade"])),
        shade_outputs(cw.shade_plain(*small["shade"])), cw.SHADE_INT_NAMES))
    sweep_parity(small["trace"], 256 * 256, max_err)
    counted, image, counts, warm = timed_main("house", ds, env, cam, card, TIMED_CALLS, dev)
    house_launches = counted
    if not counted["trace"] == counted["shade"] == counted["iterations"]:
        raise AssertionError("the house main path did not launch TRACE and SHADE once an iteration")
    save_png("house", image, counts, warm)
    split("house", ds, env, cam, counts, card)
    no_gather("house", ds, env, cam, counts, card)
    main_args = loop_state(ds, env, cam, SIZE, 0, 0, kernel_iterations=2)
    trace_parity("house", n_pixels, main_args["trace"], max_err)
    keep_worst(max_err, "shade", check_parity(
        "shade", n_pixels, shade_outputs(cw.shade_call(*main_args["shade"])),
        shade_outputs(cw.shade_plain(*main_args["shade"])), cw.SHADE_INT_NAMES))
    prims = sweep_ops(ds)
    calls, shadow_rays = sweep_calls(main_args["trace"])
    shadow_ops = first_hit_ops(ds, shadow_rays)
    for name, kfn, pfn, n_bytes, n_ops in (
        # TRACE: 7 carry inputs of 4 bytes, the alias and quad rows of 16,
        # 26 outputs of 4 bytes and the quad row; the closest sweep over
        # every primitive and the shadow sweep up to each lane's first hit
        # (the alias draw, uv math and BSDF are left out: the bound stays a
        # lower bound)
        ("trace", cw.trace_call, cw.trace_plain,
         n_pixels * (4 * len(cw.TRACE_CARRY_IN) + 16 + 16 + 4 * (len(cw.TRACE_OUT_NAMES) - 1) + 16),
         n_pixels * prims + shadow_ops),
        # SHADE: its per-lane inputs, the 4-word quad row and 22 outputs
        ("shade", cw.shade_call, cw.shade_plain,
         n_pixels * 4 * (len(cw.SHADE_IN) + 4 + len(cw.SHADE_OUT_NAMES)), 0),
    ):
        args = main_args[name]
        p1 = time_ms(lambda: pfn(*args), 2)
        k1 = time_ms(lambda: kfn(*args), 10)
        k2 = time_ms(lambda: kfn(*args), 10)
        p2 = time_ms(lambda: pfn(*args), 2)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        bounds[name] = bound_ms(n_bytes, n_ops)
        log("timing", kernel=name, lanes=n_pixels, ms=f"{times[name][0]:.4f}",
            plain_ms=f"{times[name][1]:.4f}", bound_ms=f"{bounds[name][0]:.4f}",
            bound_by=bounds[name][1], card=repr(card))

    # 8. the sweep kernels on the loop state (every lane live, for
    # comparison with earlier readings): FUSED 9 inputs and 16 outputs of
    # 4 bytes a lane and its sweeps over the padded table; CLOSEST 6 and
    # 18, ANY 6 and 1, their sweeps over the valid rows (ANY's up to each
    # lane's first hit)
    sweep_parity(main_args["trace"], n_pixels, max_err)
    valid_shadow_ops = first_hit_ops(ds, shadow_rays, extents=ds.sweep_rows)
    for name, n_bytes, n_ops in (
        ("closest", n_pixels * 24 * 4, n_pixels * valid_sweep_ops(ds)),
        ("any", n_pixels * 7 * 4, valid_shadow_ops),
        ("fused", n_pixels * 25 * 4, n_pixels * prims + shadow_ops),
    ):
        kfn, pfn, _ = calls[name]
        p1 = time_ms(pfn, 2)
        k1 = time_ms(kfn, 10)
        k2 = time_ms(kfn, 10)
        p2 = time_ms(pfn, 2)
        bound = bound_ms(n_bytes, n_ops)
        if name == "fused":
            times[name], bounds[name] = ((k1 + k2) / 2, (p1 + p2) / 2), bound
        log("timing", kernel=name, state="loop", lanes=n_pixels, ms=f"{(k1 + k2) / 2:.4f}",
            plain_ms=f"{(p1 + p2) / 2:.4f}", bound_ms=f"{bound[0]:.4f}",
            bound_by=bound[1], ops_per_lane=f"{n_ops / n_pixels:.1f}", card=repr(card))
    del calls, shadow_rays, main_args, small

    # 8b. CLOSEST and ANY on the scan integrator's own states (bounces 0
    # and 3 of one render_sample), at 256^2 and 2048^2: parity, then at
    # 2048^2 each one's time beside its plain version's and the bound
    # of profiling.scan_bounds; the kernels line takes bounce 0's
    for size in (256, SIZE):
        for bounce, state in capture_scan(ds, env, cam, size, BOUNCES).items():
            scan_parity(f"scan{bounce}", size * size, ds, state, max_err)
            if size != SIZE:
                continue
            closest, occlusion = scan_calls(ds, state)
            ro, rd, live = state["closest"]
            p, nd, mask = state["any"]
            live32, mask32 = live.to(torch.int32), mask.to(torch.int32)
            plains = {
                "closest": lambda: intersect.closest_record(ds, ro, rd, live32),
                "any": lambda: intersect.any_sweep(ds, *p, *nd) & (mask32 != 0),
            }
            c_bound, a_bound, n_live, n_mask = scan_bounds(ds, state)
            for name, kfn, bound in (("closest", closest, c_bound), ("any", occlusion, a_bound)):
                pfn = plains[name]
                p1 = time_ms(pfn, 2)
                k1 = time_ms(kfn, 10)
                k2 = time_ms(kfn, 10)
                p2 = time_ms(pfn, 2)
                if bounce == 0:
                    times[name], bounds[name] = ((k1 + k2) / 2, (p1 + p2) / 2), bound
                log("timing", kernel=name, state=f"scan{bounce}", lanes=n_pixels, live=n_live,
                    masked=n_mask, ms=f"{(k1 + k2) / 2:.4f}", plain_ms=f"{(p1 + p2) / 2:.4f}",
                    bound_ms=f"{bound[0]:.4f}", bound_by=bound[1], card=repr(card))

    # 9. scan path, 10. composed body, 11. command line
    house = load_scene(os.path.join(ROOT, "assets", "scenes", "house.toml"))
    scan_launches = scan_path(house, sky_host, sky, card, dev)
    composed_launches = composed_path("house", ds, sky_host, sky, cam, card, dev)
    cli_phase(dev)

    # 4. big-mesh parity
    hi_ds, _, hi_cam = scene_setup("suzanne_hi", dev, sky)
    sph_ds, _, sph_cam = scene_setup("spheres", dev, sky)
    big_parity("suzanne_hi", loop_state(hi_ds, sky, hi_cam, 256, 0, 3), 256 * 256, max_err)
    big_parity("spheres", loop_state(sph_ds, sky, sph_cam, 256, 0, 3), 256 * 256, max_err)
    big_parity("spheres", loop_state(sph_ds, sky, sph_cam, SIZE, 0, 0, kernel_iterations=2),
               n_pixels, max_err)
    suz_ds, _, suz_cam = scene_setup("suzanne", dev, sky)
    big_parity("suzanne", loop_state(suz_ds, sky, suz_cam, SIZE, 0, 0, kernel_iterations=2),
               n_pixels, max_err)
    del suz_ds

    # 5. big-mesh main path: suzanne_hi, then a short spheres run
    big_launches, image, counts, warm = timed_main("suzanne_hi", hi_ds, sky, hi_cam, card,
                                                   TIMED_CALLS, dev)
    for k in ("env_draw", "chunked_closest", "chunked_any", "big_shade"):
        if big_launches[k] <= 0:
            raise AssertionError(f"the suzanne_hi main path did not launch {k}")
    if big_launches["trace"] or big_launches["shade"]:
        raise AssertionError("the suzanne_hi main path launched TRACE or SHADE")
    save_png("suzanne_hi", image, counts, warm)
    split("suzanne_hi", hi_ds, sky, hi_cam, counts, card)
    sph_counted, image, counts, warm = timed_main("spheres", sph_ds, sky, sph_cam, card, 1, dev,
                                                  budget=32)
    save_png("spheres", image, counts, warm)
    del sph_ds

    # 6. each big-mesh kernel against its plain version on suzanne_hi 2048^2
    state = loop_state(hi_ds, sky, hi_cam, SIZE, 0, 0, kernel_iterations=2)
    for key, name in BIG_KERNELS.items():
        kfn, pfn = KERNELS[key]
        times[name], ref = time_kernel(kfn, pfn, state[key])
        kernel_parity(key, "suzanne_hi", state[key], n_pixels, max_err, ref)
        if key == "big_shade":
            # its per-lane inputs, the 4-word quad row and 22 outputs; the
            # winner and material tables once
            n_bytes = (n_pixels * 4 * (len(cw.BIG_SHADE_IN) + 4 + len(cw.SHADE_OUT_NAMES))
                       + 4 * (hi_ds.winner.numel() + hi_ds.materials.numel()))
            bounds[name] = bound_ms(n_bytes, 0) + ({},)
            walked = {}
        elif key == "env_draw":
            # the state in, the 4-word alias row, 7 outputs
            bounds[name] = bound_ms(n_pixels * 4 * (1 + 4 + len(cw.ENV_DRAW_OUT_NAMES)), 0) + ({},)
            walked = {}
        else:
            bounds[name] = chunked_bound(hi_ds, state[key], key == "closest")
            # what a walk in the kernel's batches sweeps (a batch's slabs
            # against the best of the batch's start), from the traversal model
            model = intersect.chunked_closest_model if key == "closest" else intersect.chunked_any_model
            walked = {}
            model(*state[key], ci.chunked_batch(), counts=walked)
            walked = {f"model_{k}": v for k, v in walked.items()}
            walked["shared_bytes"] = ci.chunked_shared_bytes(hi_ds)
        log("timing", kernel=name, lanes=n_pixels, ms=f"{times[name][0]:.4f}",
            plain_ms=f"{times[name][1]:.4f}", bound_ms=f"{bounds[name][0]:.4f}",
            bound_by=bounds[name][1], **bounds[name][2], **walked, card=repr(card))
    del hi_ds

    # 7. goldens
    golden_env = device_environment(
        Environment.from_texture("golden_sky", procedural_sky(256, 128, sun_radius=0.05)), dev)
    for name in ("default", "house"):
        scene = load_scene(os.path.join(ROOT, "assets", "scenes", f"{name}.toml"))
        img = render_wavefront(build_device_scene(scene, dev), golden_env,
                               camera_pytree(scene.camera, dev), 0, (64, 64), 8, 4)
        img = img.cpu().numpy() / 8
        golden = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}_64_8spp.npy"))
        rel = float(np.sqrt(np.mean((img - golden) ** 2)) / np.sqrt(np.mean(golden ** 2)))
        log("golden", scene=name, rel_rmse=f"{rel:.3e}", bound=GOLDEN_REL_RMSE_MAX)
        if not rel < GOLDEN_REL_RMSE_MAX:
            raise AssertionError(f"{name}: relative RMSE {rel:.3e} against the golden")
    env0 = device_environment(load_default_environments()[0], dev)
    anchor("suzanne_hi", 24, 2, env0, dev)
    anchor("spheres", 32, 4, env0, dev)
    generated_mesh("suzanne_xhi.obj")
    for with_bvh in (False, True):
        anchor("suzanne_xhi", 16, 2, env0, dev, with_bvh)

    # 12. the BVH route
    bvh_launches = bvh_phase(sky_host, sky, card, dev, max_err, times, bounds)

    # 13. sync rounds, 14. the multi-device split, 15. the viewer, 16. the
    # chunk orders, 17. every scene
    sync_phase(sky, card, dev)
    multi_device_phase(sky_host, sky, card, dev)
    viewer_phase(card, dev)
    cluster_phase(sky, card, dev, max_err, bvh_launches["mrays_per_s"])

    replaces = {
        "trace": "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:775",
        "shade": "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:840",
        "chunked_closest": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1524",
        "chunked_any": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1524",
        "big_shade": "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:1042",
        # not a Pallas kernel: the reference's XLA glue before its sweeps
        "env_draw": "rsoderh_raytracing_tpu/render/wavefront.py:928",
        "fused": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1964",
        "closest": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1624",
        "any": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1624",
        # not Pallas kernels: the reference's BVH walks, lax.while_loops in XLA
        "bvh_closest": "rsoderh_raytracing_tpu/ops/bvh_traverse.py:304",
        "bvh_any": "rsoderh_raytracing_tpu/ops/bvh_traverse.py:468",
    }
    sources = {"trace": SRC_WAVEFRONT, "shade": SRC_WAVEFRONT, "chunked_closest": SRC_CHUNKED,
               "chunked_any": SRC_CHUNKED, "big_shade": SRC_WAVEFRONT, "env_draw": SRC_WAVEFRONT,
               "fused": SRC_SWEEP,
               "closest": SRC_SWEEP, "any": SRC_SWEEP, "bvh_closest": SRC_BVH, "bvh_any": SRC_BVH}
    counted = {**{k: house_launches[k] for k in ("trace", "shade")},
               **{k: big_launches[k] for k in ("env_draw", "chunked_closest", "chunked_any", "big_shade")},
               "fused": composed_launches["fused"],
               **{k: scan_launches[k] for k in ("closest", "any")},
               **{k: bvh_launches[k] for k in ("bvh_closest", "bvh_any")}}
    # each kernel's launches by the main path that counted them
    paths = {k: {path: counted[k]} for k, path in (
        ("trace", "house"), ("shade", "house"), ("chunked_closest", "suzanne_hi"),
        ("chunked_any", "suzanne_hi"), ("big_shade", "suzanne_hi"), ("env_draw", "suzanne_hi"),
        ("fused", "house_composed"),
        ("closest", "house_scan"), ("any", "house_scan"), ("bvh_closest", "suzanne_xxhi"),
        ("bvh_any", "suzanne_xxhi"))}
    every_scene_phase(sky, card, dev, max_err, paths)
    # 18. the lane layout
    lanes_phase(sky, card, dev)
    kernels = [
        {"name": name, "route": "cuda",
         "source": sources[name],
         "replaces": replaces[name], "launches": counted[name], "launches_by_path": paths[name],
         "max_abs_err": max_err[name]["abs"][0], "max_rel_err": max_err[name]["rel"][0],
         "max_abs_output": max_err[name]["abs"][1], "max_rel_output": max_err[name]["rel"][1],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name in sources
    ]
    log("smoke", seconds=f"{time.perf_counter() - smoke_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
