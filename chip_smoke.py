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
4. big-mesh parity (CHUNKED_CLOSEST, CHUNKED_ANY, BIG_SHADE): suzanne_hi
   and spheres at 256x256 lanes after 3 plain iterations, spheres and
   suzanne at 2048x2048 lanes; the closest hit compared on live lanes,
   occlusion on masked lanes, BIG_SHADE output by output;
5. big-mesh main path: suzanne_hi (15,488 triangles, 242 chunks) at
   2048x2048, 8 bounces, a warm-up call then timed calls carrying counts,
   as the reference's bench runs it with BENCH_SCENE=suzanne_hi; the three
   new kernels must have launched and TRACE/SHADE not; the
   glue/closest/occlusion/gather/BIG_SHADE split; then a short spheres run
   at 2048x2048;
6. timing: each big-mesh kernel against its plain version on a
   suzanne_hi 2048^2 loop state, with its bound from the inputs' cull
   counts (profiling.chunked_bound), and beside it the pairs, candidates
   and slab tests of a walk in the chunked kernels' batches (the traversal
   model intersect.chunked_*_model) and a block's shared memory; the plain
   version's outputs of that one timed call are the parity reference of
   suzanne_hi at 2048^2;
7. goldens: render_wavefront through the kernels against
   tests/goldens/{default,house}_64_8spp.npy and the oracle anchors
   suzanne_hi_anchor_24_2spp.npy and spheres_anchor_32_4spp.npy;
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
   are read back (under build/chip_smoke/).

Then a JSON line with each kernel's launches, largest absolute and
relative errors (and the outputs that hold them), times and bound, the
card line again, and last {"ok": true, "device": {...}}. Imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from rsoderh_raytracing_tpu_torch import cli, load_scene, write_png  # noqa: E402
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
from rsoderh_raytracing_tpu_torch.profiling import (  # noqa: E402
    KERNELS, bound_ms, capture_scan, capture_step, card_line, chunked_bound, first_hit_ops,
    kernel_breakdown, scan_bounds, scan_calls, scene_gathers, scene_setup, shade_outputs,
    sweep_calls, sweep_ops, time_ms, valid_sweep_ops,
)
from rsoderh_raytracing_tpu_torch.render.integrator import (  # noqa: E402
    MAX_BOUNCES, camera_pytree, render_sample,
)
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer  # noqa: E402
from rsoderh_raytracing_tpu_torch.render.wavefront import (  # noqa: E402
    NO_LIMIT, Wavefront, render_freerun, render_wavefront,
)
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene  # noqa: E402
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
BIG_KERNELS = {"closest": "chunked_closest", "occlusion": "chunked_any", "big_shade": "big_shade"}


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
    lanes, BIG_SHADE output by output on every lane."""
    kfn, pfn = KERNELS[key]
    got = kfn(*args)
    ref = pfn(*args) if ref is None else ref
    if key == "closest":
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
        warmup_ms_per_iter=f"{per_iter * 1e3:.2f}", card=repr(card))
    if not bool(torch.isfinite(image).all()):
        raise AssertionError(f"{label}: non-finite pixels in the main-path image")
    if int(counts.min()) <= 0 or total_rays <= 0:
        raise AssertionError(f"{label}: pixels without samples or no rays traced")
    counted["iterations"] = calls * (budget + BOUNCES - 1)
    return counted, image, counts, warm_counts


def split(label, ds, env, cam, counts, card):
    """Device ms per iteration of each part of a short profiled call."""
    profile = {}
    render_freerun(ds, env, cam, counts, (SIZE, SIZE), 8, BOUNCES, profile=profile)
    torch.cuda.synchronize()
    parts = {}
    for marks in profile["marks"]:
        for (part, ev), (_, nxt) in zip(marks, marks[1:]):
            parts[part] = parts.get(part, 0.0) + ev.elapsed_time(nxt)
    n = len(profile["marks"])
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


def anchor(name, size, spp, env, dev):
    """The oracle anchor golden through the kernels, with the reference's
    flip-aware criteria (tests/test_reference_estimator.py)."""
    scene = load_scene(os.path.join(ROOT, "assets", "scenes", f"{name}.toml"))
    img = render_wavefront(build_device_scene(scene, dev), env, camera_pytree(scene.camera, dev),
                           0, (size, size), spp, MAX_BOUNCES)
    ours = img.cpu().numpy() / spp
    ref = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}_anchor_{size}_{spp}spp.npy"))
    diff = ours - ref
    ad = np.abs(diff).max(-1)
    flipped = ad > 1e-2
    keep = ~flipped
    rel = float(np.sqrt((diff[keep] ** 2).mean()) / np.sqrt((ref[keep] ** 2).mean()))
    mrel = abs(float(ours.mean()) - float(ref.mean())) / float(ref.mean())
    within = float((ad < 1e-4).mean())
    log("golden", scene=f"{name}_anchor", flipped=f"{flipped.mean():.4f}", within_1e4=f"{within:.4f}",
        rel_rmse_unflipped=f"{rel:.3e}", image_mean_rel=f"{mrel:.3e}")
    if name == "suzanne_hi":
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
    if any(counted[k] for k in ("trace", "shade", "fused", "big_shade")):
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


def main() -> int:
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
    for k in ("chunked_closest", "chunked_any", "big_shade"):
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
            ch = hi_ds.chunks
            n_bytes = (n_pixels * 4 * (len(cw.BIG_SHADE_IN) + 4 + len(cw.SHADE_OUT_NAMES))
                       + 4 * (ch.winner.numel() + ch.materials.numel()))
            bounds[name] = bound_ms(n_bytes, 0) + ({},)
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

    replaces = {
        "trace": "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:775",
        "shade": "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:840",
        "chunked_closest": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1524",
        "chunked_any": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1524",
        "big_shade": "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:1042",
        "fused": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1964",
        "closest": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1624",
        "any": "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1624",
    }
    sources = {"trace": SRC_WAVEFRONT, "shade": SRC_WAVEFRONT, "chunked_closest": SRC_CHUNKED,
               "chunked_any": SRC_CHUNKED, "big_shade": SRC_WAVEFRONT, "fused": SRC_SWEEP,
               "closest": SRC_SWEEP, "any": SRC_SWEEP}
    counted = {**{k: house_launches[k] for k in ("trace", "shade")},
               **{k: big_launches[k] for k in ("chunked_closest", "chunked_any", "big_shade")},
               "fused": composed_launches["fused"],
               **{k: scan_launches[k] for k in ("closest", "any")}}
    kernels = [
        {"name": name, "route": "cuda",
         "source": sources[name],
         "replaces": replaces[name], "launches": counted[name],
         "max_abs_err": max_err[name]["abs"][0], "max_rel_err": max_err[name]["rel"][0],
         "max_abs_output": max_err[name]["abs"][1], "max_rel_output": max_err[name]["rel"][1],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name in sources
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
