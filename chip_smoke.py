"""Main-path gate of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

For each route of the port at 2048x2048, 8 bounces, under
procedural_sky(2048, 1024): zero the launch counters, run the route's
main path, read the kernels that run launched, capture the arguments its
kernels were called with at one iteration (bounces 0 and 3 on the scan
path), and hold each kernel on them against its plain twin: every output
at PARITY_MIN, RTOL and ATOL, and the outputs that are exact by
construction bitwise. Then each kernel's device ms on that state (CUDA
events), its plain twin's ms (the one call that made the reference) and
its bound (profiling.bound_ms and the counts behind it). Routes:

1. house, the small route (render_freerun, budget 16): TRACE and SHADE
   once an iteration and nothing else of the eleven; TRACE's NEE pmf and
   quad row bitwise on every lane, its NEE uv where both hit;
2. house, the composed body (render_freerun with the float32 legacy
   quad): FUSED once an iteration, held on its own arguments;
3. house, the scan path (render_sample, as Renderer.step runs it):
   CLOSEST and ANY once a bounce; t, type, index, material id and
   occlusion bitwise on every lane, the dead lanes' miss record;
4. suzanne_hi, the chunked route (with_bvh=False): ENV_DRAW,
   CHUNKED_CLOSEST, CHUNKED_ANY and BIG_SHADE once an iteration;
   CHUNKED_CLOSEST on live lanes, CHUNKED_ANY on masked lanes, ENV_DRAW's
   draw bitwise; the bounds from the cull counts (profiling.chunked_bound);
5. suzanne_xxhi, the BVH route (with_bvh="auto"; the mesh is generated
   by scripts/subdivide_obj.py when absent): the native builder loaded,
   the tree shallower than the walks' stack; ENV_DRAW, BVH_CLOSEST,
   BVH_ANY and BIG_SHADE once an iteration; the walks bitwise their plain
   twins on every lane, their bounds from the plain walks' counts
   (profiling.bvh_bound).

Exits non-zero at the first failure. Then the run's seconds, a JSON line
with each of the eleven kernels' launches by path, largest absolute and
relative errors (and the outputs that hold them), ms, plain ms and
bound, the card line again, and last {"ok": true, "device": {...}}. The
card tests (pytest --noconftest -m cuda tests/test_torch_cuda.py) hold
the kernels at small sizes and every other path; portbench measures
speed end to end. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from rsoderh_raytracing_tpu_torch.accel import bvh as accel_bvh  # noqa: E402
from rsoderh_raytracing_tpu_torch.accel import native as accel_native  # noqa: E402
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment  # noqa: E402
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import _kernels  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import intersect  # noqa: E402
from rsoderh_raytracing_tpu_torch.profiling import (  # noqa: E402
    bound_ms, bvh_bound, capture_scan, capture_step, card_line, chunked_bound, first_hit_ops,
    route_kernels, scan_bounds, scene_setup, sweep_calls, sweep_ops, time_ms,
)
from rsoderh_raytracing_tpu_torch.render.wavefront import Wavefront, render_freerun  # noqa: E402
from rsoderh_raytracing_tpu_torch.scene.device import BVH, CHUNKED, SMALL, route  # noqa: E402

# Kernel against plain version on the same card, output by output: an
# integer output must be equal, and a float output isclose(RTOL, ATOL),
# on at least PARITY_MIN of the compared lanes (the card tests' bounds).
PARITY_MIN = 0.9999
RTOL, ATOL = 1e-4, 1e-5

SIZE = 2048
BOUNCES = 8
BUDGET = 16
CAPTURE_IT = 2  # the main-path iteration whose kernel arguments are held
N = SIZE * SIZE
SRC_WAVEFRONT = "rsoderh_raytracing_tpu_torch/csrc/wavefront.cu"
SRC_CHUNKED = "rsoderh_raytracing_tpu_torch/csrc/chunked.cu"
SRC_SWEEP = "rsoderh_raytracing_tpu_torch/csrc/sweep.cu"
SRC_BVH = "rsoderh_raytracing_tpu_torch/csrc/bvh.cu"
# kernel: (its source, the reference code it replaces)
KERNEL_SOURCES = {
    "trace": (SRC_WAVEFRONT, "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:775"),
    "shade": (SRC_WAVEFRONT, "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:840"),
    "chunked_closest": (SRC_CHUNKED, "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1524"),
    "chunked_any": (SRC_CHUNKED, "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1524"),
    "big_shade": (SRC_WAVEFRONT, "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:1042"),
    # not a Pallas kernel: the reference's XLA glue before its sweeps
    "env_draw": (SRC_WAVEFRONT, "rsoderh_raytracing_tpu/render/wavefront.py:928"),
    "fused": (SRC_SWEEP, "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1964"),
    "closest": (SRC_SWEEP, "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1624"),
    "any": (SRC_SWEEP, "rsoderh_raytracing_tpu/ops/pallas_intersect.py:1624"),
    # not Pallas kernels: the reference's BVH walks, lax.while_loops in XLA
    "bvh_closest": (SRC_BVH, "rsoderh_raytracing_tpu/ops/bvh_traverse.py:304"),
    "bvh_any": (SRC_BVH, "rsoderh_raytracing_tpu/ops/bvh_traverse.py:468"),
}
# The kernels a free-run iteration launches, by route and Wavefront.step
# keyword.
ROUTE_KERNELS = {
    SMALL: {"trace": "trace", "shade": "shade"},
    CHUNKED: {"env_draw": "env_draw", "closest": "chunked_closest", "occlusion": "chunked_any",
              "big_shade": "big_shade"},
    BVH: {"env_draw": "env_draw", "closest": "bvh_closest", "occlusion": "bvh_any",
          "big_shade": "big_shade"},
}
# ENV_DRAW's outputs that are exact by construction (the alias index, its
# jitter and pmf, the state after four draws): bitwise on every lane.
ENV_DRAW_EXACT = ("state", "nee_u", "nee_v", "nee_pmf")
# suzanne_xxhi.toml's mesh: scripts/subdivide_obj.py's level.
XXHI_LEVEL = 5

# by kernel: launches by path, worst errors, (ms, plain ms), (bound ms, by)
LAUNCHES, ERRORS, TIMES, BOUNDS = {}, {}, {}, {}


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x.to(torch.int32)


def check(kernel, label, got, ref, int_names, where=None, exact=()):
    """Hold `got` to the plain version's `ref` on the lanes `where` (all
    by default): every output at PARITY_MIN, the outputs `exact` bitwise;
    keeps the largest absolute and relative differences in ERRORS."""
    if where is not None:
        got = {k: v[where] for k, v in got.items()}
        ref = {k: v[where] for k, v in ref.items()}
    shares, worst_abs, worst_rel = cw.parity(got, ref, int_names, RTOL, ATOL)
    differ = {k: int((_bits(got[k]) != _bits(ref[k])).reshape(got[k].shape[0], -1).any(1).sum())
              for k in exact}
    log("parity", kernel=kernel, state=label, compared=int(next(iter(got.values())).shape[0]),
        worst=min(shares, key=shares.get), share=f"{min(shares.values()):.6f}",
        max_abs_diff=f"{worst_abs[0]:.3e}", max_abs_output=worst_abs[1],
        max_rel_diff=f"{worst_rel[0]:.3e}", max_rel_output=worst_rel[1],
        **{f"{k}_lanes_differ": v for k, v in differ.items()})
    bad = sorted(k for k, v in shares.items() if v < PARITY_MIN)
    if bad or any(differ.values()):
        raise AssertionError(f"{kernel} on {label} disagrees with its plain version: {bad} {differ}")
    cur = ERRORS.setdefault(kernel, {"abs": (0.0, None), "rel": (0.0, None)})
    for k, err in (("abs", worst_abs), ("rel", worst_rel)):
        if err[1] is not None and (cur[k][1] is None or err[0] > cur[k][0]):
            cur[k] = err


def plain_timed(pfn):
    """(the plain version's outputs, its ms): one call, synchronized."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    ref = pfn()
    torch.cuda.synchronize()
    return ref, (time.perf_counter() - start) * 1e3


def timing(kernel, label, kfn, plain_ms, bound, card, **extra):
    """Record the kernel's ms on the state (the mean of 10 calls) beside
    its plain version's and its bound ((ms, by), as bound_ms returns)."""
    TIMES[kernel] = (time_ms(kfn, 10), plain_ms)
    BOUNDS[kernel] = bound[:2]
    log("timing", kernel=kernel, state=label, lanes=N, ms=f"{TIMES[kernel][0]:.4f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
        share_of_bound=f"{bound[0] / TIMES[kernel][0]:.4f}", **extra, card=repr(card))


def reset_launches():
    cw.reset_launches()
    ci.reset_launches()


def launched(path, expected, iterations):
    """The launches since reset_launches: each kernel of `expected` once
    an iteration, the other kernels never; recorded by path."""
    counted = {**cw.LAUNCHES, **ci.LAUNCHES}
    log("launches", path=path, iterations=iterations, **{k: v for k, v in counted.items() if v})
    wrong = {k: v for k, v in counted.items() if v != (iterations if k in expected else 0)}
    if wrong:
        raise AssertionError(f"{path}: launches {wrong}, expected {sorted(expected)} x {iterations}")
    for k in expected:
        LAUNCHES.setdefault(k, {})[path] = counted[k]


def main_path(label, ds, env, cam, route_name):
    """Run the free-run main path at SIZE^2 (budget BUDGET) from counts
    0, check its launches, and return the kernel arguments of iteration
    CAPTURE_IT of that run (capture_step's, by Wavefront.step keyword)."""
    captured = {}
    step = Wavefront.step

    def capturing(wave, it, **kwargs):
        if it == CAPTURE_IT and not kwargs:
            captured.update(capture_step(wave, it))  # calls step with the wrappers as keywords
        else:
            step(wave, it, **kwargs)

    reset_launches()
    start = time.perf_counter()
    with mock.patch.object(Wavefront, "step", capturing):
        image, counts, stats = render_freerun(ds, env, cam, 0, (SIZE, SIZE), BUDGET, BOUNCES,
                                              with_stats=True)
        torch.cuda.synchronize()
    iterations = BUDGET + BOUNCES - 1
    log("main", path=label, route=route(ds), size=SIZE, bounces=BOUNCES, budget=BUDGET,
        iterations=iterations, live_iterations=int(stats["iterations"]),
        seconds=f"{time.perf_counter() - start:.3f}", closest_rays=int(stats["closest_rays"]),
        shadow_rays=int(stats["shadow_rays"]))
    if not bool(torch.isfinite(image).all()) or int(counts.min()) <= 0:
        raise AssertionError(f"{label}: non-finite pixels or pixels without samples")
    launched(label, set(ROUTE_KERNELS[route_name].values()) if route_name else {"fused"}, iterations)
    return captured


def small_route(ds, env, cam, card):
    """house on the small route: TRACE and SHADE."""
    state = main_path("house", ds, env, cam, SMALL)
    args = state["trace"]
    ref, plain_ms = plain_timed(lambda: cw.trace_plain(*args))
    got = cw.trace_call(*args)
    both = (got["hit"] != 0) & (ref["hit"] != 0)
    check("trace", "house", got, ref, cw.TRACE_INT_NAMES, exact=("nee_pmf", "quad"))
    check("trace", "house_both_hit", {k: got[k] for k in ("fu", "fv")},
          {k: ref[k] for k in ("fu", "fv")}, (), where=both, exact=("fu", "fv"))
    # 7 carry inputs of 4 bytes, the alias and quad rows of 16, 26 outputs
    # of 4 bytes and the quad row; the closest sweep over every primitive
    # and the shadow sweep up to each lane's first hit (the alias draw, uv
    # math and BSDF are left out: the bound stays a lower bound)
    shadow_ops = first_hit_ops(ds, sweep_calls(args)[1])
    n_bytes = N * (4 * len(cw.TRACE_CARRY_IN) + 16 + 16 + 4 * (len(cw.TRACE_OUT_NAMES) - 1) + 16)
    timing("trace", "house", lambda: cw.trace_call(*args), plain_ms,
           bound_ms(n_bytes, N * sweep_ops(ds) + shadow_ops), card)
    args = state["shade"]
    ref, plain_ms = plain_timed(lambda: cw.shade_plain(*args))
    check("shade", "house", _shade_dict(cw.shade_call(*args)), _shade_dict(ref), cw.SHADE_INT_NAMES)
    # its per-lane inputs, the 4-word quad row and 22 outputs
    timing("shade", "house", lambda: cw.shade_call(*args), plain_ms,
           bound_ms(N * 4 * (len(cw.SHADE_IN) + 4 + len(cw.SHADE_OUT_NAMES)), 0), card)


def _shade_dict(result):
    carry, active, hitmask = result
    return dict(carry, active=active, hitmask=hitmask)


def _as_int(outputs):
    return {k: v.to(torch.int32) if v.dtype == torch.bool else v for k, v in outputs.items()}


def composed_body(ds, sky_host, cam, card, dev):
    """house through the composed body (the float32 legacy quad): FUSED."""
    env_f32 = device_environment(sky_host, dev, "float32")
    calls, captured = [0], {}
    fused = ci.fused_call

    def capturing(*args):
        if calls[0] == CAPTURE_IT:  # one call an iteration
            captured["fused"] = args
        calls[0] += 1
        return fused(*args)

    with mock.patch.object(ci, "fused_call", capturing):
        main_path("house_composed", ds, env_f32, cam, None)
    scene, ro, rd, nd = captured["fused"]
    del env_f32
    ref, plain_ms = plain_timed(lambda: _as_int(intersect.trace_attrs(scene, *ro, *rd, *nd)))
    check("fused", "house_composed", _as_int(fused(scene, ro, rd, nd)), ref, {"did_hit", "occ"})
    # 9 inputs and 16 outputs of 4 bytes a lane; the closest sweep over
    # the padded table and the shadow sweep up to each lane's first hit
    hit = intersect.closest_sweep(scene, *ro, *rd)
    t_safe = torch.where(hit[1] >= 0, hit[0], 0.0)
    p = tuple(ro[k] + rd[k] * t_safe for k in range(3))
    ops = N * sweep_ops(scene) + first_hit_ops(scene, (*p, *nd))
    timing("fused", "house_composed", lambda: fused(scene, ro, rd, nd), plain_ms,
           bound_ms(N * 25 * 4, ops), card)


def scan_path(ds, env, cam, card):
    """house through the scan integrator: CLOSEST and ANY once a bounce,
    held on the queries of bounces 0 and 3 of that sample (bounce 0's
    times and bounds go to the kernels line)."""
    reset_launches()
    states = capture_scan(ds, env, cam, SIZE, BOUNCES)
    torch.cuda.synchronize()
    launched("house_scan", {"closest", "any"}, BOUNCES)
    for bounce, state in states.items():
        label = f"house_scan{bounce}"
        ro, rd, live = state["closest"]
        p, nd, mask = state["any"]
        live, mask = live.to(torch.int32), mask.to(torch.int32)
        ref, c_plain = plain_timed(lambda: intersect.closest_record(ds, ro, rd, live))
        got = ci.closest_call(ds, ro, rd, live)
        check("closest", label, got, ref, ci.CLOSEST_INT_NAMES,
              exact=("t", "type", "index", "material_id"))
        dead = live == 0
        miss = {"t": intersect.INF, "type": -1, "index": 0, "material_id": 0}
        not_miss = sum(
            int((_bits(got[k])[dead] != _bits(torch.full_like(got[k][dead], miss.get(k, 0)))).sum())
            for k in ci.CLOSEST_OUT_NAMES)
        if not_miss:
            raise AssertionError(f"closest on {label}: {not_miss} dead-lane values are not the miss record")
        occ_ref, a_plain = plain_timed(lambda: intersect.any_sweep(ds, *p, *nd) & (mask != 0))
        occ = ci.any_call(ds, p, nd, mask)
        check("any", label, {"occ": occ.to(torch.int32)}, {"occ": occ_ref.to(torch.int32)}, {"occ"},
              exact=("occ",))
        if bounce == 0:
            c_bound, a_bound, n_live, n_mask = scan_bounds(ds, state)
            timing("closest", label, lambda: ci.closest_call(ds, ro, rd, live), c_plain, c_bound, card,
                   live=n_live)
            timing("any", label, lambda: ci.any_call(ds, p, nd, mask), a_plain, a_bound, card,
                   masked=n_mask)


def big_mesh_route(label, ds, env, cam, card, route_name, timed):
    """A big-mesh route's four kernels on its main path's state; the
    kernels of `timed` get their times and bounds."""
    state = main_path(label, ds, env, cam, route_name)
    for key, kernel in ROUTE_KERNELS[route_name].items():
        kfn, pfn = route_kernels(ds)[key]
        args = state[key]
        walk = {}
        if kernel.startswith("bvh_"):
            ref, plain_ms = plain_timed(lambda: pfn(*args, counts=walk))
        else:
            ref, plain_ms = plain_timed(lambda: pfn(*args))
        got = kfn(*args)
        if key == "env_draw":
            check(kernel, label, got, ref, {"state"}, exact=ENV_DRAW_EXACT)
            # the state in, the 4-word alias row, 7 outputs
            bound = bound_ms(N * 4 * (1 + 4 + len(cw.ENV_DRAW_OUT_NAMES)), 0)
        elif key == "big_shade":
            check(kernel, label, _shade_dict(got), _shade_dict(ref), cw.SHADE_INT_NAMES)
            # its per-lane inputs, the 4-word quad row and 22 outputs; the
            # winner and material tables once
            bound = bound_ms(N * 4 * (len(cw.BIG_SHADE_IN) + 4 + len(cw.SHADE_OUT_NAMES))
                             + 4 * (ds.winner.numel() + ds.materials.numel()), 0)
        else:
            closest = key == "closest"
            names = ("t", "type", "index") if closest else ("occ",)
            got = dict(zip(names, got if closest else (got,)))
            ref = dict(zip(names, ref if closest else (ref,)))
            # the chunked kernels cull per lane: live (masked) lanes only;
            # the walks hold every lane
            where = None if route_name == BVH else args[3] != 0
            check(kernel, label, got, ref, {"type", "index", "occ"}, where=where,
                  exact=names if route_name == BVH else ())
            bound = (bvh_bound(ds, N, walk, closest) if route_name == BVH
                     else chunked_bound(ds, args, closest))
        if kernel in timed:
            extra = bound[2] if len(bound) > 2 else {}
            timing(kernel, label, lambda: kfn(*args), plain_ms, bound, card, **extra)


def bvh_scene(sky, dev):
    """suzanne_xxhi on the BVH route: the mesh generated when absent, the
    native builder loaded and the tree shallower than the walks' stack."""
    mesh = os.path.join(ROOT, "assets", "suzanne_xxhi.obj")
    if not os.path.exists(mesh):
        subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "subdivide_obj.py"),
                        str(XXHI_LEVEL), mesh], check=True, cwd=ROOT, timeout=600)
    ds, env, cam = scene_setup("suzanne_xxhi", dev, sky, with_bvh="auto")
    b = ds.bvh
    log("bvh_build", scene="suzanne_xxhi", route=route(ds), native=accel_native.available(),
        primitives=b.prim_type.shape[0], nodes=b.num_nodes, depth=b.depth)
    if route(ds) != BVH or not accel_native.available():
        raise AssertionError("suzanne_xxhi is not on the BVH route, or the native builder did not load")
    if not b.depth < accel_bvh.TRAVERSAL_STACK_DEPTH:
        raise AssertionError(f"suzanne_xxhi's BVH is {b.depth} deep")
    return ds, env, cam


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this gate needs a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda)
    build_start = time.perf_counter()
    _kernels.library()
    log("build", seconds=f"{time.perf_counter() - build_start:.2f}",
        flags=repr(" ".join(_kernels.NVCC_FLAGS)))
    sky_host = Environment.from_texture("sky", procedural_sky(2048, 1024))
    sky = device_environment(sky_host, dev)

    ds, env, cam = scene_setup("house", dev, sky)
    small_route(ds, env, cam, card)
    composed_body(ds, sky_host, cam, card, dev)
    scan_path(ds, env, cam, card)
    ds, env, cam = scene_setup("suzanne_hi", dev, sky, with_bvh=False)
    big_mesh_route("suzanne_hi", ds, env, cam, card, CHUNKED,
                   {"env_draw", "chunked_closest", "chunked_any", "big_shade"})
    del ds
    ds, env, cam = bvh_scene(sky, dev)
    big_mesh_route("suzanne_xxhi", ds, env, cam, card, BVH, {"bvh_closest", "bvh_any"})
    del ds

    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(LAUNCHES[name].values()), "launches_by_path": LAUNCHES[name],
         "max_abs_err": ERRORS[name]["abs"][0], "max_rel_err": ERRORS[name]["rel"][0],
         "max_abs_output": ERRORS[name]["abs"][1], "max_rel_output": ERRORS[name]["rel"][1],
         "ms": TIMES[name][0], "plain_ms": TIMES[name][1],
         "bound_ms": BOUNDS[name][0], "bound_by": BOUNDS[name][1], "library_ms": None}
        for name, (source, replaces) in KERNEL_SOURCES.items()
    ]
    log("smoke", seconds=f"{time.perf_counter() - start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
