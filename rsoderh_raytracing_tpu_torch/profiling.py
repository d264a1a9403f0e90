"""Where the main path's device time goes, on a GPU.

    python -m rsoderh_raytracing_tpu_torch.profiling [--path loop|scan|scan-image] [--scene NAME]
                                                    [--out DIR] [--sass]

Runs assets/scenes/NAME.toml (default house) at 2048x2048, 8 bounces,
procedural_sky(2048, 1024), as chip_smoke.py does, and prints one line
per measurement. With ``--path loop`` (the default), the free-run kernel
loop:

- ``card``: name and power limit as nvidia-smi reports them;
- ``kernel``: one free-run call of budget 16 under torch.profiler; device
  ms per iteration for each kernel name (the 12 largest), then a
  ``group`` line for the kernels (TRACE and SHADE, or CHUNKED_CLOSEST,
  CHUNKED_ANY and BIG_SHADE on the big-mesh route), the row gathers
  (index_select) and the other glue, kernel launches per iteration, and
  the device busy share: the union of device intervals over the window
  from the first one's start to the last one's end (the window holds the
  call's set-up and its final host check too);
- ``cull`` (big-mesh route): on the loop state of the third iteration,
  the slab tests and the (lane, chunk) pairs that pass the cull of each
  chunked kernel, from a plain pass (``cull_counts``), and the bound
  they give;
- ``sweep`` (small route): on the loop state of the third iteration,
  TRACE, CLOSEST, ANY and FUSED ms at 2048^2 lanes (CUDA events), the
  sweeps on TRACE's rays as ``sweep_calls`` builds them;
- ``fmad`` (small route): TRACE and SHADE ms at 2048^2 lanes for the
  library built with the default nvcc flags and for one built with
  ``-fmad=false`` toggled, in the order default, other, other, default;
  each one's parity with the plain versions; and Mrays/s of a budget-64
  free-run call with each.

With ``--path scan``, the scan integrator (``Renderer.step()``):

- ``scan_kernel``/``scan_group``: one step under torch.profiler; device
  ms and launches a bounce by kernel name and by group (CLOSEST, ANY,
  index_select, elementwise, the rest), and the busy share;
- ``scan_gathers``: index_select calls a bounce whose source is a table
  of the DeviceScene (``scene_gathers``);
- ``scan``: seconds a sample and Mrays/s over a few steps;
- ``scan_state``: CLOSEST and ANY ms (CUDA events) on the integrator's
  own queries at bounces 0 and 3 (``capture_scan``), the live and masked
  lane counts and the bounds of ``scan_bounds``.

With ``--path scan-image``, ``scan_image``: the relative RMSE of each of
the first 16 samples of the scan integrator (``render_sample``) at
256x256, rendered on the card through the kernels, against the same
sample rendered on the CPU through the plain versions, and of their
means. Run as ``PYTHONPATH=OLD python rsoderh_raytracing_tpu_torch/profiling.py
--path scan-image`` it reads the package of the tree OLD instead.

``--sass`` prints, for each kernel of the built library, the SASS
instruction count by opcode and each loop's (backward branch's) body,
from ``cuobjdump -sass``; the dump goes under DIR.

The Chrome trace is written under DIR (default ``build/profile``).
Needs one CUDA device; imports nothing of jax.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import shutil
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.env.environment import (
    Environment, EnvironmentMaps, device_environment,
)
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import _kernels
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import envmap, intersect, rng
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree, render_sample
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import NO_LIMIT, Wavefront, render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import CHUNKED, TRI_CHUNK, build_device_scene, route

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 2048
BOUNCES = 8
IMAGE_SIZE = 256  # --path scan-image
IMAGE_SAMPLES = 16
FMAD_OFF = "-fmad=false"
RTOL, ATOL = 1e-4, 1e-5

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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def scene_setup(name, device, env=None):
    """(device scene, environment, camera) of assets/scenes/NAME.toml
    under `env` (default procedural_sky(2048, 1024), the bench's sky)."""
    scene = load_scene(os.path.join(ROOT, "assets", "scenes", f"{name}.toml"))
    if env is None:
        env = device_environment(Environment.from_texture("sky", procedural_sky(2048, 1024)), device)
    return build_device_scene(scene, device), env, camera_pytree(scene.camera, device)


# The kernels of each route: Wavefront.step's keyword, the wrapper and
# its plain version.
KERNELS = {
    "trace": (cw.trace_call, cw.trace_plain),
    "shade": (cw.shade_call, cw.shade_plain),
    "closest": (ci.chunked_closest_call, intersect.chunked_closest_plain),
    "occlusion": (ci.chunked_any_call, intersect.chunked_any_plain),
    "big_shade": (cw.big_shade_call, cw.big_shade_plain),
}


def capture_step(wave, it, plain=False):
    """Run iteration `it` of `wave` through the wrappers (or, with
    `plain`, the plain versions); returns the arguments each kernel of
    the route was called with, by Wavefront.step keyword."""
    captured = {}

    def capture(key, fn):
        def wrapped(*args):
            captured[key] = args
            return fn(*args)
        return wrapped

    wave.step(it, **{k: capture(k, fns[1] if plain else fns[0]) for k, fns in KERNELS.items()})
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
    nd = tuple(c.contiguous() for c in envmap.trace_glue(rng.from_bits(carry["state"]), env, *rd)[4])
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
    """Operations of one closest sweep of a lane over every primitive of
    a scene within the unroll budget."""
    return (scene.sph_radius.shape[0] * OPS_SPHERE + scene.pln_valid.shape[0] * OPS_PLANE
            + scene.tri_valid.shape[0] * OPS_TRIANGLE)


def first_hit_ops(scene, rays, extents=None):
    """Operations an occlusion sweep of `rays` (6 (n,) components) needs
    on a scene within the unroll budget: each lane's primitive tests in
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
    on `args` (the wrapper's arguments): 7 four-byte inputs a lane and 3
    (or 1) outputs, the tables once; the unrolled step on every lane,
    then the slab tests and 64 primitive tests a passing pair."""
    _, ro, rd, mask = args
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


def shade_outputs(result):
    """shade_call/shade_plain's (carry, active, hitmask) as one dict."""
    carry, active, hitmask = result
    return dict(carry, active=active, hitmask=hitmask)


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


def _scan_group(name):
    for kernel in ("chunked_closest_kernel", "chunked_any_kernel", "closest_kernel", "any_kernel"):
        if kernel in name:
            return kernel[: -len("_kernel")]
    if "gather" in name or "indexselect" in name.lower():
        return "index_select"
    if "elementwise" in name:
        return "elementwise"
    return "rest"


def _group(name):
    for kernel in ("trace_kernel", "big_shade_kernel", "chunked_closest_kernel",
                   "chunked_any_kernel", "shade_kernel"):
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


def scan_calls(scene, state):
    """(CLOSEST call, ANY call) on a capture_scan state, each a thunk
    through the wrapper with the state's lane mask."""
    ro, rd, live = state["closest"]
    p, nd, mask = state["any"]
    live, mask = live.to(torch.int32).contiguous(), mask.to(torch.int32).contiguous()
    return (lambda: ci.closest_call(scene, ro, rd, live)), (lambda: ci.any_call(scene, p, nd, mask))


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


def scan_main(args, dev, card) -> int:
    """--path scan: the scan integrator's bounce (see the module doc)."""
    ds, env, cam = scene_setup(args.scene, dev)
    sky_host = Environment.from_texture("sky", procedural_sky(2048, 1024))
    scene = load_scene(os.path.join(ROOT, "assets", "scenes", f"{args.scene}.toml"))
    renderer = Renderer(scene, SIZE, SIZE, environments=EnvironmentMaps([sky_host]),
                        max_bounces=BOUNCES, device=dev)
    renderer.step()  # build + warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        renderer.step()
        torch.cuda.synchronize()
    trace_path = os.path.join(args.out, f"{args.scene}_scan_trace.json")
    prof.export_chrome_trace(trace_path)
    group_launches = {}
    per_bounce, groups, launches, busy = kernel_breakdown(trace_path, BOUNCES, _scan_group,
                                                          group_launches)
    total = sum(per_bounce.values())
    for name, ms in sorted(per_bounce.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[scan_kernel] ms_per_bounce={ms:.4f} share={ms / total:.4f} name={name[:110]}",
              flush=True)
    print("[scan_group] scene=%s bounces=%d total_ms_per_bounce=%.4f %s %s launches_per_bounce=%.1f "
          "busy_share=%.4f card=%r" % (
              args.scene, BOUNCES, total,
              " ".join(f"{k}_ms={v:.4f}" for k, v in sorted(groups.items())),
              " ".join(f"{k}_launches={v:.2f}" for k, v in sorted(group_launches.items())),
              launches, busy, card), flush=True)
    gathers = scene_gathers(renderer.device_scene, renderer.step)
    print(f"[scan_gathers] scene={args.scene} scene_table_index_selects_per_bounce="
          f"{gathers / BOUNCES:.2f} card={card!r}", flush=True)

    steps = 3
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(steps):
        renderer.step()
    torch.cuda.synchronize()
    per_sample = (time.perf_counter() - start) / steps
    _, stats = render_sample(ds, env, cam, 0, (SIZE, SIZE), BOUNCES, with_stats=True)
    rays = int(stats["closest_rays"] + stats["shadow_rays"])
    print(f"[scan] scene={args.scene} steps={steps} s_per_sample={per_sample:.4f} "
          f"mrays_per_s={rays / per_sample / 1e6:.2f} card={card!r}", flush=True)

    states = capture_scan(ds, env, cam, SIZE, BOUNCES)
    for bounce, state in states.items():
        closest, occlusion = scan_calls(ds, state)
        (c_ms, c_by), (a_ms, a_by), n_live, n_mask = scan_bounds(ds, state)
        print(f"[scan_state] scene={args.scene} bounce={bounce} lanes={SIZE * SIZE} live={n_live} "
              f"masked={n_mask} closest_ms={time_ms(closest, 20):.4f} any_ms={time_ms(occlusion, 20):.4f} "
              f"closest_bound_ms={c_ms:.4f} closest_bound_by={c_by} any_bound_ms={a_ms:.4f} "
              f"any_bound_by={a_by} card={card!r}", flush=True)
    return 0


def scan_image_main(args, dev, card) -> int:
    """--path scan-image: the scan integrator's IMAGE_SIZE^2 samples on the
    card against the CPU's (see the module doc). Uses only Renderer and
    render_sample, so it also reads a package of an earlier tree put
    first on PYTHONPATH."""
    scene = load_scene(os.path.join(ROOT, "assets", "scenes", f"{args.scene}.toml"))
    sky = EnvironmentMaps([Environment.from_texture("sky", procedural_sky(2048, 1024))])
    res = (IMAGE_SIZE, IMAGE_SIZE)
    images = []
    for device in (dev, "cpu"):
        r = Renderer(scene, *res, environments=sky, max_bounces=BOUNCES, device=device)
        images.append(np.stack([
            render_sample(r.device_scene, r._device_env(), r._camera(), s, res, BOUNCES).cpu().numpy()
            for s in range(IMAGE_SAMPLES)]))
    card_img, cpu_img = images

    def rel(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))

    per = ",".join(f"{rel(a, b):.3e}" for a, b in zip(card_img, cpu_img))
    package = os.path.dirname(os.path.dirname(render_sample.__code__.co_filename))
    print(f"[scan_image] scene={args.scene} size={IMAGE_SIZE} package={package} "
          f"rel_rmse_per_sample={per} "
          f"rel_rmse_mean_{IMAGE_SAMPLES}={rel(card_img.mean(0), cpu_img.mean(0)):.3e} "
          f"card={card!r}", flush=True)
    return 0


# One instruction of cuobjdump's SASS: address, predicate, opcode, operands.
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_report(lib_path, out_dir, kernels=("closest_kernel", "any_kernel", "fused_kernel",
                                            "trace_kernel")):
    """{kernel: {"total", "predicated", "ops": Counter by opcode, "loops":
    [(start, end, instructions, Counter)]}} of the library's SASS, from
    cuobjdump; the dump is written to out_dir/sass.txt."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    with open(os.path.join(out_dir, "sass.txt"), "w") as f:
        f.write(text)
    report = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        key = next((k for k in kernels if k in name and not ("chunked" in name and "chunked" not in k)
                    and not ("big_" in name and "big_" not in k)), None)
        if key is None:
            continue
        insts = [(int(m.group(1), 16), m.group(3), bool(m.group(2)), m.group(4))
                 for m in _SASS_LINE.finditer(block)]
        loops = []
        for addr, op, _, rest in insts:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and target and int(target.group(1), 16) < addr:
                body = [o for a, o, _, _ in insts if int(target.group(1), 16) <= a <= addr]
                loops.append((int(target.group(1), 16), addr, len(body),
                              collections.Counter(o.split(".")[0] for o in body)))
        report[key] = {
            "total": len(insts), "predicated": sum(p for _, _, p, _ in insts),
            "ops": collections.Counter(o.split(".")[0] for _, o, _, _ in insts), "loops": loops,
        }
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("loop", "scan", "scan-image"), default="loop",
                        help="the free-run kernel loop, the scan integrator, or its image "
                             "on the card against the CPU's")
    parser.add_argument("--scene", default="house", help="a scene of assets/scenes")
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    parser.add_argument("--sass", action="store_true", help="the SASS instruction counts")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: profiling needs a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    if args.sass:
        for kernel, r in sass_report(_kernels.build(), args.out).items():
            top = " ".join(f"{k}={v}" for k, v in r["ops"].most_common(14))
            print(f"[sass] kernel={kernel} instructions={r['total']} predicated={r['predicated']} {top}",
                  flush=True)
            for start, end, n, ops in r["loops"]:
                body = " ".join(f"{k}={v}" for k, v in ops.most_common(12))
                print(f"[sass_loop] kernel={kernel} start=0x{start:04x} end=0x{end:04x} "
                      f"instructions={n} {body}", flush=True)
    if args.path == "scan":
        return scan_main(args, dev, card)
    if args.path == "scan-image":
        return scan_image_main(args, dev, card)
    ds, env, cam = scene_setup(args.scene, dev)
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

    tr_args, sh_args = captured["trace"], captured["shade"]
    calls = {"trace": lambda: cw.trace_call(*tr_args)}
    calls.update({k: fns[0] for k, fns in sweep_calls(tr_args)[0].items()})
    print(f"[sweep] scene={args.scene} lanes={SIZE * SIZE} "
          + " ".join(f"{k}_ms={time_ms(fn, 20):.4f}" for k, fn in calls.items())
          + f" card={card!r}", flush=True)

    # -fmad=false against FMA contraction, one library each, A B B A.
    flags = list(_kernels.NVCC_FLAGS)
    other = [f for f in flags if f != FMAD_OFF] if FMAD_OFF in flags else flags + [FMAD_OFF]
    libs = {"default": _kernels.library(), "other": _kernels.load(other)}
    labels = {"default": " ".join(flags), "other": " ".join(other)}
    tr_ref = cw.trace_plain(*tr_args)
    sh_ref = shade_outputs(cw.shade_plain(*sh_args))
    for key in ("default", "other", "other", "default"):
        with _kernels.using(libs[key]):
            trace_ms = time_ms(lambda: cw.trace_call(*tr_args), 20)
            shade_ms = time_ms(lambda: cw.shade_call(*sh_args), 20)
            tr_shares, (tr_abs, _), _ = cw.parity(cw.trace_call(*tr_args), tr_ref, cw.TRACE_INT_NAMES, RTOL, ATOL)
            sh_shares, (sh_abs, _), _ = cw.parity(shade_outputs(cw.shade_call(*sh_args)), sh_ref,
                                             cw.SHADE_INT_NAMES, RTOL, ATOL)
            torch.cuda.synchronize()
            start = time.perf_counter()
            _, _, stats = render_freerun(ds, env, cam, zeros, res, 64, BOUNCES, with_stats=True)
            rays = int(stats["closest_rays"] + stats["shadow_rays"])
            seconds = time.perf_counter() - start
        print(f"[fmad] lib={key} fmad_false={FMAD_OFF in labels[key].split()} "
              f"trace_ms={trace_ms:.4f} shade_ms={shade_ms:.4f} "
              f"trace_min_share={min(tr_shares.values()):.6f} trace_worst={min(tr_shares, key=tr_shares.get)} "
              f"trace_max_abs={tr_abs:.3e} "
              f"shade_min_share={min(sh_shares.values()):.6f} shade_worst={min(sh_shares, key=sh_shares.get)} "
              f"shade_max_abs={sh_abs:.3e} "
              f"mrays_per_s={rays / seconds / 1e6:.2f} card={card!r}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
