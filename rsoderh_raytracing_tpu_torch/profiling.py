"""Where the main path's device time goes, on a GPU.

    python -m rsoderh_raytracing_tpu_torch.profiling [--out DIR]

Runs house.toml at 2048x2048, 8 bounces, procedural_sky(2048, 1024), as
chip_smoke.py does, and prints one line per measurement:

- ``card``: name and power limit as nvidia-smi reports them;
- ``kernel``: one free-run call of budget 16 under torch.profiler; device
  ms per iteration for each kernel name (the 12 largest), then a
  ``group`` line for TRACE, SHADE, the row gathers (index_select) and the
  other glue, kernel launches per iteration, and the device busy share:
  the union of device intervals over the window from the first one's
  start to the last one's end (the window holds the call's set-up and
  its final host check too);
- ``fmad``: TRACE and SHADE ms at 2048^2 lanes for the library built with
  the default nvcc flags and for one built with ``-fmad=false`` toggled,
  in the order default, other, other, default; each one's parity with
  the plain versions; and Mrays/s of a budget-64 free-run call with each.

The Chrome trace is written under DIR (default ``build/profile``).
Needs one CUDA device; imports nothing of jax.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import _kernels
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.wavefront import NO_LIMIT, Wavefront, render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 2048
BOUNCES = 8
FMAD_OFF = "-fmad=false"
RTOL, ATOL = 1e-4, 1e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def house_setup(device):
    """(device scene, environment, camera) of the main path's house run."""
    house = load_scene(os.path.join(ROOT, "assets", "scenes", "house.toml"))
    env = device_environment(Environment.from_texture("sky", procedural_sky(2048, 1024)), device)
    return build_device_scene(house, device), env, camera_pytree(house.camera, device)


def capture_step(wave, it, trace=cw.trace_call, shade=cw.shade_call):
    """Run iteration `it` of `wave` through `trace`/`shade`; returns the
    arguments each was called with, {"trace": ..., "shade": ...}."""
    captured = {}

    def capture(key, fn):
        def wrapped(*args):
            captured[key] = args
            return fn(*args)
        return wrapped

    wave.step(it, trace=capture("trace", trace), shade=capture("shade", shade))
    return captured


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


def _group(name):
    if "trace_kernel" in name:
        return "trace"
    if "shade_kernel" in name:
        return "shade"
    if "gather" in name or "index" in name.lower():
        return "gather"
    return "other_glue"


def kernel_breakdown(trace_path, iterations):
    """Per-kernel and per-group device ms per iteration, kernel launches
    per iteration and the busy share, from an exported Chrome trace."""
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
    groups = collections.Counter()
    for k, v in per_iter.items():
        groups[_group(k)] += v
    launches = sum(e.get("cat") == "kernel" for e in spans) / iterations
    return per_iter, dict(groups), launches, busy / window


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: profiling needs a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    ds, env, cam = house_setup(dev)
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
    trace_path = os.path.join(args.out, "main_path_trace.json")
    prof.export_chrome_trace(trace_path)
    per_iter, groups, launches, busy = kernel_breakdown(trace_path, iterations)
    total = sum(per_iter.values())
    for name, ms in sorted(per_iter.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[kernel] ms_per_iter={ms:.4f} share={ms / total:.4f} name={name[:110]}", flush=True)
    print("[group] iterations=%d total_ms_per_iter=%.4f %s launches_per_iter=%.1f "
          "busy_share=%.4f card=%r" % (
              iterations, total, " ".join(f"{k}_ms={v:.4f}" for k, v in sorted(groups.items())),
              launches, busy, card), flush=True)

    # -fmad=false against FMA contraction, one library each, A B B A.
    flags = list(_kernels.NVCC_FLAGS)
    other = [f for f in flags if f != FMAD_OFF] if FMAD_OFF in flags else flags + [FMAD_OFF]
    libs = {"default": _kernels.library(), "other": _kernels.load(other)}
    labels = {"default": " ".join(flags), "other": " ".join(other)}
    wave = Wavefront(ds, env, cam, zeros, res, NO_LIMIT, 64, BOUNCES)
    for it in range(2):
        wave.step(it)
    captured = capture_step(wave, 2)
    tr_args, sh_args = captured["trace"], captured["shade"]
    tr_ref = cw.trace_plain(*tr_args)
    sh_ref = shade_outputs(cw.shade_plain(*sh_args))
    for key in ("default", "other", "other", "default"):
        with _kernels.using(libs[key]):
            trace_ms = time_ms(lambda: cw.trace_call(*tr_args), 20)
            shade_ms = time_ms(lambda: cw.shade_call(*sh_args), 20)
            tr_shares, tr_abs, _ = cw.parity(cw.trace_call(*tr_args), tr_ref, cw.TRACE_INT_NAMES, RTOL, ATOL)
            sh_shares, sh_abs, _ = cw.parity(shade_outputs(cw.shade_call(*sh_args)), sh_ref,
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
