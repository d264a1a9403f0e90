"""One run of one cell:

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s, from the start of the process): the scene
files (a generated mesh once per checkout, build/portbench/), the port's
scene, environment and Renderer (the span scene_build_s), the seeded
resume or the first camera, and one warm-up call or frame of the cell's
own shape, which builds or loads the kernels (build/kernels/,
build/native/). Then a closed loop for --seconds: each call or frame is
sent when the previous one has returned. A render call is
step_freerun(iterations) accumulating into the film; a frame is a seeded
camera step, step_freerun(iterations) and the tonemapped film on the
host.

With --trace 1 the run also profiles a bounded stretch of the window
(torch.profiler: one call, or a few frames), copies one iteration's loop
state to count what the kernels need, and prints the cell's per-layer
metrics instead of its end-to-end ones. After the window: the device's
memory peak, the program's state freed, then the comparison with the
plain reference (portbench/check.py), which decides `correct`.

The last line of standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key. --device cpu (with --width, --height,
--bounces, --iterations) rehearses a cell on the CPU at a tiny size; the
run then reports platform cpu and its numbers are no device metrics.
--control bf16 replaces the program's answers by the reference's own in
bfloat16, the lower-precision control of the comparison.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

from portbench import stats

FORBIDDEN = ("jax", "jaxlib", "flax", "rsoderh_raytracing_tpu")


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--bounces", type=int, default=0)
    p.add_argument("--iterations", type=int, default=0)
    p.add_argument("--control", choices=("bf16",), default=None)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _card():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def read_trace(path):
    """Device operations [(name, device, start s, end s, correlation)],
    host operations [(name, start, end)]: the CPU ops where the profile
    recorded them, else the CUDA runtime calls; annotation spans {name:
    (start, end)}; and the host time of each launch by correlation id,
    from a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, cpu, runtime, spans, launch = [], [], [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        s, d = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in stats.DEVICE_CATS:
            ops.append((e["name"], int(args.get("device", e.get("pid", 0))), s, s + d, args.get("correlation")))
        elif cat == "user_annotation":
            spans[e["name"]] = (s, s + d)
        elif cat == "cpu_op":
            cpu.append((e["name"], s, s + d))
        elif cat == "cuda_runtime":
            runtime.append((e["name"], s, s + d))
            if "correlation" in args:
                launch[args["correlation"]] = s
    return ops, cpu or runtime, spans, launch


@contextlib.contextmanager
def profiled(torch, device, store, key, tmpdir, host_ops):
    """Profile the block under the annotation `key`; store[key] gets
    read_trace's tuple. Without host_ops the card's activity alone is
    recorded (the CUDA runtime calls and the device's operations): a
    profile that records every CPU op slows the host's enqueue, which
    sets the pace of a host-bound call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    if device.type != "cuda":
        acts = [ProfilerActivity.CPU]
    else:
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    if device.type == "cuda":
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(key):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize()
    path = os.path.join(tmpdir, f"portbench_{key}.json")
    prof.export_chrome_trace(path)
    store[key] = read_trace(path)
    os.remove(path)


def main(argv, t0) -> int:
    args = parse(argv)
    from portbench import spec

    cell = spec.cell(args.workload)
    chips = int(cell["entry"]["chips"])
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmpdir = tempfile.gettempdir()

    from portbench import check, counts, traffic
    from portbench.program import Program
    from portbench.reference.env import load_environment
    from portbench.reference.scene import camera_tensors, load_scene
    from torch.profiler import record_function

    mix = cell["mix"]
    is_frame = mix["kind"] == "frame"
    prog = Program(cell, args, device, tmpdir)
    w, h = prog.width, prog.height
    pixel_np = traffic.check_pixels(args.seed, mix, w, h)
    pixel = torch.from_numpy(pixel_np).to(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            for d in range(chips):
                torch.cuda.synchronize(d)

    run = dict(kind=mix["kind"], scene_build_s=prog.scene_build_s, cards=prog.cards,
               lanes=w * h * prog.slots, iterations_launched=max(prog.iterations, 1) + prog.bounces - 1,
               trace=None, capture=None, calls=[], frames=[])
    store = {}
    trace_at = int(mix.get("trace_at", 1))
    trace_n = int(mix.get("trace_count", 1))
    snaps = []
    if is_frame:
        start_camera = (prog.camera0.pos, prog.camera0.yaw, prog.camera0.pitch)
        path = traffic.fly_path(args.seed, mix, start_camera)
        prog.frame(start_camera)
    else:
        base = traffic.base_counts(args.seed, mix, w, h)
        prog.resume(base)
        base_t = torch.from_numpy(base.reshape(-1)).to(device)
        snaps.append((torch.zeros((pixel.shape[0], 3), device=device), base_t.index_select(0, pixel), None))
        prog.call()
        snaps.append(prog.snapshot(pixel))
    sync()
    run["setup_s"] = time.perf_counter() - t0
    if cuda:
        from rsoderh_raytracing_tpu_torch.ops import _kernels

        built = {k: _kernels.BUILD_INFO.get(k) for k in ("seconds", "cached")}
        print(f"portbench: kernels {built}, set-up {run['setup_s']} s", file=sys.stderr)
    total0 = None if is_frame else prog.total_samples()

    start = time.perf_counter()
    while True:
        i = len(run["frames"] if is_frame else run["calls"])
        ctx = contextlib.ExitStack()
        if args.trace and i == trace_at:
            ctx.enter_context(profiled(torch, device, store, "portbench.window", tmpdir, host_ops=False))
        if args.trace and "capture_iteration" in mix and i == trace_at + trace_n:
            ctx.enter_context(profiled(torch, device, store, "portbench.capture_call", tmpdir, host_ops=True))
            ctx.enter_context(prog.capture(int(mix["capture_iteration"]), store, record_function))
        if is_frame:
            with ctx:
                for _ in range(trace_n if args.trace and i == trace_at else 1):
                    cam = next(path)
                    f0 = time.perf_counter()
                    image, film_s = prog.frame(cam)
                    f1 = time.perf_counter()
                    run["frames"].append(dict(start=f0, end=f1, film_s=film_s, camera=cam,
                                              values=image.reshape(-1, 3)[pixel_np].copy(),
                                              closest_rays=prog.renderer.last_stats["closest_rays"]))
        else:
            with ctx:
                c0 = time.perf_counter()
                st = prog.call()
                c1 = time.perf_counter()
            snaps.append(prog.snapshot(pixel))
            run["calls"].append(dict(start=c0, end=c1, **st))
        done = run["frames"] if is_frame else run["calls"]
        if time.perf_counter() - start >= args.seconds and len(done) > trace_at + trace_n:
            break
    end = (run["frames"] if is_frame else run["calls"])[-1]["end"]
    run["window"] = (start, end)
    if not is_frame:
        run["samples"] = int(prog.total_samples() - total0)
    sync()
    peak = max((torch.cuda.max_memory_allocated(d) for d in range(chips)), default=0) if cuda else 0

    if "portbench.window" in store:
        ops, host, spans, _ = store["portbench.window"]
        # from the first host call the profile holds (a CPU op, or a CUDA
        # runtime call where only the card was recorded) to the end of the
        # last device operation
        win = spans.get("portbench.window") or (min(h[1] for h in host), max(o[3] for o in ops))
        devs = sorted({o[1] for o in ops}) or [0]
        run["trace"] = dict(ops=[o[:4] for o in ops], host=host, window=win, devices=devs,
                            iterations=run["iterations_launched"] * (1 if not is_frame else trace_n),
                            busy=stats.device_busy([o[:4] for o in ops], win, devs))
    ref_scene = load_scene(prog.scene_file, device)
    ref_env = load_environment(os.path.join(spec.ROOT, cell["config"]["environment"]), device,
                               os.path.join(spec.ROOT, "build", "portbench", "native"))
    if "carry" in store:
        ops, _, spans, launch = store["portbench.capture_call"]
        lo, hi = spans["portbench.capture"]
        kernels = [(n, e - s) for n, _, s, e, corr in ops if lo <= launch.get(corr, -1.0) <= hi]
        cap = dict(kernels=kernels)
        if prog.renderer.intersector == "bvh":
            (cb, co), (ab, ao), walked = counts.bvh_counts(store["carry"], store["bvh"], ref_scene, ref_env)
            cap["bvh_walks"] = dict(
                least=stats.least_seconds(cb, co)[0] + stats.least_seconds(ab, ao)[0],
                seconds=sum(d for n, d in kernels if stats.kernel_group(n) in ("bvh_closest", "bvh_any")),
                walked=walked)
        else:
            tb, to = counts.trace_counts(store["carry"], ref_scene, ref_env)
            cap["trace"] = dict(least=stats.least_seconds(tb, to)[0],
                                seconds=sum(d for n, d in kernels if stats.kernel_group(n) == "trace"))
        run["capture"] = cap
        store.pop("carry")
        store.pop("bvh")

    # the program's answers, then its state freed before the reference runs
    budget, bounces = prog.iterations, prog.bounces
    if is_frame:
        picked = traffic.pick(args.seed, int(mix["check_frames"]), len(run["frames"]))
        answers = []
        for k in picked:
            fr = run["frames"][k]
            pos, yaw, pitch = fr["camera"]
            answers.append(dict(pixel=pixel, values=torch.from_numpy(fr["values"]).to(device),
                                camera=camera_tensors(pos, yaw, pitch, ref_scene.camera[3], device)))
    else:
        picked = [0] + [k + 1 for k in traffic.pick(args.seed, int(mix["check_calls"]), len(run["calls"]))]
        answers = []
        for j in picked:
            (s0, c0_, sh0), (s1, c1_, sh1) = snaps[j], snaps[j + 1]
            slots = prog.slots
            if slots == 1:
                before, after = c0_[None], c1_[None]
            else:
                before = sh0 if sh0 is not None else torch.stack(
                    [(c0_ + (slots - 1 - s)) // slots for s in range(slots)])
                after = sh1
            answers.append(dict(pixel=pixel, base=before, counts=after - before, film_counts=c1_ - c0_,
                                sums=s1 - s0, film_after=s1))
    rays = sum(c["closest_rays"] + c["shadow_rays"] for c in run["calls"])
    cam0 = camera_tensors(*ref_scene.camera, device)
    card = _card() if cuda else "cpu"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    prog.close()
    del prog, snaps
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the benchmark may not load: {', '.join(bad)}", file=sys.stderr)
        return 3

    ref = dict(scene=ref_scene, env=ref_env, width=w, height=h, max_bounces=bounces,
               formulas=cell["config"]["leaf_formulas"])
    if is_frame:
        if args.control:
            answers = [dict(f, values=v) for f, v in
                       zip(answers, check.frame_answers(ref, answers, budget, bf16=True))]
        compared = {"pixel_wrong_pct": check.compare_frames(answers, check.frame_answers(ref, answers, budget))}
    else:
        if args.control:
            full = [dict(a, counts=torch.full_like(a["counts"], budget)) for a in answers]
            answers = [dict(a, counts=c, film_counts=c.sum(dim=0), sums=s) for a, (c, s) in
                       zip(answers, check.render_answers(ref, cam0, full, budget, bf16=True))]
        wrong_count, wrong_sum = check.compare_render(answers, check.render_answers(ref, cam0, answers, budget))
        compared = {"count_wrong_pct": wrong_count, "sum_wrong_pct": wrong_sum}
    limits = spec.limits(args.workload)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in compared.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    wanted = cell["per_layer"] if args.trace else cell["end_to_end"]
    for m in wanted:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(run["frames"] if is_frame else run["calls"])
    if not is_frame:
        lo, hi = run["window"]
        print(f"portbench: {args.workload} card {card}: {attempted} calls, {run['samples']} samples, "
              f"Mrays/s {rays / (hi - lo) / 1e6}, rays per pixel-sample {rays / max(run['samples'], 1)}")
    result = dict(correct=correct, attempted=attempted, failed=0, metrics=metrics,
                  device=dict(platform="gpu" if cuda else "cpu", kind=kind, count=chips,
                              memory_peak_bytes=int(peak)))
    if run["trace"] is not None:
        busy = run["trace"]["busy"]
        lo, hi = run["trace"]["window"]
        result["device"].update(busy_s=sum(busy.values()) / len(busy), window_s=hi - lo)
        ops = run["trace"]["ops"]
        by_name = {}
        for n, _, s, e in ops:
            by_name[n] = by_name.get(n, 0.0) + (min(e, hi) - max(s, lo) if e > lo and s < hi else 0.0)
        result["breakdown"] = dict(
            device_ops=[[n, v] for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:10]],
            idle_gaps=stats.idle_gaps(ops, run["trace"]["host"], (lo, hi), run["trace"]["devices"][0]))
    if run["capture"] is not None:
        shown = {k: v for k, v in run["capture"].items() if k != "kernels"}
        print(f"portbench: capture {json.dumps(shown)}", file=sys.stderr)
    if args.control:
        result["control"] = args.control
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0

