"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path (rsoderh_raytracing_tpu_torch) on the card
and exits non-zero at the first failure. Phases, one line each:

1. device: requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from csrc/ with nvcc;
3. parity: house at 256x256 lanes, loop state after a few plain
   iterations; TRACE against trace_plain and SHADE against shade_plain
   on identical inputs, output by output;
4. main path: house, 2048x2048, 8 bounces, procedural_sky(2048, 1024),
   render_freerun with base counts carried between calls; Mrays/s in all
   and per call, launch counts, peak device memory, the glue/TRACE/SHADE
   time split; parity again on a 2048x2048 loop state, then each
   kernel's time beside its plain version's; writes a PNG under build/;
5. goldens: render_wavefront at 64x64, 8 spp, 4 bounces through the
   kernels against tests/goldens/{default,house}_64_8spp.npy.

Then a JSON line with each kernel's launches, error and times, the card
line again, and last {"ok": true, "device": {...}}. Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from rsoderh_raytracing_tpu_torch import load_scene, write_png  # noqa: E402
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment  # noqa: E402
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import _kernels  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops.tonemap import aces_tonemap, linear_to_srgb  # noqa: E402
from rsoderh_raytracing_tpu_torch.profiling import (  # noqa: E402
    capture_step, card_line, house_setup, shade_outputs, time_ms,
)
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree  # noqa: E402
from rsoderh_raytracing_tpu_torch.render.wavefront import (  # noqa: E402
    NO_LIMIT, Wavefront, render_freerun, render_wavefront,
)
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene  # noqa: E402

# Kernel against plain version on the same card, output by output: an
# integer output must be equal, and a float output isclose(RTOL, ATOL),
# on at least PARITY_MIN of the lanes. Measured on an H100 (700 W): every
# output agrees on every lane (SHADE bitwise, TRACE within 6e-8), so this
# fails a kernel that is wrong in one output on 0.01% of the lanes.
PARITY_MIN = 0.9999
RTOL, ATOL = 1e-4, 1e-5
# Relative RMSE against the CPU-made goldens. The CPU test holds the plain
# path to 5e-4 (tests/test_torch_wavefront.py); on the card the kernels'
# sin/cos/sqrt round as CUDA's libdevice does, and a few paths flip.
# Measured on an H100 (700 W): 1.35e-4 (default), 1.04e-4 (house).
GOLDEN_REL_RMSE_MAX = 1e-3

SIZE = 2048
BOUNCES = 8
TIMED_CALLS = 3
CALL_SECONDS = 15.0  # target device time of one timed call


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check_parity(kernel, lanes, got, ref, int_names):
    """Log and assert the kernel's agreement with its plain version;
    returns the largest absolute float difference."""
    shares, max_abs, max_rel = cw.parity(got, ref, int_names, RTOL, ATOL)
    worst = min(shares, key=shares.get)
    log("parity", kernel=kernel, lanes=lanes,
        int_equal_min=f"{min(shares[k] for k in shares if k in int_names):.6f}",
        float_close_min=f"{min(shares[k] for k in shares if k not in int_names):.6f}",
        worst=worst, max_rel_diff=f"{max_rel:.3e}", max_abs_diff=f"{max_abs:.3e}")
    bad = sorted(k for k, v in shares.items() if v < PARITY_MIN)
    if bad:
        raise AssertionError(f"{kernel} kernel disagrees with its plain version in {bad}")
    return max_abs


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

    start = time.perf_counter()
    ds, env, cam = house_setup(dev)
    setup_seconds = time.perf_counter() - start

    # 3. parity on a real loop state (256x256 lanes, after 3 plain iterations)
    wave = Wavefront(ds, env, cam, 0, (256, 256), NO_LIMIT, 64, BOUNCES)
    for it in range(3):
        wave.step(it, trace=cw.trace_plain, shade=cw.shade_plain)
    small = capture_step(wave, 3, trace=cw.trace_plain, shade=cw.shade_plain)
    max_err = {
        "trace": check_parity("trace", 256 * 256, cw.trace_call(*small["trace"]),
                              cw.trace_plain(*small["trace"]), cw.TRACE_INT_NAMES),
        "shade": check_parity("shade", 256 * 256, shade_outputs(cw.shade_call(*small["shade"])),
                              shade_outputs(cw.shade_plain(*small["shade"])), cw.SHADE_INT_NAMES),
    }

    # 4. main path at 2048^2
    res = (SIZE, SIZE)
    n_pixels = SIZE * SIZE
    start = time.perf_counter()
    _, counts, _ = render_freerun(ds, env, cam, np.zeros(res, np.uint32), res, 16,
                                  BOUNCES, with_stats=True)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - start) / (16 + BOUNCES - 1)
    warm_counts = counts
    budget = int(min(1024, max(16, CALL_SECONDS / per_iter)))
    total_rays, total_spp, image, call_rates = 0, 0.0, None, []
    torch.cuda.reset_peak_memory_stats(dev)
    cw.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(TIMED_CALLS):
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
    launches = dict(cw.LAUNCHES)
    mrays = total_rays / elapsed / 1e6
    log("main", scene="house", size=SIZE, bounces=BOUNCES, budget=budget, calls=TIMED_CALLS,
        seconds=f"{elapsed:.3f}", mrays_per_s=f"{mrays:.2f}",
        per_call_mrays_per_s=",".join(f"{r:.2f}" for r in call_rates),
        rays_per_px_spp=f"{total_rays / (n_pixels * max(total_spp, 1e-9)):.3f}",
        spp=f"{total_spp:.2f}", trace_launches=launches["trace"],
        shade_launches=launches["shade"],
        peak_allocated_mib=f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f}",
        setup_s=f"{setup_seconds:.1f}", card=repr(card))
    if launches["trace"] <= 0 or launches["shade"] <= 0:
        raise AssertionError("the main path did not launch both kernels")
    if not bool(torch.isfinite(image).all()):
        raise AssertionError("non-finite pixels in the main-path image")
    if int(counts.min()) <= 0 or total_rays <= 0:
        raise AssertionError("pixels without samples or no rays traced")

    # time split on a short profiled call
    profile = {}
    render_freerun(ds, env, cam, counts, res, 8, BOUNCES, profile=profile)
    torch.cuda.synchronize()
    split = np.zeros(3)
    for m in profile["marks"]:
        split += [m[0].elapsed_time(m[1]) + m[2].elapsed_time(m[3]),
                  m[1].elapsed_time(m[2]), m[3].elapsed_time(m[4])]
    split /= len(profile["marks"])
    log("split", iterations=len(profile["marks"]), glue_ms=f"{split[0]:.4f}",
        trace_ms=f"{split[1]:.4f}", shade_ms=f"{split[2]:.4f}", card=repr(card))

    # kernel against plain version at the main path's shapes (2048^2 lanes):
    # parity, then time
    wave = Wavefront(ds, env, cam, counts, res, NO_LIMIT, 64, BOUNCES)
    for it in range(2):
        wave.step(it)
    main = capture_step(wave, 2)
    max_err["trace"] = max(max_err["trace"], check_parity(
        "trace", n_pixels, cw.trace_call(*main["trace"]), cw.trace_plain(*main["trace"]),
        cw.TRACE_INT_NAMES))
    max_err["shade"] = max(max_err["shade"], check_parity(
        "shade", n_pixels, shade_outputs(cw.shade_call(*main["shade"])),
        shade_outputs(cw.shade_plain(*main["shade"])), cw.SHADE_INT_NAMES))
    times = {}
    for name, kfn, pfn in (("trace", cw.trace_call, cw.trace_plain),
                           ("shade", cw.shade_call, cw.shade_plain)):
        args = main[name]
        p1 = time_ms(lambda: pfn(*args), 2)
        k1 = time_ms(lambda: kfn(*args), 10)
        k2 = time_ms(lambda: kfn(*args), 10)
        p2 = time_ms(lambda: pfn(*args), 2)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log("timing", kernel=name, lanes=n_pixels, ms=f"{times[name][0]:.4f}",
            plain_ms=f"{times[name][1]:.4f}", card=repr(card))

    png_dir = os.path.join(ROOT, "build")
    os.makedirs(png_dir, exist_ok=True)
    # image sums the timed calls; their samples are counts - warm_counts
    mean_img = image / (counts - warm_counts).clamp_min(1).unsqueeze(-1).to(image.dtype)
    png = linear_to_srgb(aces_tonemap(mean_img)).cpu().numpy()
    write_png(os.path.join(png_dir, "house_2048.png"), png)

    # 5. goldens
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

    src = "rsoderh_raytracing_tpu_torch/csrc/wavefront.cu"
    kernels = [
        {"name": "trace", "route": "cuda", "source": src,
         "replaces": "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:775",
         "launches": launches["trace"], "max_abs_err": max_err["trace"],
         "ms": times["trace"][0], "plain_ms": times["trace"][1]},
        {"name": "shade", "route": "cuda", "source": src,
         "replaces": "rsoderh_raytracing_tpu/ops/pallas_wavefront.py:840",
         "launches": launches["shade"], "max_abs_err": max_err["shade"],
         "ms": times["shade"][0], "plain_ms": times["shade"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
