"""The slice as a whole: the port's wavefront (plain PyTorch on the CPU)
against JAX's render_freerun and the committed goldens.

House at 32x32, budget 16, 8 bounces, procedural_sky(256, 128): the JAX
side runs its composed body (plain XLA on the CPU). Both sides draw the
same RNG stream per (pixel, sample), so the ray counts and per-pixel
sample counts agree exactly unless a float difference flips a path
(torch and XLA round sin/cos/atan2/asin/sqrt differently and XLA
contracts FMAs, ROADMAP queue 3). Measured here: ray counts and
iterations identical, counts equal on 100% of pixels, image mean within
1e-6 relative, 99.9% of image values isclose(1e-4, 1e-5). Bounds: ray
counts within 1e-3 relative, counts equal on >= 99% of pixels, image
mean within 1e-3 relative, >= 99% of values close.

Goldens (tests/goldens/*_64_8spp.npy, 64x64, 8 spp, 4 bounces): the
port's relative RMSE measured 5.0e-5 (default) and 8.6e-5 (house); the
bound is the reference's own, 5e-4.
"""

import os

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu import load_scene
from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import device_environment as j_device_environment
from rsoderh_raytracing_tpu.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu.render.integrator import camera_pytree as j_camera
from rsoderh_raytracing_tpu.render.wavefront import render_freerun as j_render_freerun
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.wavefront import render_freerun, render_wavefront
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene

torch.set_num_threads(2)

RES = (32, 32)
BUDGET = 16
BOUNCES = 8
RAYS_RTOL = 1e-3
COUNTS_EQUAL_MIN = 0.99
MEAN_RTOL = 1e-3
IMAGE_CLOSE_MIN = 0.99
GOLDEN_REL_RMSE_MAX = 5e-4
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def house_runs(house_scene):
    """Two consecutive free-run calls on each side, base counts carried
    from the first to the second as bench.py does."""
    sky = procedural_sky(256, 128)
    jargs = (j_build(house_scene), j_device_environment(JEnvironment.from_texture("s", sky)),
             j_camera(house_scene.camera))
    targs = (build_device_scene(house_scene), device_environment(Environment.from_texture("s", sky)),
             camera_pytree(house_scene.camera))
    runs = {"jax": [], "port": []}
    jbase = np.zeros(RES[::-1], np.uint32)
    tbase = np.zeros(RES[::-1], np.uint32)
    for _ in range(2):
        img, cnt, st = j_render_freerun(*jargs, jbase, RES, np.uint32(BUDGET), BOUNCES, with_stats=True)
        runs["jax"].append((np.asarray(img), np.asarray(cnt).astype(np.int64),
                            {k: float(v) for k, v in st.items()}))
        jbase = jbase + np.asarray(cnt)
        img, cnt, st = render_freerun(*targs, tbase, RES, BUDGET, BOUNCES, with_stats=True)
        runs["port"].append((img.numpy(), cnt.numpy(), {k: float(v) for k, v in st.items()}))
        tbase = tbase + cnt.numpy().astype(np.uint32)
    return runs


@pytest.mark.parametrize("call", [0, 1])
def test_freerun_ray_counts_match_jax(house_runs, call):
    _, _, js = house_runs["jax"][call]
    _, _, ts = house_runs["port"][call]
    for key in ("closest_rays", "shadow_rays"):
        assert abs(ts[key] - js[key]) <= RAYS_RTOL * js[key], key
    assert ts["iterations"] == js["iterations"] == BUDGET + BOUNCES - 1


@pytest.mark.parametrize("call", [0, 1])
def test_freerun_counts_match_jax(house_runs, call):
    _, jc, _ = house_runs["jax"][call]
    _, tc, _ = house_runs["port"][call]
    assert tc.shape == jc.shape == RES[::-1]
    assert tc.min() > 0
    assert (tc == jc).mean() >= COUNTS_EQUAL_MIN


@pytest.mark.parametrize("call", [0, 1])
def test_freerun_image_matches_jax(house_runs, call):
    ji, _, _ = house_runs["jax"][call]
    ti, _, _ = house_runs["port"][call]
    assert ti.shape == ji.shape == (*RES[::-1], 3)
    assert np.isfinite(ti).all()
    np.testing.assert_allclose(ti.mean(), ji.mean(), rtol=MEAN_RTOL)
    assert np.isclose(ti, ji, rtol=1e-4, atol=1e-5).mean() >= IMAGE_CLOSE_MIN


@pytest.mark.parametrize("name", ["default", "house"])
def test_render_wavefront_matches_golden(assets_dir, name):
    scene = load_scene(os.path.join(assets_dir, "scenes", f"{name}.toml"))
    env = device_environment(
        Environment.from_texture("golden_sky", procedural_sky(256, 128, sun_radius=0.05))
    )
    img, stats = render_wavefront(
        build_device_scene(scene), env, camera_pytree(scene.camera), 0, (64, 64), 8, 4,
        with_stats=True,
    )
    img = img.numpy() / 8
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_64_8spp.npy"))
    rel = np.sqrt(np.mean((img - golden) ** 2)) / np.sqrt(np.mean(golden ** 2))
    assert rel < GOLDEN_REL_RMSE_MAX, f"relative RMSE {rel:.2e}"
    assert int(stats["closest_rays"]) >= 64 * 64 * 8
