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

The big-mesh route (plain chunked sweeps and big_shade_plain on the CPU)
against JAX's composed render_freerun, on the 200-triangle wall of
conftest's big_tri_scene and on suzanne (968 triangles), 16x16, budget
8, 8 bounces, one call each. Dense triangle sweeps flip a path more
often than house (measured: suzanne closest rays 2204 vs 2198, shadow
rays 1003 vs 996, counts equal on every pixel, image mean within 4.1e-4
relative). Bounds: ray counts within 1% relative, counts equal on >= 99%
of pixels, image mean within 2e-3 relative, >= 98% of values close.

The anchor goldens of the independent numpy oracle
(tests/goldens/suzanne_hi_anchor_24_2spp.npy, spheres_anchor_32_4spp.npy)
through render_wavefront with environment 0 of load_default_environments
and MAX_BOUNCES, as the reference's Renderer.step_batch renders them,
with the reference's flip-aware criteria
(tests/test_reference_estimator.py). Measured here: suzanne_hi 0.52%
flipped pixels, 99.5% within 1e-4, non-flipped relative RMSE 2.7e-6;
spheres 53.7% within 1e-4, non-flipped relative RMSE 8.2e-4, image mean
3.2% from the oracle's.
"""

import collections
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
from rsoderh_raytracing_tpu_torch import load_scene as t_load_scene
from rsoderh_raytracing_tpu_torch.env.environment import (
    Environment,
    device_environment,
    load_default_environments,
)
from rsoderh_raytracing_tpu_torch.render.integrator import MAX_BOUNCES, camera_pytree
from rsoderh_raytracing_tpu_torch.render.wavefront import render_freerun, render_wavefront
from rsoderh_raytracing_tpu_torch.scene.device import (
    CHUNKED,
    FIELDS,
    build_device_scene,
    device_scene_from_arrays,
    route,
)

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
    targs = (build_device_scene(house_scene, device="cpu"),
             device_environment(Environment.from_texture("s", sky), device="cpu"),
             camera_pytree(house_scene.camera, device="cpu"))
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


def _house_args(house_scene):
    sky = procedural_sky(256, 128)
    return (build_device_scene(house_scene, device="cpu"),
            device_environment(Environment.from_texture("s", sky), device="cpu"),
            camera_pytree(house_scene.camera, device="cpu"))


def test_small_route_equals_composed_body_bitwise(house_scene, house_runs, monkeypatch):
    """The kernel loop's small route (TRACE, SHADE) and the composed body
    (RT_DISABLE_WFKERNELS=1: the glue, FUSED and tensor code) give the
    same image, counts and ray counts bit for bit on the CPU, and so the
    composed body holds JAX's bounds too."""
    ki, kc, ks = house_runs["port"][0]
    monkeypatch.setenv("RT_DISABLE_WFKERNELS", "1")
    img, cnt, st = render_freerun(*_house_args(house_scene), np.zeros(RES[::-1], np.uint32), RES,
                                  BUDGET, BOUNCES, with_stats=True)
    np.testing.assert_array_equal(img.numpy().view(np.uint32), ki.view(np.uint32))
    np.testing.assert_array_equal(cnt.numpy(), kc)
    assert {k: float(v) for k, v in st.items()} == ks
    ji, _, _ = house_runs["jax"][0]
    np.testing.assert_allclose(img.numpy().mean(), ji.mean(), rtol=MEAN_RTOL)


def test_small_route_runs_no_glue_outside_trace(house_scene, monkeypatch):
    """An iteration of the small route calls the alias draw only inside
    TRACE (whose plain version is the glue, the Pallas body and the
    gather); nothing else of the iteration computes it."""
    from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
    from rsoderh_raytracing_tpu_torch.ops import envmap
    from rsoderh_raytracing_tpu_torch.render.wavefront import NO_LIMIT, Wavefront

    calls = {"inside": 0, "outside": 0}
    where = ["outside"]
    draw = envmap.sample_alias_index

    def counted_draw(*args):
        calls[where[0]] += 1
        return draw(*args)

    def trace(*args):
        where[0] = "inside"
        try:
            return cw.trace_call(*args)
        finally:
            where[0] = "outside"

    monkeypatch.setattr(envmap, "sample_alias_index", counted_draw)
    wave = Wavefront(*_house_args(house_scene), 0, (16, 8), NO_LIMIT, 4, BOUNCES)
    for it in range(3):
        wave.step(it, trace=trace)
    assert calls == {"inside": 3, "outside": 0}


def test_env_draw_call_on_cpu_is_trace_glue(house_scene):
    """ENV_DRAW's wrapper on CPU tensors runs its plain twin, launches
    nothing, and gives trace_glue's state, NEE uv, pmf and direction bit
    for bit, on states that span the u32 range."""
    from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
    from rsoderh_raytracing_tpu_torch.ops import envmap, rng

    env = _house_args(house_scene)[1]
    bits = np.random.default_rng(5).integers(-2**31, 2**31, 4096).astype(np.int32)
    bits[:4] = [0, -1, 2**31 - 1, -2**31]
    state = torch.from_numpy(bits)
    before = dict(cw.LAUNCHES)
    out = cw.env_draw_call(env, state)
    assert cw.LAUNCHES == before
    assert tuple(out) == cw.ENV_DRAW_OUT_NAMES
    rd = torch.zeros(4096)
    st, nee_u, nee_v, nee_pmf, nd, _, _ = envmap.trace_glue(rng.from_bits(state), env, rd, rd + 1.0, rd)
    want = dict(state=rng.to_bits(st), nee_u=nee_u, nee_v=nee_v, nee_pmf=nee_pmf,
                nd0=nd[0], nd1=nd[1], nd2=nd[2])
    for k in cw.ENV_DRAW_OUT_NAMES:
        assert out[k].is_contiguous() and out[k].dtype == want[k].dtype, k
        assert torch.equal(out[k].view(torch.int32), want[k].view(torch.int32)), k


@pytest.mark.parametrize("with_bvh", [False, True])
def test_big_route_reads_environment_rows_only_in_its_kernels(assets_dir, monkeypatch, with_bvh):
    """An iteration of the big-mesh routes (chunked, and BVH) draws from
    the alias table only inside ENV_DRAW and reads quad rows only inside
    BIG_SHADE (whose plain twins hold the draw and the gather): the tensor
    code between the kernels takes no row of the environment, which on the
    card would be a PyTorch gather."""
    from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
    from rsoderh_raytracing_tpu_torch.ops import envmap
    from rsoderh_raytracing_tpu_torch.render.wavefront import NO_LIMIT, Wavefront

    scene = t_load_scene(os.path.join(assets_dir, "scenes", "suzanne.toml"))
    env = device_environment(Environment.from_texture("s", procedural_sky(64, 32)), device="cpu")
    tables = {t.untyped_storage().data_ptr(): name for name, t in
              (("alias", env.alias_pair), ("alias", env.alias_index), ("quad", env.quad))}
    calls = collections.Counter()
    where = ["outside"]
    draw, index_select = envmap.sample_alias_index, torch.Tensor.index_select

    def counted_draw(*args):
        calls[("draw", where[0])] += 1
        return draw(*args)

    def counted_index_select(src, *args, **kwargs):
        name = tables.get(src.untyped_storage().data_ptr())
        if name:
            calls[(name, where[0])] += 1
        return index_select(src, *args, **kwargs)

    def inside(fn):
        def wrapped(*args):
            where[0] = "inside"
            try:
                return fn(*args)
            finally:
                where[0] = "outside"
        return wrapped

    monkeypatch.setattr(envmap, "sample_alias_index", counted_draw)
    monkeypatch.setattr(torch.Tensor, "index_select", counted_index_select)
    ds = build_device_scene(scene, device="cpu", with_bvh=with_bvh)
    wave = Wavefront(ds, env, camera_pytree(scene.camera, device="cpu"), 0, (16, 8), NO_LIMIT, 4,
                     BOUNCES)
    for it in range(3):
        wave.step(it, env_draw=inside(cw.env_draw_call), big_shade=inside(cw.big_shade_call))
    assert calls == {("draw", "inside"): 3, ("alias", "inside"): 6, ("quad", "inside"): 3}


@pytest.mark.parametrize("name", ["default", "house"])
def test_render_wavefront_matches_golden(assets_dir, name):
    scene = load_scene(os.path.join(assets_dir, "scenes", f"{name}.toml"))
    env = device_environment(
        Environment.from_texture("golden_sky", procedural_sky(256, 128, sun_radius=0.05)),
        device="cpu",
    )
    img, stats = render_wavefront(
        build_device_scene(scene, device="cpu"), env, camera_pytree(scene.camera, device="cpu"),
        0, (64, 64), 8, 4,
        with_stats=True,
    )
    img = img.numpy() / 8
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_64_8spp.npy"))
    rel = np.sqrt(np.mean((img - golden) ** 2)) / np.sqrt(np.mean(golden ** 2))
    assert rel < GOLDEN_REL_RMSE_MAX, f"relative RMSE {rel:.2e}"
    assert int(stats["closest_rays"]) >= 64 * 64 * 8


BIG_RES = (16, 16)
BIG_BUDGET = 8
BIG_RAYS_RTOL = 1e-2
BIG_MEAN_RTOL = 2e-3
BIG_IMAGE_CLOSE_MIN = 0.98


@pytest.fixture(scope="module", params=["wall", "suzanne"])
def big_runs(request, assets_dir, big_tri_scene):
    """One free-run call on each side over a scene of the big-mesh route."""
    if request.param == "wall":
        scene = big_tri_scene
    else:
        scene = load_scene(os.path.join(assets_dir, "scenes", "suzanne.toml"))
    sky = procedural_sky(128, 64)
    js = j_build(scene)
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    assert route(ts) == CHUNKED
    base = np.zeros(BIG_RES[::-1], np.uint32)
    ji, jc, jst = j_render_freerun(js, j_device_environment(JEnvironment.from_texture("s", sky)),
                                   j_camera(scene.camera), base, BIG_RES, np.uint32(BIG_BUDGET),
                                   BOUNCES, with_stats=True)
    ti, tc, tst = render_freerun(ts, device_environment(Environment.from_texture("s", sky), device="cpu"),
                                 camera_pytree(scene.camera, device="cpu"), base, BIG_RES, BIG_BUDGET,
                                 BOUNCES, with_stats=True)
    return dict(
        jax=(np.asarray(ji), np.asarray(jc).astype(np.int64), {k: float(v) for k, v in jst.items()}),
        port=(ti.numpy(), tc.numpy(), {k: float(v) for k, v in tst.items()}),
    )


def test_big_route_ray_counts_match_jax(big_runs):
    js, ts = big_runs["jax"][2], big_runs["port"][2]
    for key in ("closest_rays", "shadow_rays"):
        assert abs(ts[key] - js[key]) <= BIG_RAYS_RTOL * js[key], key
    # on the wall every path may end before the drain's last iteration
    assert ts["iterations"] == js["iterations"] <= BIG_BUDGET + BOUNCES - 1


def test_big_route_counts_match_jax(big_runs):
    jc, tc = big_runs["jax"][1], big_runs["port"][1]
    assert tc.shape == jc.shape == BIG_RES[::-1]
    assert tc.min() > 0
    assert (tc == jc).mean() >= COUNTS_EQUAL_MIN


def test_big_route_image_matches_jax(big_runs):
    ji, ti = big_runs["jax"][0], big_runs["port"][0]
    assert ti.shape == ji.shape == (*BIG_RES[::-1], 3)
    assert np.isfinite(ti).all()
    np.testing.assert_allclose(ti.mean(), ji.mean(), rtol=BIG_MEAN_RTOL)
    assert np.isclose(ti, ji, rtol=1e-4, atol=1e-5).mean() >= BIG_IMAGE_CLOSE_MIN


@pytest.fixture(scope="module")
def default_env0():
    return device_environment(load_default_environments()[0], device="cpu")


def _anchor(assets_dir, env, name, size, spp):
    scene = t_load_scene(os.path.join(assets_dir, "scenes", f"{name}.toml"))
    ds = build_device_scene(scene, device="cpu")
    assert route(ds) == CHUNKED
    img = render_wavefront(ds, env, camera_pytree(scene.camera, device="cpu"), 0, (size, size),
                           spp, MAX_BOUNCES)
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}_anchor_{size}_{spp}spp.npy"))
    return img.numpy() / spp, ref


def test_suzanne_hi_anchor_golden(assets_dir, default_env0):
    ours, ref = _anchor(assets_dir, default_env0, "suzanne_hi", 24, 2)
    diff = np.abs(ours - ref).max(-1)
    flipped = diff > 1e-2
    assert flipped.mean() < 0.03, f"{flipped.sum()} flipped pixels"
    assert (diff < 1e-4).mean() > 0.95
    keep = ~flipped
    rel = float(np.sqrt(((ours - ref)[keep] ** 2).mean())) / float(np.sqrt((ref[keep] ** 2).mean()))
    assert rel < 0.005, f"non-flipped relative RMSE {rel:.4%}"


def test_spheres_anchor_golden(assets_dir, default_env0):
    ours, ref = _anchor(assets_dir, default_env0, "spheres", 32, 4)
    diff = ours - ref
    ad = np.abs(diff).max(-1)
    assert (ad < 1e-4).mean() > 0.45, "bit-matched pixel share collapsed"
    keep = ~(ad > 1e-2)
    rel = float(np.sqrt((diff[keep] ** 2).mean()) / np.sqrt((ref[keep] ** 2).mean()))
    assert rel < 0.005, f"non-flipped relative RMSE {rel:.4%}"
    mrel = abs(float(ours.mean()) - float(ref.mean())) / float(ref.mean())
    assert mrel < 0.05, f"image-mean divergence {mrel:.4%}"
