"""The "Ray Tracing in One Weekend" final scene (assets/scenes/rtiow_final.toml,
written by scripts/make_rtiow_scene.py) on the port, and the fallback-lane
counter of BVH_CLOSEST.

CPU cases: the generator is deterministic and the committed file (and
the benchmark's copy of it) is its output; the book's recipe (22 x 22
candidates less those within 0.9 of (4, 0.2, 0), three big spheres,
materials 80/15/5 within binomial bounds); the camera looks at the
origin; the port through Renderer on the BVH route at 32x18 against the
benchmark's plain reference (portbench/reference, its "direct" leaf
formulas) at every pixel of two step_freerun calls; fallback_lanes
against bvh.walk_model's misses on a captured iteration, in one stats
copy a call, summed over a tile split, and 0 on the small route. The
card case (marked
`cuda`) holds the kernel's count to the plain twin's:

    python -m pytest --noconftest -m cuda tests/test_torch_rtiow.py
"""

import importlib.util
import math
import os
import tomllib

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.env import hdr_io
from rsoderh_raytracing_tpu_torch.env.environment import (
    Environment,
    EnvironmentMaps,
    device_environment,
)
from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.profiling import capture_step
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import NO_LIMIT, Wavefront
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "assets", "scenes", "rtiow_final.toml")
W, H, BOUNCES, ITERATIONS = 32, 18, 4, 2


def _generator():
    spec = importlib.util.spec_from_file_location("make_rtiow_scene",
                                                  os.path.join(ROOT, "scripts", "make_rtiow_scene.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def desc():
    with open(SCENE, "rb") as f:
        return tomllib.load(f)


@pytest.fixture(scope="module")
def scene():
    return load_scene(SCENE)


@pytest.fixture(scope="module")
def sky_file(tmp_path_factory):
    """A small RGBE sky on disk, read by the port and the reference alike."""
    path = str(tmp_path_factory.mktemp("rtiow") / "sky.hdr")
    hdr_io.write_hdr(path, hdr_io.procedural_sky(64, 32))
    return path


def test_generator_is_deterministic_and_committed():
    gen = _generator()
    text = gen.render_toml()
    assert text == gen.render_toml()
    for path in (SCENE, os.path.join(ROOT, "portbench", "configs", "rtiow_final.toml")):
        with open(path) as f:
            assert f.read() == text, path


def _spheres(desc):
    mats = {m["name"]: m for m in desc["material"]}
    return [(np.array(o["Sphere"]["pos"]), o["Sphere"]["radius"], mats[o["Sphere"]["material"]])
            for o in desc["object"] if "Sphere" in o]


def _kind(mat):
    if mat["metallic"] == 1.0:
        return "metal"
    if mat["roughness"] == 0.0 and mat["color"] == [1.0, 1.0, 1.0]:
        return "glass"
    assert mat["roughness"] == 1.0 and mat["metallic"] == 0.0
    return "lambertian"


def test_recipe_counts(desc):
    spheres = _spheres(desc)
    small = [(p, m) for p, r, m in spheres if r == 0.2]
    big = [(p, m) for p, r, m in spheres if r == 1.0]
    assert len(small) + len(big) == len(spheres)
    # one sphere at most a grid cell [a, a + 0.9) x [b, b + 0.9), y = 0.2,
    # none within 0.9 of (4, 0.2, 0); an empty cell is one whose candidate
    # could lie there
    centre = np.array([4.0, 0.2, 0.0])
    cells = set()
    for p, _ in small:
        a, b = math.floor(p[0]), math.floor(p[2])
        assert -11 <= a < 11 and -11 <= b < 11 and p[0] - a < 0.9 and p[2] - b < 0.9 and p[1] == 0.2
        assert (a, b) not in cells
        cells.add((a, b))
        assert np.linalg.norm(p - centre) > 0.9
    excluded = [(a, b) for a in range(-11, 11) for b in range(-11, 11) if (a, b) not in cells]
    for a, b in excluded:
        near = np.clip(centre[[0, 2]], [a, b], [a + 0.9, b + 0.9])
        assert np.linalg.norm(near - centre[[0, 2]]) <= 0.9
    assert len(spheres) == 22 * 22 - len(excluded) + 3 == 486
    assert sorted((tuple(p), _kind(m)) for p, m in big) == [
        ((-4.0, 1.0, 0.0), "lambertian"), ((0.0, 1.0, 0.0), "glass"), ((4.0, 1.0, 0.0), "metal")]
    kinds = [_kind(m) for _, m in small]
    n = len(small)
    for kind, p in (("lambertian", 0.8), ("metal", 0.15), ("glass", 0.05)):
        assert abs(kinds.count(kind) - n * p) <= 3.5 * math.sqrt(n * p * (1 - p)), kind
    # a material row a lambertian or metal sphere, one shared glass row
    assert len(desc["material"]) == 1 + 1 + kinds.count("lambertian") + kinds.count("metal") + 2 == 458
    (ground,) = [o["Plane"] for o in desc["object"] if "Plane" in o]
    assert ground["pos"] == [-1000, 0, -1000] and ground["forward"] == [0, 0, 2000]


def test_camera_looks_at_the_origin(scene):
    cam = scene.camera
    cy, sy, cp, sp = math.cos(cam.yaw), math.sin(cam.yaw), math.cos(cam.pitch), math.sin(cam.pitch)
    forward = np.array([-sy * cp, sp, -cy * cp])  # Ry(yaw) @ Rx(pitch) @ (0, 0, -1)
    want = -np.asarray(cam.pos, np.float64)
    assert np.abs(forward - want / np.linalg.norm(want)).max() < 1e-4
    assert np.asarray(cam.pos).tolist() == [13.0, 2.0, 3.0]
    assert math.degrees(cam.fov_y) == pytest.approx(20.0)


def test_port_matches_the_reference(scene, sky_file):
    """Renderer on the BVH route against portbench/reference at every pixel
    of two step_freerun calls: counts equal, sums within check.py's
    tolerances."""
    from portbench import check
    from portbench.reference.env import load_environment
    from portbench.reference.scene import camera_tensors, load_scene as ref_load_scene

    env = Environment.from_texture("sky", hdr_io.load_image(sky_file))
    r = Renderer(scene, W, H, environments=EnvironmentMaps([env]), max_bounces=BOUNCES,
                 intersector="bvh", device="cpu")
    assert r.intersector == "bvh"
    pixel = torch.arange(W * H)
    snaps = [(r.film.cumulative.reshape(-1, 3).clone(), r.film.counts.reshape(-1).clone())]
    for _ in range(2):
        r.step_freerun(ITERATIONS)
        snaps.append((r.film.cumulative.reshape(-1, 3).clone(), r.film.counts.reshape(-1).clone()))
    answers = [dict(pixel=pixel, base=c0[None], counts=(c1 - c0)[None], film_counts=c1 - c0, sums=s1 - s0,
                    film_after=s1) for (s0, c0), (s1, c1) in zip(snaps, snaps[1:])]
    ref_scene = ref_load_scene(SCENE, "cpu")
    ref = dict(scene=ref_scene, width=W, height=H, max_bounces=BOUNCES, formulas="direct",
               env=load_environment(sky_file, "cpu", os.path.join(ROOT, "build", "portbench", "native")))
    refs = check.render_answers(ref, camera_tensors(*ref_scene.camera, "cpu"), answers, ITERATIONS)
    assert check.compare_render(answers, refs) == (0.0, 0.0)
    assert all(int(a["counts"].sum()) > 0 for a in answers)


@pytest.fixture(scope="module")
def bvh_wave(scene):
    """A Wavefront of the scene on the BVH route, three iterations in, and
    the BVH_CLOSEST arguments of its fourth with the lanes that fourth
    iteration added to fallback_lanes."""
    ds = build_device_scene(scene, "cpu", with_bvh=True)
    env = device_environment(Environment.from_texture("sky", hdr_io.procedural_sky(64, 32)), "cpu")
    wave = Wavefront(ds, env, camera_pytree(scene.camera, "cpu"), 0, (W, H), NO_LIMIT, 16, BOUNCES)
    for it in range(3):
        wave.step(it)
    before = int(wave.fallback)
    args = capture_step(wave, 3)["closest"]
    return ds, wave, args, int(wave.fallback) - before


def test_fallback_lanes_are_the_walks_misses(bvh_wave):
    ds, wave, (scene, ro, rd, live), counted = bvh_wave
    _, slot = bvh_ops.walk_model(ds.bvh, ro, rd, live, closest=True)
    misses = int(((slot < 0) & (live != 0)).sum())
    assert counted == misses > 0
    assert int(wave.results()[2]["fallback_lanes"]) >= counted


def test_fallback_lanes_reach_the_host_in_one_copy(scene):
    """last_stats carries fallback_lanes from one device-to-host copy (one
    sync.stats a call), the counter bvh.fallback_lanes adds them under
    tracing, and a tile split sums its slots' counts to the whole image's."""
    from rsoderh_raytracing_tpu_torch import tracing
    from rsoderh_raytracing_tpu_torch.parallel.sharding import ShardedRenderer

    sky = EnvironmentMaps([Environment.from_texture("sky", hdr_io.procedural_sky(64, 32))])

    def renderer():
        return Renderer(scene, 16, 8, environments=sky, max_bounces=2, intersector="bvh", device="cpu")

    whole = renderer()
    tracing.disable()
    tracing.take()
    tracing.enable()
    try:
        whole.step_freerun(2)
        counters = tracing.take()["counters"]
    finally:
        tracing.disable()
        tracing.take()
    swept = whole.last_stats["fallback_lanes"]
    assert counters["sync.stats"] == 1 and counters["bvh.fallback_lanes"] == swept > 0
    split = ShardedRenderer.wrap(renderer(), "tile:2")
    split.step_freerun(2)
    assert split.last_stats == whole.last_stats


def test_fallback_lanes_are_zero_on_the_small_route():
    house = load_scene(os.path.join(ROOT, "assets", "scenes", "house.toml"))
    sky = EnvironmentMaps([Environment.from_texture("sky", hdr_io.procedural_sky(64, 32))])
    r = Renderer(house, 16, 8, environments=sky, max_bounces=2, intersector="sweep", device="cpu")
    r.step_freerun(2)
    assert r.last_stats["fallback_lanes"] == 0 and r.last_stats["closest_rays"] > 0


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fallback pass runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_counts_the_plain_twins_lanes(dev, scene):
    ds = build_device_scene(scene, dev, with_bvh=True)
    env = device_environment(Environment.from_texture("sky", hdr_io.procedural_sky(256, 128)), dev)
    wave = Wavefront(ds, env, camera_pytree(scene.camera, dev), 0, (256, 256), NO_LIMIT, 16, 8)
    for it in range(3):
        wave.step(it)
    args = capture_step(wave, 3)["closest"]
    kernel = torch.zeros((), dtype=torch.int64, device=dev)
    plain = torch.zeros((), dtype=torch.int64, device=dev)
    got = ci.bvh_closest_call(*args, fallback_lanes=kernel)
    want = bvh_ops.closest_plain(*args, fallback_lanes=plain)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(kernel) == int(plain) > 0
    assert int(wave.results()[2]["fallback_lanes"]) > 0
