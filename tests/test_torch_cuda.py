"""CUDA kernels against their plain PyTorch twins, on an NVIDIA GPU.

Marked `cuda`: every test skips without a card (the kernels have no CPU
mode). On a machine with one, which need not have jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of jax (tests/conftest.py does, hence
--noconftest) and defines its own scene fixtures.

Each integer output equal, and each float output isclose(1e-4, 1e-5),
on at least 99.99% of the lanes.
TRACE's NEE pmf and quad row are bitwise its plain version's on every
lane, and so is its NEE uv (the alias draw's texel and jitter) on the
lanes where both hit; ENV_DRAW's state, NEE uv and pmf on every lane. CLOSEST, ANY and FUSED keep hit, occlusion, type,
index and t bitwise their plain versions' through the sweep's
division-free pre-test.

Below the kernels, each route end to end on the card: what an iteration
launches, the goldens and the numpy oracle's anchors, the command line,
the composed body, the knobs RT_DISABLE_PALLAS and RT_DEBUG_NANS, the
lane layout and the chunk orders, all bitwise or by the anchors'
flip-aware image criteria.
"""

import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu_torch import cli, load_scene
from rsoderh_raytracing_tpu_torch.env.environment import (
    Environment,
    EnvironmentMaps,
    device_environment,
    load_default_environments,
)
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky, read_hdr
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.profiling import capture_step, kernel_breakdown, sweep_calls, tiled_house
from rsoderh_raytracing_tpu_torch.render import wavefront as wf
from rsoderh_raytracing_tpu_torch.render.integrator import MAX_BOUNCES, camera_pytree
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import (
    NO_LIMIT, Wavefront, render_freerun, render_spp_sync, render_wavefront,
)
from rsoderh_raytracing_tpu_torch.scene.device import (
    BVH, CHUNKED, SMALL, SWEEP_MAX_SHARED, auto_bvh, build_device_scene, route,
)
from rsoderh_raytracing_tpu_torch.scene.camera import Camera
from rsoderh_raytracing_tpu_torch.scene.toml_loader import build_scene
from rsoderh_raytracing_tpu_torch.scene.types import Material, PackedMeshes, Plane, Scene, Sphere
from rsoderh_raytracing_tpu_torch.utils.png import read_png

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

PARITY_MIN = 0.9999
RTOL, ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "assets", "scenes")


@pytest.fixture(scope="module")
def house_scene():
    return load_scene(os.path.join(SCENES, "house.toml"))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _scene(name):
    """assets/scenes/NAME.toml, or profiling.tiled_house(k) for house_tiledK."""
    if name.startswith("house_tiled"):
        return tiled_house(int(name[len("house_tiled"):]))
    return load_scene(os.path.join(SCENES, f"{name}.toml"))


def _sky(dev):
    return device_environment(Environment.from_texture("s", procedural_sky(256, 128)), dev)


def _loop_state(ds, scene, dev):
    """The route's kernel arguments at the fourth iteration of a real loop
    at 128x128 (capture_step), by Wavefront.step keyword."""
    wave = Wavefront(ds, _sky(dev), camera_pytree(scene.camera, dev), 0, (128, 128), NO_LIMIT, 32, 8)
    for it in range(3):
        wave.step(it)
    return capture_step(wave, 3)


@pytest.fixture(scope="module")
def house_state(dev, house_scene):
    """TRACE and SHADE inputs of a real loop iteration at 128x128."""
    return _loop_state(build_device_scene(house_scene, dev), house_scene, dev)


def _compare(got, ref, int_names):
    shares, _, _ = cw.parity(got, ref, int_names, RTOL, ATOL)
    assert shares.keys() == ref.keys()
    assert {k: v for k, v in shares.items() if v < PARITY_MIN} == {}


def _counted(shade, args):
    """A shade function on captured arguments with fresh ray counters in
    place of the run's: (its new carry, the counters' slots)."""
    counters = cw.RayCounters(args[-1].slots.device)
    return shade(*args[:-1], counters), counters.slots


def _compare_shade(kernel, plain, args):
    """SHADE's or BIG_SHADE's new carry against its plain version's on
    `args`, output by output, and the ray counters the two add to (closest
    rays, shadow rays, iterations, the tag) equal. Returns both carries."""
    (got, got_slots), (ref, ref_slots) = _counted(kernel, args), _counted(plain, args)
    _compare(got, ref, cw.SHADE_INT_NAMES)
    assert got_slots.tolist() == ref_slots.tolist()
    assert int(ref_slots[0]) > 0
    return got, ref


def _bits_differ(a, b):
    """Lanes where two (n,) or (n, k) tensors differ in any bit."""
    a, b = (x.view(torch.int32) if x.dtype == torch.float32 else x for x in (a, b))
    return (a != b).reshape(a.shape[0], -1).any(dim=1)


def _compare_trace(args):
    """TRACE on args against trace_plain: every output at the gates, the
    NEE pmf and quad row bitwise on every lane, the NEE uv bitwise on the
    lanes where both hit."""
    before = cw.LAUNCHES["trace"]
    got = cw.trace_call(*args)
    assert cw.LAUNCHES["trace"] == before + 1
    ref = cw.trace_plain(*args)
    _compare(got, ref, cw.TRACE_INT_NAMES)
    both = (got["hit"] != 0) & (ref["hit"] != 0)
    differ = {k: int(_bits_differ(got[k], ref[k]).sum()) for k in ("nee_pmf", "quad")}
    differ.update({k: int(_bits_differ(got[k], ref[k])[both].sum()) for k in ("fu", "fv")})
    assert differ == {"nee_pmf": 0, "quad": 0, "fu": 0, "fv": 0}
    return got


def test_trace_kernel_matches_plain(house_state):
    _compare_trace(house_state["trace"])


def _tiny_scene():
    """One sphere, one plane and one triangle (tests/test_torch_trace.py's
    scene), an emissive triangle material."""
    meshes = PackedMeshes(
        vertices=np.array([[-1.5, -0.5, -2.5], [-0.5, -0.5, -2.5], [-1.0, 0.6, -2.5]], np.float32),
        normals=np.array([[0.0, 0.0, 1.0], [0.2, 0.0, 0.98], [0.0, 0.2, 0.98]], np.float32),
        triangles=np.array([[0, 1, 2, 0, 1, 2, 2]], np.int32),
    )
    return Scene(
        materials=[Material((0.7, 0.3, 0.2), 0.5, 0.0, (0, 0, 0)),
                   Material((0.9, 0.9, 0.9), 0.05, 1.0, (0, 0, 0)),
                   Material((0.4, 0.8, 0.3), 0.3, 0.2, (1.5, 0.5, 0.2))],
        spheres=[Sphere(pos=(0.6, 0.0, -3.0), radius=1.0, material_id=1)],
        planes=[Plane(pos=(-4.0, -1.2, -8.0), right=(8.0, 0.0, 0.0), forward=(0.0, 0.0, 8.0),
                      material_id=0)],
        meshes=meshes, camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=1.2),
    )


def _made_up_carry(n, dev, origin, seed):
    """Seeded rays from around `origin` and u32 states as a carry; the
    first lanes escape along -x (dz = -0 and +0) and +-y, where the miss
    uv leaves [0, 1]."""
    g = np.random.default_rng(seed)
    o = (np.asarray(origin, np.float32) + g.normal(0.0, 0.5, (n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    edge = np.array([[-1.0, 0.0, -0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    d[: min(n, 4)] = edge[: min(n, 4)]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    carry = {f"{k}{i}": torch.from_numpy(np.ascontiguousarray(a[:, i])).to(dev)
             for k, a in (("ro", o), ("rd", d)) for i in range(3)}
    state = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    carry["state"] = torch.from_numpy(state.view(np.int32)).to(dev)
    return carry


@pytest.fixture(scope="module")
def small_scenes(dev, house_scene):
    """(device scene, ray origin) of the tiny scene and of house."""
    return {"tiny": (build_device_scene(_tiny_scene(), dev, pad_to=1), (0.0, 0.0, 0.0)),
            "house": (build_device_scene(house_scene, dev), tuple(house_scene.camera.pos))}


@pytest.fixture(scope="module")
def seeded_env(dev):
    g = np.random.default_rng(7)
    texture = (g.uniform(0.0, 2.0, (32, 64, 3)) ** 4).astype(np.float32)
    return device_environment(Environment.from_texture("s", texture), dev)


@pytest.mark.parametrize("n", [1, 31, 1000, 256 * 256 + 7])
@pytest.mark.parametrize("name", ["tiny", "house"])
def test_trace_kernel_on_made_up_rays(small_scenes, seeded_env, dev, name, n):
    scene, origin = small_scenes[name]
    got = _compare_trace((scene, seeded_env, _made_up_carry(n, dev, origin, n)))
    if n >= 1000:
        hit = got["hit"].double().mean()
        assert 0.05 < hit < 0.95


def test_shade_kernel_matches_plain(house_state):
    args = house_state["shade"]
    before = cw.LAUNCHES["shade"]
    _compare_shade(cw.shade_call, cw.shade_plain, args)
    assert cw.LAUNCHES["shade"] == before + 1


def test_sweep_kernels_match_plain(house_state):
    """CLOSEST, ANY and FUSED on the rays of a real loop iteration, with
    the NEE direction of its alias draw; ANY's rays start at the hit
    points, as the integrators call it."""
    calls, _ = sweep_calls(house_state["trace"])
    before = dict(ci.LAUNCHES)
    for kfn, pfn, ints in calls.values():
        _compare(kfn(), pfn(), ints)
    for name in ("closest", "any", "fused"):
        assert ci.LAUNCHES[name] == before[name] + 1
    scene, _, carry = house_state["trace"]
    ro = tuple(carry[f"ro{i}"] for i in range(3))
    rd = tuple(carry[f"rd{i}"] for i in range(3))
    with pytest.raises(ValueError):
        ci.closest_call(scene, tuple(c.to(torch.float64) for c in ro), rd)


def test_renderer_step_on_the_card(dev, house_scene):
    """One scan-integrator sample through CLOSEST and ANY, held to the
    CPU's plain path."""
    envs = EnvironmentMaps([Environment.from_texture("s", procedural_sky(128, 64))])
    before = dict(ci.LAUNCHES)
    films = {}
    for device in ("cpu", dev):
        r = Renderer(house_scene, 32, 24, environments=envs, max_bounces=4, device=device)
        assert r.step() == 1
        films[str(device)] = r.film.mean_radiance()
    assert ci.LAUNCHES["closest"] == before["closest"] + 4
    assert ci.LAUNCHES["any"] == before["any"] + 4
    assert np.isclose(films[str(dev)], films["cpu"], rtol=1e-4, atol=1e-5).mean() >= 0.99


def test_wrapper_rejects_wrong_dtype(house_state, house_scene, dev):
    scene, env, carry = house_state["trace"]
    with pytest.raises(ValueError):
        cw.trace_call(scene, env, dict(carry, state=carry["state"].to(torch.int64)))
    legacy = device_environment(Environment.from_texture("s", procedural_sky(64, 32)), dev, "float32")
    with pytest.raises(ValueError):
        cw.trace_call(scene, legacy, carry)


def _sweeps_bitwise(scene, ro, rd, nd):
    """CLOSEST, ANY and FUSED against their plain versions: every output
    bit for bit on every lane."""
    closest = ci.closest_call(scene, ro, rd)
    for name, b in intersect.closest_record(scene, ro, rd).items():
        assert int(_bits_differ(closest[name], b).sum()) == 0, name
    fused = ci.fused_call(scene, ro, rd, nd)
    plain = intersect.trace_attrs(scene, *ro, *rd, *nd)
    for k in plain:
        a, b = (x.to(torch.int32) if x.dtype == torch.bool else x for x in (fused[k], plain[k]))
        assert int(_bits_differ(a, b).sum()) == 0, k
    p = (fused["px"], fused["py"], fused["pz"])
    assert torch.equal(ci.any_call(scene, p, nd), intersect.any_sweep(scene, *p, *nd))
    assert torch.equal(ci.any_call(scene, ro, rd), intersect.any_sweep(scene, *ro, *rd))


@pytest.mark.parametrize("n", [31, 256 * 256 + 7])
@pytest.mark.parametrize("name", ["tiny", "house"])
def test_sweep_kernels_bitwise_on_made_up_rays(small_scenes, dev, name, n):
    """Through the pre-test, the sweeps keep every hit, t, type and index
    of their plain versions, on incoherent rays and, in the tiny scene,
    rays grazing each primitive (tangent to the sphere, almost in the
    plane, through the triangle's edges)."""
    scene, origin = small_scenes[name]
    carry = _made_up_carry(n, dev, origin, n + 1)
    ro = tuple(carry[f"ro{i}"] for i in range(3))
    rd = [carry[f"rd{i}"].clone() for i in range(3)]
    if name == "tiny":
        g = np.random.default_rng(n)
        o = torch.stack(ro, 1).cpu().numpy().astype(np.float64)
        centre = np.array([0.6, 0.0, -3.0])
        side = np.cross(centre - o, g.normal(size=(n, 3)))
        tri = np.array([[-1.5, -0.5, -2.5], [-0.5, -0.5, -2.5], [-1.0, 0.6, -2.5]])
        edge = g.integers(0, 3, n)
        s = g.uniform(0.0, 1.0, (n, 1))
        targets = np.stack([
            centre + side / np.linalg.norm(side, axis=-1, keepdims=True),  # the sphere's silhouette
            tri[edge] + s * (tri[(edge + 1) % 3] - tri[edge]),  # an edge of the triangle
            np.array([-4.0, -1.2, -8.0]) + g.uniform(0, 1, (n, 3)) * np.array([8.0, 0.0, 8.0]),
        ])[g.integers(0, 3, n), np.arange(n)]
        d = targets - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = torch.from_numpy(d.astype(np.float32)).to(dev)
        rd = [d[:, i].contiguous() for i in range(3)]
    nd = [carry[f"rd{(i + 1) % 3}"] for i in range(3)]
    _sweeps_bitwise(scene, ro, tuple(rd), tuple(nd))


def test_card_render_matches_cpu_render(dev, house_scene):
    env_args = Environment.from_texture("s", procedural_sky(128, 64))
    out = {}
    for device in ("cpu", dev):
        img, counts = render_freerun(
            build_device_scene(house_scene, device), device_environment(env_args, device),
            camera_pytree(house_scene.camera, device), 0, (32, 32), 16, 8,
        )
        out[str(device)] = (img.cpu().numpy(), counts.cpu().numpy())
    (ci, cc), (gi, gc) = out["cpu"], out[str(dev)]
    assert (cc == gc).mean() >= 0.99
    np.testing.assert_allclose(gi.mean(), ci.mean(), rtol=1e-3)


@pytest.fixture(scope="module")
def suzanne_state(dev):
    """The big-mesh kernels' inputs of a real loop iteration at 128x128."""
    scene = _scene("suzanne")
    return _loop_state(build_device_scene(scene, dev), scene, dev)


def test_chunked_kernels_match_plain(suzanne_state):
    args = suzanne_state["closest"]
    before = dict(ci.LAUNCHES)
    got = ci.chunked_closest_call(*args)
    live = args[3] != 0
    names = ("t", "type", "index")
    _compare({k: v[live] for k, v in zip(names, got)},
             {k: v[live] for k, v in zip(names, intersect.chunked_closest_plain(*args))},
             {"type", "index"})
    args = suzanne_state["occlusion"]
    masked = intersect.shadow_origins(*args[1:6])[1] != 0
    _compare({"occ": ci.chunked_occlusion_call(*args)[masked]},
             {"occ": ci.chunked_occlusion_plain(*args)[masked]}, {"occ"})
    assert ci.LAUNCHES["chunked_closest"] == before["chunked_closest"] + 1
    assert ci.LAUNCHES["chunked_any"] == before["chunked_any"] + 1


def test_big_shade_kernel_matches_plain(suzanne_state):
    args = suzanne_state["big_shade"]
    before = cw.LAUNCHES["big_shade"]
    _compare_shade(cw.big_shade_call, cw.big_shade_plain, args)
    assert cw.LAUNCHES["big_shade"] == before + 1


def test_card_big_mesh_render_matches_cpu_render(dev):
    scene = _scene("suzanne")
    env_args = Environment.from_texture("s", procedural_sky(128, 64))
    out = {}
    for device in ("cpu", dev):
        img, counts = render_freerun(
            build_device_scene(scene, device), device_environment(env_args, device),
            camera_pytree(scene.camera, device), 0, (32, 32), 16, 8,
        )
        out[str(device)] = (img.cpu().numpy(), counts.cpu().numpy())
    (ci_, cc), (gi, gc) = out["cpu"], out[str(dev)]
    assert (cc == gc).mean() >= 0.99
    np.testing.assert_allclose(gi.mean(), ci_.mean(), rtol=2e-3)


def test_big_plane_scene_renders_on_the_small_route(dev):
    """A scene past the unroll budget outside the chunked route's limits
    (200 plane lanes) no longer raises on the card: its packed table fits
    the sweep kernels' shared memory, so it takes the small route, and
    TRACE and SHADE render it."""
    scene = _scene("suzanne")
    scene = Scene(
        materials=scene.materials, spheres=[],
        planes=[Plane(pos=(float(i), -1.0, -4.0), right=(0.5, 0.0, 0.0), forward=(0.0, 0.0, 0.5),
                      material_id=0) for i in range(200)],
        meshes=PackedMeshes(vertices=np.zeros((0, 3), np.float32),
                            normals=np.zeros((0, 3), np.float32),
                            triangles=np.zeros((0, 7), np.int32)),
        camera=scene.camera,
    )
    ds = build_device_scene(scene, dev)
    assert ds.num_lanes > 192 and route(ds) == SMALL
    env = device_environment(Environment.from_texture("s", procedural_sky(32, 16)), dev)
    cw.reset_launches()
    img, counts = render_freerun(ds, env, camera_pytree(scene.camera, dev), 0, (8, 8), 4, 4)
    assert cw.LAUNCHES["trace"] == cw.LAUNCHES["shade"] > 0
    assert bool(torch.isfinite(img).all()) and int(counts.min()) > 0


# -- the chunked kernels on made-up rays ---------------------------------------
# CHUNKED_CLOSEST and CHUNKED_ANY against their plain versions on every lane
# (live lanes get the dense sweep from both, the others the unrolled step
# from both): integer outputs equal, t bit for bit.

TIE_LOW, TIE_HIGH = 5, 150  # primitives of chunks 0 and 2
CHUNKED_SCENES = ("suzanne", "spheres", "suzanne_tie", "spheres_tie")
LANE_COUNTS = (1, 31, 1000, 256 * 256 + 7)  # the last: no multiple of the kernels' tile


@pytest.fixture(scope="module")
def chunked_scenes(dev):
    """suzanne (triangle windows), spheres (sphere windows), and each with
    primitive TIE_LOW copied over primitive TIE_HIGH, two chunks on: equal
    t in two windows, and the lower index has to win."""
    from rsoderh_raytracing_tpu_torch.scene.device import FIELDS, device_scene_from_arrays

    scenes = {}
    for name, prefix in (("suzanne", "tri_"), ("spheres", "sph_")):
        host = build_device_scene(_scene(name), "cpu")
        arrays = {f: getattr(host, f).numpy().copy() for f in FIELDS}
        scenes[name] = device_scene_from_arrays(arrays, dev)
        for f in FIELDS:
            if f.startswith(prefix):
                arrays[f][TIE_HIGH] = arrays[f][TIE_LOW]
        scenes[f"{name}_tie"] = device_scene_from_arrays(arrays, dev)
    return scenes


def _made_up_rays(scene, name, n, dev):
    """Incoherent rays from around the scene; in the tie scenes half of
    them aim at the copied primitive; every eighth has a zero direction
    component."""
    g = np.random.default_rng(n)
    o = g.normal(0.0, 3.0, (n, 3)).astype(np.float32)
    d = g.normal(0.0, 1.0, (n, 3)).astype(np.float32) - o * np.float32(0.5)
    if name.endswith("_tie"):
        if name.startswith("suzanne"):
            a, e0, e1 = (getattr(scene, f)[TIE_LOW].cpu().numpy() for f in ("tri_a", "tri_edge0", "tri_edge1"))
            target = a + 0.3 * e0 + 0.3 * e1
        else:
            target = scene.sph_pos[TIE_LOW].cpu().numpy()
        d[::2] = target - o[::2]
    d[::8, g.integers(0, 3)] = 0.0
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20).astype(np.float32)
    mask = (g.random(n) < 0.8).astype(np.int32)
    comps = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev) for k in range(3))  # noqa: E731
    return comps(o), comps(d), torch.from_numpy(mask).to(dev)


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n", LANE_COUNTS)
@pytest.mark.parametrize("name", CHUNKED_SCENES)
def test_chunked_kernels_on_made_up_rays(dev, chunked_scenes, name, n):
    scene = chunked_scenes[name]
    ro, rd, mask = _made_up_rays(scene, name, n, dev)
    before = dict(ci.LAUNCHES)
    for lanes in (mask, torch.zeros_like(mask), torch.ones_like(mask)):
        got = ci.chunked_closest_call(scene, ro, rd, lanes)
        ref = intersect.chunked_closest_plain(scene, ro, rd, lanes)
        assert all(_same(a, b) for a, b in zip(got, ref))
        assert _same(ci.chunked_any_call(scene, ro, rd, lanes),
                     intersect.chunked_any_plain(scene, ro, rd, lanes))
    assert ci.LAUNCHES["chunked_closest"] == before["chunked_closest"] + 3
    assert ci.LAUNCHES["chunked_any"] == before["chunked_any"] + 3
    # a block that holds one or two batches' union boxes at a time restages
    # them as its walk goes on, and answers the same
    for cap in (1, 2):
        got = ci.chunked_closest_call(scene, ro, rd, mask, union_batches=cap)
        assert all(_same(a, b) for a, b in zip(got, intersect.chunked_closest_plain(scene, ro, rd, mask)))
        assert _same(ci.chunked_any_call(scene, ro, rd, mask, union_batches=cap),
                     intersect.chunked_any_plain(scene, ro, rd, mask))
    if name.endswith("_tie") and n >= 1000:
        kind = 2 if name.startswith("suzanne") else 0
        t, ptype, pidx = ci.chunked_closest_call(scene, ro, rd, torch.ones_like(mask))
        won = (ptype == kind) & (pidx == TIE_LOW)
        assert int(won.sum()) > n // 50
        assert not bool(((ptype == kind) & (pidx == TIE_HIGH)).any())


def test_chunked_model_counts_what_the_kernels_compute(dev, chunked_scenes):
    """The traversal model on the card: the kernels' outputs, bit for bit."""
    scene = chunked_scenes["suzanne"]
    ro, rd, mask = _made_up_rays(scene, "suzanne", 5000, dev)
    batch = ci.chunked_batch()
    *model, pairs = intersect.chunked_closest_model(scene, ro, rd, mask, batch)
    assert all(_same(a, b) for a, b in zip(ci.chunked_closest_call(scene, ro, rd, mask), model))
    occ, any_pairs = intersect.chunked_any_model(scene, ro, rd, mask, batch)
    assert _same(ci.chunked_any_call(scene, ro, rd, mask), occ)
    assert pairs > 0 and any_pairs > 0


@pytest.mark.parametrize("n", [1000, 256 * 256 + 7])
def test_chunked_kernels_with_a_nan_vertex(dev, n):
    """suzanne with a NaN x on one vertex of triangle 70: its chunk's box
    has no constraint on x (NaN on both sides), and both kernels equal their
    plain versions on every lane."""
    from rsoderh_raytracing_tpu_torch.scene.device import FIELDS, device_scene_from_arrays

    host = build_device_scene(_scene("suzanne"), "cpu")
    arrays = {f: getattr(host, f).numpy().copy() for f in FIELDS}
    arrays["tri_a"][70, 0] = np.nan
    scene = device_scene_from_arrays(arrays, dev)
    nan = torch.isnan(scene.chunks.bounds).cpu().numpy()
    assert nan[1, [0, 3]].all() and nan.sum() == 2
    ro, rd, mask = _made_up_rays(scene, "suzanne", n, dev)
    got = ci.chunked_closest_call(scene, ro, rd, mask)
    ref = intersect.chunked_closest_plain(scene, ro, rd, mask)
    assert all(_same(a, b) for a, b in zip(got, ref))
    assert _same(ci.chunked_any_call(scene, ro, rd, mask), intersect.chunked_any_plain(scene, ro, rd, mask))


def _lane_masks(n, dev):
    g = np.random.default_rng(n)
    return {
        "none": None,
        "all": torch.ones(n, dtype=torch.int32, device=dev),
        "dead": torch.zeros(n, dtype=torch.int32, device=dev),
        "half": torch.from_numpy((g.uniform(size=n) < 0.5).astype(np.int32)).to(dev),
        "sparse": torch.from_numpy((g.uniform(size=n) < 0.03).astype(np.int32)).to(dev),
    }


@pytest.mark.parametrize("n", LANE_COUNTS)
@pytest.mark.parametrize("name", ["tiny", "house"])
def test_masked_sweeps_bitwise(small_scenes, dev, name, n):
    """CLOSEST and ANY under lane masks (none, all, none set, half, 3%)
    against their plain versions, every output bit for bit on every lane:
    the record and material values on live lanes, the miss record with
    zero attributes on dead ones, 0 on unmasked ANY lanes."""
    scene, origin = small_scenes[name]
    carry = _made_up_carry(n, dev, origin, n + 3)
    ro = tuple(carry[f"ro{i}"] for i in range(3))
    rd = tuple(carry[f"rd{i}"] for i in range(3))
    for label, mask in _lane_masks(n, dev).items():
        before = dict(ci.LAUNCHES)
        got = ci.closest_call(scene, ro, rd, mask)
        occ = ci.any_call(scene, ro, rd, mask)
        assert ci.LAUNCHES["closest"] == before["closest"] + 1
        assert ci.LAUNCHES["any"] == before["any"] + 1
        for k, b in intersect.closest_record(scene, ro, rd, mask).items():
            assert int(_bits_differ(got[k], b).sum()) == 0, (label, k)
        ref = intersect.any_sweep(scene, *ro, *rd)
        if mask is not None:
            ref = ref & (mask != 0)
        assert torch.equal(occ, ref), label


def test_scan_states_match_plain(dev, house_scene):
    """CLOSEST and ANY on the scan integrator's own queries at bounces 0
    and 3 (128x128, 8 bounces) against their plain versions on every
    lane, bit for bit; the dead lanes hold the miss record."""
    _scan_states_bitwise(build_device_scene(house_scene, dev), house_scene, dev)


def _scan_states_bitwise(ds, scene, dev):
    from rsoderh_raytracing_tpu_torch.profiling import capture_scan

    states = capture_scan(ds, _sky(dev), camera_pytree(scene.camera, dev), 128, 8)
    for bounce, state in states.items():
        ro, rd, live = state["closest"]
        p, nd, mask = state["any"]
        live, mask = live.to(torch.int32), mask.to(torch.int32)
        assert 0 < int(mask.sum()) <= int(live.sum())
        got = ci.closest_call(ds, ro, rd, live)
        for k, b in intersect.closest_record(ds, ro, rd, live).items():
            assert int(_bits_differ(got[k], b).sum()) == 0, (bounce, k)
        dead = live == 0
        assert bool((got["type"][dead] == -1).all()) and bool((got["px"][dead] == 0).all())
        assert torch.equal(ci.any_call(ds, p, nd, mask),
                           intersect.any_sweep(ds, *p, *nd) & (mask != 0)), bounce


def test_scan_path_gathers_no_scene_row(dev, house_scene):
    """The scan integrator on the card: CLOSEST and ANY once a bounce, and
    no index_select on a table of the scene (the hit record and material
    values come from CLOSEST)."""
    from rsoderh_raytracing_tpu_torch.profiling import scene_gathers
    from rsoderh_raytracing_tpu_torch.render.integrator import render_sample

    ds = build_device_scene(house_scene, dev)
    env = device_environment(Environment.from_texture("s", procedural_sky(128, 64)), dev)
    cam = camera_pytree(house_scene.camera, dev)
    before = dict(ci.LAUNCHES)
    gathers = scene_gathers(ds, lambda: render_sample(ds, env, cam, 0, (64, 64), 5))
    assert gathers == 0
    assert ci.LAUNCHES["closest"] == before["closest"] + 5
    assert ci.LAUNCHES["any"] == before["any"] + 5


# -- the BVH walks -------------------------------------------------------------
# BVH_CLOSEST and BVH_ANY against their plain twins (ops/bvh.py) on every
# lane, t bit for bit: on made-up rays (origins around the scene, some
# with a zero direction component, whose slab times go NaN), under three
# masks, and on a real loop state.

BVH_SCENES = ("house", "suzanne")


@pytest.fixture(scope="module")
def bvh_scenes(dev):
    return {name: build_device_scene(_scene(name), dev, with_bvh=True) for name in BVH_SCENES}


def _bvh_rays(n, dev, seed=3):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[::7, 1] = 0.0  # axis-parallel: NaN slab times where the origin is on a box face
    ro[::14, 1] = 0.0
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev)
                 for a in (ro, rd) for k in range(3))


@pytest.mark.parametrize("mask", ["all", "mixed", "none"])
@pytest.mark.parametrize("n", [1, 1000, 256 * 256 + 7])
@pytest.mark.parametrize("name", BVH_SCENES)
def test_bvh_kernels_bitwise_on_made_up_rays(dev, bvh_scenes, name, n, mask):
    ds = bvh_scenes[name]
    rays = _bvh_rays(n, dev)
    ro, rd = rays[:3], rays[3:]
    lanes = {"all": torch.ones(n, dtype=torch.int32, device=dev),
             "mixed": (torch.arange(n, device=dev) % 3 != 1).to(torch.int32),
             "none": torch.zeros(n, dtype=torch.int32, device=dev)}[mask]
    before = dict(ci.LAUNCHES)
    got = ci.bvh_closest_call(ds, ro, rd, lanes)
    occ = ci.bvh_any_rays(ds, ro, rd, lanes)
    assert ci.LAUNCHES["bvh_closest"] == before["bvh_closest"] + 1
    assert ci.LAUNCHES["bvh_any"] == before["bvh_any"] + 1
    from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops

    for a, b in zip(got, bvh_ops.closest_plain(ds, ro, rd, lanes)):
        assert int(_bits_differ(a, b).sum()) == 0
    assert torch.equal(occ, bvh_ops.traverse_any(ds.bvh, ro, rd, lanes).to(torch.int32))
    # occlusion is the closest walk's hit without the fallback
    _, slot = bvh_ops.traverse_closest(ds.bvh, ro, rd, lanes)
    assert torch.equal(occ != 0, slot >= 0)


@pytest.fixture(scope="module")
def bvh_state(dev):
    """The BVH route's kernel inputs of a real loop iteration at 128x128
    on suzanne built with its BVH."""
    scene = _scene("suzanne")
    return _loop_state(build_device_scene(scene, dev, with_bvh=True), scene, dev)


def test_bvh_kernels_match_plain_on_a_loop_state(bvh_state):
    from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops

    args = bvh_state["closest"]
    for a, b in zip(ci.bvh_closest_call(*args), bvh_ops.closest_plain(*args)):
        assert int(_bits_differ(a, b).sum()) == 0
    args = bvh_state["occlusion"]
    occ = ci.bvh_any_call(*args)
    assert torch.equal(occ, bvh_ops.any_plain(*args))
    assert int(occ.sum()) > 0


def test_env_draw_kernel_matches_plain_on_a_bvh_loop_state(bvh_state):
    """ENV_DRAW on the BVH route's loop state against its plain twin: the
    state, NEE uv and pmf bitwise on every lane, and so the alias index
    (the uv is the index's texel plus the jitter of the same draws, and
    two texels' uvs differ by far more than an ulp); the NEE direction at
    the gates."""
    args = bvh_state["env_draw"]
    before = cw.LAUNCHES["env_draw"]
    _compare_env_draw(args)
    assert cw.LAUNCHES["env_draw"] == before + 1


def _compare_env_draw(args):
    """ENV_DRAW against its plain twin: the draw bitwise on every lane,
    every output at the gates."""
    got, ref = cw.env_draw_call(*args), cw.env_draw_plain(*args)
    exact = ("state", "nee_u", "nee_v", "nee_pmf")
    assert {k: int(_bits_differ(got[k], ref[k]).sum()) for k in exact} == dict.fromkeys(exact, 0)
    _compare(got, ref, {"state"})


def test_big_shade_kernel_matches_plain_on_a_bvh_loop_state(bvh_state):
    """BIG_SHADE, which reads the quad row at the fused uv itself, against
    big_shade_plain (the fused uv, one index_select, the shade) output by
    output."""
    args = bvh_state["big_shade"]
    _compare_shade(cw.big_shade_call, cw.big_shade_plain, args)


# BVH_ANY and BIG_SHADE derive the hit point ro + rd * t and the shadow
# rays' mask from the closest hit's (t, type) themselves: bitwise their
# plain twins (intersect.shadow_origins, intersect.hit_point), on a BVH
# state of triangle leaves (suzanne) and one of sphere leaves
# (rtiow_final, whose misses take the fallback pass).

@pytest.fixture(scope="module")
def leaf_states(dev, bvh_state):
    scene = _scene("rtiow_final")
    return {"triangles": bvh_state,
            "spheres": _loop_state(build_device_scene(scene, dev, with_bvh=True), scene, dev)}


@pytest.mark.parametrize("leaves", ["triangles", "spheres"])
def test_bvh_any_derives_its_shadow_rays_bitwise(dev, leaf_states, leaves):
    """BVH_ANY on (ro, rd, t, type, in_path, NEE direction) against
    any_plain on every lane: the loop state's own inputs, then made-up t,
    types and in_path on the same rays (misses, lanes out of a path, hit
    points anywhere along the ray)."""
    from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops

    args = leaf_states[leaves]["occlusion"]
    scene, ro, rd, t, ptype, in_path, nd = args
    assert route(scene) == BVH and int(((ptype >= 0) & (in_path != 0)).sum()) > 0
    before = ci.LAUNCHES["bvh_any"]
    occ = ci.bvh_any_call(*args)
    assert ci.LAUNCHES["bvh_any"] == before + 1
    assert torch.equal(occ, bvh_ops.any_plain(*args)) and int(occ.sum()) > 0
    g = torch.Generator(device=dev).manual_seed(11)
    n = t.shape[0]
    made_up = (scene, ro, rd, torch.rand(n, generator=g, device=dev) * 4.0,
               torch.randint(-1, 3, (n,), generator=g, device=dev, dtype=torch.int32),
               (torch.rand(n, generator=g, device=dev) < 0.8).to(torch.int32), nd)
    occ = ci.bvh_any_call(*made_up)
    assert torch.equal(occ, bvh_ops.any_plain(*made_up)) and int(occ.sum()) > 0


@pytest.mark.parametrize("leaves", ["triangles", "spheres"])
def test_big_shade_derives_its_hit_point(leaf_states, leaves):
    """BIG_SHADE on the closest hit's t against big_shade_plain: every
    output at the gates and the counters equal; on the lanes that continue
    their path in both, the new ray origin is the hit point, bitwise."""
    args = leaf_states[leaves]["big_shade"]
    got, ref = _compare_shade(cw.big_shade_call, cw.big_shade_plain, args)
    carry, tr = args[13], args[7]
    p = intersect.hit_point(tuple(carry[f"ro{k}"] for k in range(3)),
                            tuple(carry[f"rd{k}"] for k in range(3)), tr["t"], tr["btype"])
    went_on = (carry["in_path"] != 0) & (tr["btype"] >= 0)
    for out in (got, ref):
        went_on &= (out["in_path"] != 0) & (out["bounce"] > 0)
    assert int(went_on.sum()) > 0
    for k in range(3):
        assert int(_bits_differ(got[f"ro{k}"], p[k])[went_on].sum()) == 0


@pytest.mark.parametrize("name,with_bvh", [("house", False), ("suzanne", True)])
def test_ray_counters_over_a_ragged_run(dev, name, with_bvh):
    """A free-run at 37x29 lanes (not a multiple of a block), two
    iterations past the drain: closest rays are the lanes in a path before
    each iteration, iterations those with any, and shadow rays the sum of
    the hits, as each iteration's plain shade counts them on its own
    captured arguments."""
    scene = _scene(name)
    ds = build_device_scene(scene, dev, with_bvh=with_bvh)
    wave = Wavefront(ds, _sky(dev), camera_pytree(scene.camera, dev), 0, (37, 29), NO_LIMIT, 4, 8)
    key = "big_shade" if with_bvh else "shade"
    plain = cw.big_shade_plain if with_bvh else cw.shade_plain
    closest = shadow = iterations = 0
    for it in range(wave.drain_iterations() + 2):
        live = int((wave.carry["in_path"] != 0).sum())
        closest, iterations = closest + live, iterations + (live > 0)
        args = capture_step(wave, it)[key]
        shadow += int(_counted(plain, args)[1][1])
    stats = {k: int(v) for k, v in wave.results()[2].items()}
    assert (stats["closest_rays"], stats["shadow_rays"], stats["iterations"]) == (closest, shadow, iterations)
    assert 0 < iterations < wave.drain_iterations() + 2 and 0 < shadow < closest


def test_bvh_step_runs_no_gather_and_one_env_draw(dev, tmp_path):
    """One BVH-route Wavefront.step under torch.profiler: one ENV_DRAW
    launch, and no index_select, on the host or as a kernel of the gather
    group (profiling._group) on the card."""
    scene = _scene("suzanne")
    ds = build_device_scene(scene, dev, with_bvh=True)
    env = device_environment(Environment.from_texture("s", procedural_sky(256, 128)), dev)
    wave = Wavefront(ds, env, camera_pytree(scene.camera, dev), 0, (128, 128), NO_LIMIT, 32, 8)
    for it in range(3):
        wave.step(it)
    torch.cuda.synchronize()
    before = cw.LAUNCHES["env_draw"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wave.step(3)
        torch.cuda.synchronize()
    assert cw.LAUNCHES["env_draw"] == before + 1
    assert [e.key for e in prof.key_averages() if "index_select" in e.key] == []
    path = str(tmp_path / "step.json")
    prof.export_chrome_trace(path)
    launched = {}
    per_kernel, groups, _, _ = kernel_breakdown(path, 1, group_launches=launched)
    assert groups["gather"] == 0.0, per_kernel
    assert launched["env_draw"] == 1 and launched["big_shade"] == 1


def test_card_bvh_render_matches_cpu_render(dev):
    """render_freerun through the BVH route (BVH_CLOSEST, BVH_ANY and
    BIG_SHADE once an iteration) against the CPU's plain route."""
    scene = _scene("suzanne")
    env_args = Environment.from_texture("s", procedural_sky(128, 64))
    out = {}
    for device in ("cpu", dev):
        before = {**ci.LAUNCHES, **cw.LAUNCHES}
        img, counts = render_freerun(
            build_device_scene(scene, device, with_bvh=True), device_environment(env_args, device),
            camera_pytree(scene.camera, device), 0, (32, 32), 16, 8,
        )
        launched = {k: v - before[k] for k, v in {**ci.LAUNCHES, **cw.LAUNCHES}.items()}
        out[str(device)] = (img.cpu().numpy(), counts.cpu().numpy(), launched)
    (ci_, cc, _), (gi, gc, launched) = out["cpu"], out[str(dev)]
    assert launched["bvh_closest"] == launched["bvh_any"] == launched["big_shade"] == 16 + 8 - 1
    assert not launched["chunked_closest"] and not launched["trace"]
    assert (cc == gc).mean() >= 0.99
    np.testing.assert_allclose(gi.mean(), ci_.mean(), rtol=2e-3)


# -- BVH_CLOSEST's fallback pass -------------------------------------------------
# The packed, staged pass (csrc/bvh.cu: fallback_kernel) against
# closest_plain: (t, type, index) bitwise on every lane and the lanes it
# adds to fallback_lanes, on rtiow_final (486 sphere rows and a plane), on a
# scene of more sphere rows than a block stages, and on suzanne (a plane
# row alone).

def _rtiow_rays(n, dev, seed=5):
    """Seeded rays from around rtiow_final's camera towards its spheres'
    layer and the ground, an eighth of them up into the sky: the walk
    hits some and leaves the rest to the pass, scattered."""
    g = np.random.default_rng(seed)
    o = (np.array([13.0, 2.0, 3.0], np.float32) + g.normal(0.0, 0.5, (n, 3))).astype(np.float32)
    d = g.uniform((-11.0, 0.0, -11.0), (11.0, 1.5, 11.0), (n, 3)).astype(np.float32) - o
    d[::8, 1] = np.abs(d[::8, 1]) + 2.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev) for a in (o, d) for k in range(3)]


def _fallback_matches_plain(ds, rays, live):
    """BVH_CLOSEST against closest_plain on every lane, bitwise, and both
    fallback_lanes counts; returns the count."""
    from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops

    ro, rd = tuple(rays[:3]), tuple(rays[3:])
    counted = [torch.zeros((), dtype=torch.int64, device=live.device) for _ in range(2)]
    got = ci.bvh_closest_call(ds, ro, rd, live, fallback_lanes=counted[0])
    want = bvh_ops.closest_plain(ds, ro, rd, live, fallback_lanes=counted[1])
    assert [int(_bits_differ(a, b).sum()) for a, b in zip(got, want)] == [0, 0, 0]
    assert int(counted[0]) == int(counted[1])
    return int(counted[0])


def _many_spheres_scene(rtiow):
    """rtiow_final with its spheres replaced by a 120 x 120 grid of small
    ones (14,400 rows, 230,400 bytes staged: past what a block stages)."""
    import dataclasses

    spheres = [Sphere(pos=(-30.0 + 0.5 * i, 0.2, -30.0 + 0.5 * j), radius=0.15,
                      material_id=(i + j) % len(rtiow.materials))
               for i in range(120) for j in range(120)]
    return dataclasses.replace(rtiow, spheres=spheres)


@pytest.fixture(scope="module")
def fallback_scenes(dev):
    rtiow = _scene("rtiow_final")
    return {"rtiow_final": build_device_scene(rtiow, dev, with_bvh=True),
            "many_spheres": build_device_scene(_many_spheres_scene(rtiow), dev, with_bvh=True),
            "suzanne": build_device_scene(_scene("suzanne"), dev, with_bvh=True)}


def test_fallback_pass_on_an_rtiow_loop_state(dev, fallback_scenes):
    """A 2048^2 loop state of rtiow_final, the benchmark's size: about
    four tiles a block, so each block's ring carries lanes from tile to
    tile and wraps."""
    ds = fallback_scenes["rtiow_final"]
    scene = _scene("rtiow_final")
    env = device_environment(Environment.from_texture("sky", procedural_sky(256, 128)), dev)
    wave = Wavefront(ds, env, camera_pytree(scene.camera, dev), 0, (2048, 2048), NO_LIMIT, 16, 8)
    for it in range(3):
        wave.step(it)
    _, ro, rd, live = capture_step(wave, 3)["closest"]
    assert _fallback_matches_plain(ds, [*ro, *rd], live) > 0


@pytest.mark.parametrize("case", ["scattered", "empty_tiles", "ragged", "no_live_lane"])
def test_fallback_pass_on_made_up_rays(dev, fallback_scenes, case):
    """Scattered pending lanes on 2^21 + 333 lanes (several tiles a block,
    n not a multiple of a tile, a third off the mask); tiles without a
    pending lane (lanes 1024-2047 aimed at sphere centres, so each walk
    hits; 2048-3071 off the mask); a short ragged launch; a mask with no
    live lane."""
    from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops

    ds = fallback_scenes["rtiow_final"]
    n = {"scattered": 2**21 + 333, "empty_tiles": 4 * 1024 + 5, "ragged": 3 * 1024 + 333,
         "no_live_lane": 5000}[case]
    rays = _rtiow_rays(n, dev)
    live = torch.ones(n, dtype=torch.int32, device=dev)
    if case == "scattered":
        live = (torch.arange(n, device=dev) % 3 != 1).to(torch.int32)
    if case == "no_live_lane":
        live.zero_()
    if case == "empty_tiles":
        centres = ds.sph_pos[torch.arange(1024, device=dev) % ds.sweep_rows[0]].T
        direction = centres - torch.stack([r[1024:2048] for r in rays[:3]])
        direction = direction / direction.norm(dim=0)
        for k in range(3):
            rays[3 + k][1024:2048] = direction[k]
        live[2048:3072] = 0
        _, slot = bvh_ops.traverse_closest(ds.bvh, tuple(rays[:3]), tuple(rays[3:]), live)
        assert bool((slot[1024:2048] >= 0).all())
    swept = _fallback_matches_plain(ds, rays, live)
    assert (swept == 0) == (case == "no_live_lane")


@pytest.mark.parametrize("name", ["many_spheres", "suzanne"])
def test_fallback_pass_staged_or_not(dev, fallback_scenes, name):
    """More sphere rows than a block stages (read from global memory), and
    a plane row alone (suzanne's pass), on 65,536 + 7 made-up lanes."""
    from rsoderh_raytracing_tpu_torch.ops import _kernels
    from rsoderh_raytracing_tpu_torch.scene.device import fallback_shared_bytes

    ds = fallback_scenes[name]
    rows = ds.sweep_rows[:2]
    staged = _kernels.library().rt_bvh_fallback_shared_bytes(*rows)
    assert staged == fallback_shared_bytes(*rows) == {"many_spheres": 0, "suzanne": 64}[name]
    rays = _rtiow_rays(65536 + 7, dev) if name == "many_spheres" else _bvh_rays(65536 + 7, dev)
    assert _fallback_matches_plain(ds, rays, torch.ones(65536 + 7, dtype=torch.int32, device=dev)) > 0


def test_fallback_shared_mirror_equals_the_card(dev):
    """FALLBACK_MAX_SHARED is what the card lets the staged pass ask for,
    and fallback_shared_bytes is the launcher's choice on both sides of it."""
    from rsoderh_raytracing_tpu_torch.ops import _kernels
    from rsoderh_raytracing_tpu_torch.scene.device import FALLBACK_MAX_SHARED, fallback_shared_bytes

    lib = _kernels.library()
    assert lib.rt_bvh_fallback_max_rows_bytes() == FALLBACK_MAX_SHARED
    for rows in ((0, 0), (0, 1), (486, 1), (14007, 0), (14003, 1), (14004, 1), (14008, 0), (14400, 1)):
        assert lib.rt_bvh_fallback_shared_bytes(*rows) == fallback_shared_bytes(*rows)


@pytest.fixture(scope="module")
def house_args(dev, house_scene):
    env = device_environment(Environment.from_texture("s", procedural_sky(256, 128)), dev)
    return build_device_scene(house_scene, dev), env, camera_pytree(house_scene.camera, dev)


def test_tile_only_sharded_freerun_is_bitwise_on_the_card(dev, house_args):
    """A (2, 1) mesh of two slots on the card: every lane runs the same
    kernels on the same inputs, so image and counts are the unsharded
    render's bit for bit."""
    from rsoderh_raytracing_tpu_torch.parallel.sharding import make_mesh, render_freerun_sharded

    mesh = make_mesh(n_devices=2, tile=2, devices=[dev] * 2)
    before = cw.LAUNCHES["trace"]
    img, counts, _ = render_freerun_sharded(*house_args, 0, mesh, (64, 64), 16, 8)
    assert cw.LAUNCHES["trace"] == before + 2 * (16 + 8 - 1)
    ref, ref_counts = render_freerun(*house_args, 0, (64, 64), 16, 8)
    assert torch.equal(img.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(counts, ref_counts)


@pytest.mark.parametrize("tile", [1, 2])
def test_dp2_sharded_on_the_card(dev, house_args, tile):
    """dp:2 and tile:2,dp:2 on slots of the one card: with max_bounces=1
    the counts are exactly budget * 2, the image the unsharded render of
    the same samples within the reference's 2e-5; the per-sample step is
    the sum of render_sample for samples 0 and 1 within 1e-4."""
    from rsoderh_raytracing_tpu_torch.parallel.sharding import (
        make_mesh, render_freerun_sharded, render_spp_sharded,
    )
    from rsoderh_raytracing_tpu_torch.render.integrator import render_sample
    from rsoderh_raytracing_tpu_torch.render.wavefront import render_wavefront

    mesh = make_mesh(n_devices=2 * tile, tile=tile, devices=[dev] * (2 * tile))
    budget = 4
    img, counts, _ = render_freerun_sharded(*house_args, 0, mesh, (64, 64), budget, 1)
    assert bool((counts == budget * 2).all())
    ref = render_wavefront(*house_args, 0, (64, 64), budget * 2, 1)
    torch.testing.assert_close(img, ref, rtol=2e-5, atol=2e-5)
    summed = render_spp_sharded(*house_args, 0, mesh, (64, 64), 4)
    seq = render_sample(*house_args, 0, (64, 64), 4) + render_sample(*house_args, 1, (64, 64), 4)
    torch.testing.assert_close(summed, seq, rtol=1e-4, atol=1e-4)


def test_sync_rounds_on_the_card(dev, house_args):
    """render_spp_sync against render_wavefront(spp=rounds) on the card:
    counts equal, and the image within the anchors' flip-aware criteria
    (SHADE regenerates render_wavefront's later camera rays in-kernel)."""
    from rsoderh_raytracing_tpu_torch.render.wavefront import render_spp_sync, render_wavefront

    before = cw.LAUNCHES["shade"]
    img, counts = render_spp_sync(*house_args, 0, (64, 64), 2, 8)
    assert cw.LAUNCHES["shade"] == before + 2 * 8
    ref = render_wavefront(*house_args, 0, (64, 64), 2, 8)
    assert bool((counts == 2).all())
    diff = (img - ref).cpu().numpy() / 2
    flipped = np.abs(diff).max(-1) > 1e-2
    keep = ~flipped
    ref_mean = ref.cpu().numpy() / 2
    rel = np.sqrt((diff[keep] ** 2).mean()) / np.sqrt((ref_mean[keep] ** 2).mean())
    assert flipped.mean() < 0.03 and rel < 0.005


# -- the chunk orders and the raised ceiling -----------------------------------
# The three big-mesh kernels on suzanne stored in the bvh and treelet orders
# (treelet's pad rows lie between real triangles) and in the host's order:
# CHUNKED_CLOSEST and CHUNKED_ANY bitwise their plain versions on every
# lane, BIG_SHADE by the gates.

ORDER_KNOBS = {"bvh": {"RT_CHUNK_CLUSTER": "bvh"}, "treelet": {"RT_CHUNK_CLUSTER": "treelet"},
               "host": {"RT_DISABLE_MORTON": "1"}}


@pytest.fixture(scope="module", params=sorted(ORDER_KNOBS))
def ordered_state(request, dev):
    """The big-mesh kernels' inputs of a real loop iteration at 128x128 on
    suzanne in one order."""
    scene = _scene("suzanne")
    ds = _ordered_scene(scene, dev, request.param)
    return request.param, ds, _loop_state(ds, scene, dev)


def _ordered_scene(scene, dev, order):
    """build_device_scene with the chunks in `order` (ORDER_KNOBS, or the
    default "morton")."""
    with pytest.MonkeyPatch.context() as mp:
        for knob in ("RT_CHUNK_CLUSTER", "RT_DISABLE_MORTON"):
            mp.delenv(knob, raising=False)
        for knob, value in ORDER_KNOBS.get(order, {}).items():
            mp.setenv(knob, value)
        return build_device_scene(scene, dev)


def test_big_mesh_kernels_in_each_order(ordered_state):
    order, ds, state = ordered_state
    interleaved = (~ds.tri_valid.reshape(-1, 64)[:-1]).any()
    assert bool(interleaved) == (order == "treelet")
    args = state["closest"]
    for a, b in zip(ci.chunked_closest_call(*args), intersect.chunked_closest_plain(*args)):
        assert int(_bits_differ(a, b).sum()) == 0
    args = state["occlusion"]
    assert torch.equal(ci.chunked_occlusion_call(*args), ci.chunked_occlusion_plain(*args))
    assert int(intersect.shadow_origins(*args[1:6])[1].sum()) > 0
    args = state["big_shade"]
    _compare_shade(cw.big_shade_call, cw.big_shade_plain, args)


def test_sweep_shared_mirror_equals_the_card(dev):
    """The sweep kernels' table limit that scene/device.py mirrors is what
    the card lets CLOSEST, ANY and FUSED ask for; a table at the limit
    launches staged, one material row past it launches too, read from
    global memory."""
    import ctypes

    from rsoderh_raytracing_tpu_torch.ops import _kernels
    from rsoderh_raytracing_tpu_torch.scene.device import SWEEP_MAX_SHARED

    assert ci.sweep_max_table_bytes() == SWEEP_MAX_SHARED
    # CLOSEST on 32 lanes over a table of material rows alone: every ray
    # misses, so only the staging reads the table
    n = 32
    rays = [torch.zeros(n, device=dev) for _ in range(6)]
    outs = [torch.empty(n, device=dev, dtype=torch.int32 if k in ci.CLOSEST_INT_NAMES else torch.float32)
            for k in ci.CLOSEST_OUT_NAMES]
    ptrs = [t.data_ptr() for t in rays] + [0] + [t.data_ptr() for t in outs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for floats in (SWEEP_MAX_SHARED // 4, SWEEP_MAX_SHARED // 4 + 8):
        outs[1].zero_()
        table = torch.zeros(floats, device=dev)
        rc = _kernels.library().rt_closest_launch(
            (ctypes.c_void_p * len(ptrs))(*ptrs), table.data_ptr(), floats, n, 0, 0, 0, floats // 8,
            0, 0, 0, stream)
        assert rc == 0, rc
        torch.cuda.synchronize()
        assert bool((outs[1] == -1).all())


@pytest.mark.parametrize("small_len", [0, 192, 768, 3072])
def test_shared_mirror_equals_the_kernels(dev, small_len):
    from rsoderh_raytracing_tpu_torch.ops import _kernels
    from rsoderh_raytracing_tpu_torch.scene.device import chunked_shared_bytes

    lib = _kernels.library()
    for n_chunks in (1, 15, 16, 17, 242, 3872, 15488, 16384, 20272, 20273, 30000):
        assert chunked_shared_bytes(small_len, n_chunks) == lib.rt_chunked_shared_bytes(small_len, n_chunks)


def test_raised_ceiling_sixteen_thousand_chunks(dev, monkeypatch):
    """A seeded grid of 1,048,576 small triangles (16,384 chunks) under
    RT_MAX_CHUNKED_TRIS=1048576: the chunked route on the card (under
    with_bvh=False: past CUDA_BVH_ABOVE_LANES 'auto' walks the BVH under
    either ceiling), both kernels bitwise their plain versions on 4,096
    lanes, t included."""
    from rsoderh_raytracing_tpu_torch.scene.device import CHUNKED, auto_bvh, route

    n_tri = 1 << 20
    side = 1 << 10
    g = np.random.default_rng(16)
    ij = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1).reshape(-1, 2)
    base = np.concatenate([ij * 0.01, g.normal(0.0, 0.002, (n_tri, 1))], axis=1).astype(np.float32)
    vertices = np.concatenate([base, base + [0.009, 0, 0], base + [0, 0.009, 0]]).astype(np.float32)
    idx = np.arange(n_tri)
    tris = np.stack([idx, idx + n_tri, idx + 2 * n_tri] + [np.zeros(n_tri, np.int64)] * 4,
                    axis=-1).astype(np.int32)
    scene = Scene(materials=[Material((1, 1, 1), 1, 0, (0, 0, 0))], spheres=[], planes=[],
                  meshes=PackedMeshes(vertices=vertices, normals=np.array([[0.0, 0.0, 1.0]], np.float32),
                                      triangles=tris),
                  camera=Camera(pos=[5.0, 5.0, 3.0], yaw=0, pitch=0, fov_y=1.0))
    monkeypatch.delenv("RT_CHUNK_CLUSTER", raising=False)
    monkeypatch.setenv("RT_MAX_CHUNKED_TRIS", "1048576")
    ds = build_device_scene(scene, dev, with_bvh=False)
    assert route(ds) == CHUNKED and ds.chunks.count == 16384 and auto_bvh(8, 8, n_tri, dev)
    n = 4096
    o = np.concatenate([g.uniform(0.0, 10.24, (n, 2)), g.uniform(0.5, 3.0, (n, 1))], axis=1)
    d = np.concatenate([g.uniform(0.0, 10.24, (n, 2)), np.zeros((n, 1))], axis=1) - o
    d[::5] = g.normal(size=(len(d[::5]), 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    comps = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, k], np.float32)).to(dev)  # noqa: E731
                            for k in range(3))
    ro, rd = comps(o), comps(d)
    mask = torch.from_numpy((g.random(n) < 0.9).astype(np.int32)).to(dev)
    got = ci.chunked_closest_call(ds, ro, rd, mask)
    ref = intersect.chunked_closest_plain(ds, ro, rd, mask)
    for a, b in zip(got, ref):
        assert int(_bits_differ(a, b).sum()) == 0
    assert int((got[1] == 2).sum()) > n // 4  # about 40% of a cell is triangle
    assert torch.equal(ci.chunked_any_call(ds, ro, rd, mask), intersect.chunked_any_plain(ds, ro, rd, mask))
    monkeypatch.delenv("RT_MAX_CHUNKED_TRIS")
    assert auto_bvh(8, 8, n_tri, dev)


# -- the routes end to end -------------------------------------------------------
# What a free-run iteration launches on each route, the goldens and the
# oracle's anchors through the card's kernels, the command line, the composed
# body, the two knobs, the lane layout, the chunk orders and the small route
# past shared memory. Two images of the same samples that the card's kernels
# may round apart are held to the anchors' flip-aware criteria
# (tests/test_torch_wavefront.py): a pixel flips where a channel differs by
# more than FLIP_ABS; under FLIPPED_MAX of the pixels flip, and the rest
# agree within a relative RMSE of UNFLIPPED_REL_RMSE_MAX.

FLIP_ABS, FLIPPED_MAX, UNFLIPPED_REL_RMSE_MAX = 1e-2, 0.03, 0.005
# Relative RMSE against the CPU-made goldens; measured on an H100 (700 W):
# 1.35e-4 (default), 1.04e-4 (house).
GOLDEN_REL_RMSE_MAX = 1e-3
ROUTE_LAUNCHES = {SMALL: {"trace", "shade"}, CHUNKED: {"env_draw", "chunked_closest", "chunked_any", "big_shade"},
                  BVH: {"env_draw", "bvh_closest", "bvh_any", "big_shade"}}


def _launched_by(fn):
    """(fn(), {kernel: launches} of the port's kernels it launched)."""
    before = {**ci.LAUNCHES, **cw.LAUNCHES}
    out = fn()
    return out, {k: v - before[k] for k, v in {**ci.LAUNCHES, **cw.LAUNCHES}.items() if v != before[k]}


def _freerun_image(ds, env, cam, size, budget):
    """(mean image, counts) of one free-run call at size^2, 8 bounces."""
    img, counts = render_freerun(ds, env, cam, 0, (size, size), budget, 8)
    return (img / counts.clamp_min(1).unsqueeze(-1).to(img.dtype)).cpu().numpy(), counts.cpu().numpy()


def _flip_criteria(got, ref):
    """(flipped share, relative RMSE of the other pixels) of two mean images."""
    diff = got - ref
    flipped = np.abs(diff).max(-1) > FLIP_ABS
    keep = ~flipped
    return float(flipped.mean()), float(np.sqrt((diff[keep] ** 2).mean()) / np.sqrt((ref[keep] ** 2).mean()))


def _same_image(got, ref):
    """Two (mean image, counts) of the same samples: counts equal on 99.9%
    of the pixels, the images by the flip-aware criteria."""
    flipped, rel = _flip_criteria(got[0], ref[0])
    assert (got[1] == ref[1]).mean() >= 0.999
    assert flipped < FLIPPED_MAX and rel < UNFLIPPED_REL_RMSE_MAX, (flipped, rel)


def _same_render(a, b):
    """Two (image, counts, stats) bit for bit."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and torch.equal(a[1], b[1])
    assert {k: int(v) for k, v in a[2].items()} == {k: int(v) for k, v in b[2].items()}


@pytest.mark.parametrize("name,with_bvh,expected", [
    ("house", False, SMALL), ("house_tiled16", False, SMALL), ("suzanne", False, CHUNKED), ("suzanne", True, BVH),
])
def test_each_route_launches_its_own_kernels(dev, name, with_bvh, expected):
    """A 64x64 free-run call of 16 iterations and 8 bounces launches each
    of its route's kernels once an iteration and no other kernel of the
    port, and samples every pixel (house_tiled16: the small route past the
    192-lane unroll budget)."""
    scene = _scene(name)
    ds = build_device_scene(scene, dev, with_bvh=with_bvh)
    assert route(ds) == expected
    (img, counts), launched = _launched_by(
        lambda: render_freerun(ds, _sky(dev), camera_pytree(scene.camera, dev), 0, (64, 64), 16, 8))
    assert launched == dict.fromkeys(ROUTE_LAUNCHES[expected], 16 + 8 - 1)
    assert bool(torch.isfinite(img).all()) and int(counts.min()) > 0


def test_small_route_runs_no_gather(dev, house_scene, tmp_path):
    """A free-run call on house under torch.profiler: TRACE and SHADE once
    an iteration, and no index_select, on the host or as a kernel of the
    gather group (profiling._group) on the card."""
    ds, cam = build_device_scene(house_scene, dev), camera_pytree(house_scene.camera, dev)
    env = _sky(dev)
    render_freerun(ds, env, cam, 0, (128, 128), 4, 8)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        render_freerun(ds, env, cam, 0, (128, 128), 4, 8)
        torch.cuda.synchronize()
    assert [e.key for e in prof.key_averages() if "index_select" in e.key] == []
    path = str(tmp_path / "call.json")
    prof.export_chrome_trace(path)
    launched = {}
    per_kernel, groups, _, _ = kernel_breakdown(path, 4 + 8 - 1, group_launches=launched)
    assert groups["gather"] == 0.0, per_kernel
    assert round(launched["trace"], 6) == round(launched["shade"], 6) == 1


@pytest.mark.parametrize("name", ["default", "house"])
def test_golden_through_the_card(dev, name):
    """render_wavefront through the small route's kernels (64x64, 8 spp, 4
    bounces) against tests/goldens/NAME_64_8spp.npy, made on the CPU: the
    kernels' sin, cos and sqrt round as libdevice does, so a few paths
    flip; relative RMSE below GOLDEN_REL_RMSE_MAX."""
    scene = _scene(name)
    env = device_environment(Environment.from_texture("golden_sky", procedural_sky(256, 128, sun_radius=0.05)),
                             dev)
    img = render_wavefront(build_device_scene(scene, dev), env, camera_pytree(scene.camera, dev), 0, (64, 64),
                           8, 4).cpu().numpy() / 8
    golden = np.load(os.path.join(REPO, "tests", "goldens", f"{name}_64_8spp.npy"))
    assert np.sqrt(np.mean((img - golden) ** 2)) / np.sqrt(np.mean(golden ** 2)) < GOLDEN_REL_RMSE_MAX


@pytest.fixture(scope="module")
def suzanne_xhi(tmp_path_factory):
    """suzanne_xhi.toml's scene, its mesh (scripts/subdivide_obj.py 4:
    247,808 triangles) written to a temporary directory."""
    mesh = str(tmp_path_factory.mktemp("mesh") / "suzanne_xhi.obj")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "subdivide_obj.py"), "4", mesh],
                   check=True, stdout=subprocess.DEVNULL, timeout=600)
    path = os.path.join(SCENES, "suzanne_xhi.toml")
    with open(path, "rb") as f:
        descriptor = tomllib.load(f)
    for obj in descriptor["object"]:
        if "Mesh" in obj:
            obj["Mesh"]["path"] = mesh
    return build_scene(descriptor, path)


ANCHORS = {"suzanne_hi": (24, 2), "spheres": (32, 4), "suzanne_xhi": (16, 2)}


@pytest.mark.parametrize("name,with_bvh", [
    ("suzanne_hi", False), ("spheres", False), ("suzanne_xhi", False), ("suzanne_xhi", True),
])
def test_oracle_anchor_through_the_card(dev, request, name, with_bvh):
    """render_wavefront through the card's kernels against the numpy
    oracle's anchor golden (tests/goldens/NAME_anchor_SIZE_SPPspp.npy,
    scripts/reference_estimator.py), suzanne_xhi through the chunked and
    the BVH route: on the meshes the flip-aware criteria with more than
    95% of the pixels within 1e-4; on spheres, whose f32 sphere tests
    round apart more, more than 45% within 1e-4, the unflipped RMSE and
    the image mean within 5%."""
    scene = request.getfixturevalue("suzanne_xhi") if name == "suzanne_xhi" else _scene(name)
    size, spp = ANCHORS[name]
    ds = build_device_scene(scene, dev, with_bvh=with_bvh)
    assert route(ds) == (BVH if with_bvh else CHUNKED)
    env = device_environment(load_default_environments()[0], dev)
    ours = render_wavefront(ds, env, camera_pytree(scene.camera, dev), 0, (size, size), spp,
                            MAX_BOUNCES).cpu().numpy() / spp
    ref = np.load(os.path.join(REPO, "tests", "goldens", f"{name}_anchor_{size}_{spp}spp.npy"))
    flipped, rel = _flip_criteria(ours, ref)
    within = float((np.abs(ours - ref).max(-1) < 1e-4).mean())
    assert rel < UNFLIPPED_REL_RMSE_MAX, rel
    if name == "spheres":
        assert within > 0.45 and abs(float(ours.mean()) / float(ref.mean()) - 1) < 0.05
    else:
        assert flipped < FLIPPED_MAX and within > 0.95, (flipped, within)


def test_command_line_on_the_card(dev, tmp_path):
    """cli.main on house at 256x256, 8 spp, on the card: the exact and the
    free-run PNG are the srgb8 of a Renderer's film of the same render; an
    .hdr with a checkpoint; resuming at the saved count renders nothing
    more, resuming to 12 spp reaches 12 on every pixel."""
    scene_path = os.path.join(SCENES, "house.toml")
    base = ["--scene", scene_path, "--resolution", "256x256", "--quiet"]

    def out(name):
        return str(tmp_path / name)

    for mode in ("exact", "freerun"):
        assert cli.main(base + ["--spp", "8", "--mode", mode, "--output", out(f"{mode}.png")]) == 0
        renderer = Renderer(load_scene(scene_path), 256, 256, device=dev)
        renderer.render(spp=8, mode=mode)
        np.testing.assert_array_equal(read_png(out(f"{mode}.png")), renderer.film.srgb8())
    assert cli.main(base + ["--spp", "8", "--output", out("a.hdr"), "--save-checkpoint", out("8.npz")]) == 0
    hdr = read_hdr(out("a.hdr"))
    assert hdr.shape == (256, 256, 3) and np.isfinite(hdr).all() and hdr.mean() > 0
    for spp, saved in (("8", "8b.npz"), ("12", "12.npz")):
        assert cli.main(base + ["--spp", spp, "--checkpoint", out("8.npz"), "--output", out(f"{spp}.png"),
                                "--save-checkpoint", out(saved)]) == 0
    with np.load(out("8.npz")) as a, np.load(out("8b.npz")) as b, np.load(out("12.npz")) as c:
        assert int(a["sample_count"]) == 8 and a["counts"].dtype == np.uint32 and "state_stamp" in a.files
        assert int(b["sample_count"]) == 8 and np.array_equal(a["cumulative"], b["cumulative"])
        assert int(c["sample_count"]) == 12 and (c["counts"] == 12).all()


def test_composed_body_against_the_kernel_loop(dev, house_args, monkeypatch):
    """The composed body on the card (FUSED once an iteration, no TRACE or
    SHADE): under RT_DISABLE_WFKERNELS=1 against the kernel loop at
    128x128, 16 iterations, the same iterations, counts equal on 99.99% of
    the pixels and the mean images within GOLDEN_REL_RMSE_MAX; and with
    the legacy float32 quad, which the kernel loop does not read."""
    monkeypatch.delenv("RT_DISABLE_WFKERNELS", raising=False)
    iterations = 16 + 8 - 1

    def call(env=house_args[1]):
        return _launched_by(lambda: render_freerun(house_args[0], env, house_args[2], 0, (128, 128), 16, 8,
                                                   with_stats=True))

    (k_img, k_cnt, k_st), launched = call()
    assert launched == {"trace": iterations, "shade": iterations}
    legacy = device_environment(Environment.from_texture("s", procedural_sky(256, 128)), dev, "float32")
    assert call(legacy)[1] == {"fused": iterations}
    monkeypatch.setenv("RT_DISABLE_WFKERNELS", "1")
    (c_img, c_cnt, c_st), launched = call()
    assert launched == {"fused": iterations}
    assert int(c_st["iterations"]) == int(k_st["iterations"])
    assert float((c_cnt == k_cnt).double().mean()) >= PARITY_MIN
    k_mean, c_mean = ((img / cnt.unsqueeze(-1)).cpu().numpy() for img, cnt in ((k_img, k_cnt), (c_img, c_cnt)))
    assert np.sqrt(np.mean((c_mean - k_mean) ** 2)) / np.sqrt(np.mean(k_mean ** 2)) < GOLDEN_REL_RMSE_MAX


KNOB_SCENES = {"house": (False, 128, 8), "suzanne_hi": (False, 32, 2), "suzanne": (True, 64, 2)}


@pytest.mark.parametrize("name", sorted(KNOB_SCENES))
def test_disable_pallas_is_refused_on_the_card(dev, monkeypatch, name):
    """RT_DISABLE_PALLAS=1 on the small, chunked and BVH routes: the card
    refuses (RuntimeError pointing at device='cpu') and launches nothing;
    the scene's tables copied to the CPU render there through the plain
    versions, launching nothing, the card's kernel route's image by the
    flip-aware criteria."""
    with_bvh, size, budget = KNOB_SCENES[name]
    scene = _scene(name)
    ds, env = build_device_scene(scene, dev, with_bvh=with_bvh), _sky(dev)
    monkeypatch.delenv("RT_DISABLE_PALLAS", raising=False)
    ref = _freerun_image(ds, env, camera_pytree(scene.camera, dev), size, budget)
    monkeypatch.setenv("RT_DISABLE_PALLAS", "1")
    before = {**ci.LAUNCHES, **cw.LAUNCHES}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _freerun_image(ds, env, camera_pytree(scene.camera, dev), size, budget)
    got = _freerun_image(ds.to("cpu"), env.to("cpu"), camera_pytree(scene.camera, "cpu"), size, budget)
    assert {**ci.LAUNCHES, **cw.LAUNCHES} == before
    _same_image(got, ref)


@pytest.mark.parametrize("name", sorted(KNOB_SCENES))
def test_debug_nans_clean_renders_on_the_card(dev, monkeypatch, name):
    """RT_DEBUG_NANS=1: a clean 256x256 free-run render on each route
    raises nothing."""
    with_bvh, _, budget = KNOB_SCENES[name]
    scene = _scene(name)
    monkeypatch.setenv("RT_DEBUG_NANS", "1")
    img, counts = _freerun_image(build_device_scene(scene, dev, with_bvh=with_bvh), _sky(dev),
                                 camera_pytree(scene.camera, dev), 256, budget)
    assert np.isfinite(img).all() and counts.min() > 0


def test_debug_nans_names_a_nan_from_closest(house_state, monkeypatch):
    """RT_DEBUG_NANS=1: a NaN ray origin in lane 7 of a house loop state
    makes CLOSEST's outputs NaN, and its wrapper raises
    FloatingPointError naming them after the one launch."""
    scene, _, carry = house_state["trace"]
    ro = [carry[f"ro{i}"].clone() for i in range(3)]
    ro[0][7] = float("nan")
    monkeypatch.setenv("RT_DEBUG_NANS", "1")
    before = ci.LAUNCHES["closest"]
    with pytest.raises(FloatingPointError, match="CLOSEST output"):
        ci.closest_call(scene, tuple(ro), tuple(carry[f"rd{i}"] for i in range(3)))
    assert ci.LAUNCHES["closest"] == before + 1


def test_block_major_lanes_are_row_major_lanes_on_the_card(house_args, monkeypatch):
    """house at 256x256 (four 64x128 blocks), 16 iterations: block-major
    lanes (the default) and RT_DISABLE_BLOCK_REMAP=1's row-major lanes give
    the same image, counts and stats bit for bit."""
    monkeypatch.delenv("RT_DISABLE_BLOCK_REMAP", raising=False)
    block = render_freerun(*house_args, 0, (256, 256), 16, 8, with_stats=True)
    monkeypatch.setenv("RT_DISABLE_BLOCK_REMAP", "1")
    _same_render(render_freerun(*house_args, 0, (256, 256), 16, 8, with_stats=True), block)


@pytest.fixture(scope="module")
def suzanne_hi_args(dev):
    """suzanne_hi (242 chunks, the chunked route) in the default chunk
    order, the sky and the camera."""
    scene = _scene("suzanne_hi")
    ds = _ordered_scene(scene, dev, "morton")
    assert route(ds) == CHUNKED and wf.reference_cadence(ds) == 2
    return ds, _sky(dev), camera_pytree(scene.camera, dev)


@pytest.fixture(scope="module")
def uncompacted(suzanne_hi_args):
    return render_freerun(*suzanne_hi_args, 0, (256, 256), 16, 8, with_stats=True, compact_every=0)


COMPACTIONS = {"K2": (2, None), "K4": (4, None), **{f"K1_{k}": (1, k) for k in wf.COMPACT_KEYS}}


@pytest.mark.parametrize("setting", sorted(COMPACTIONS))
def test_compacting_calls_are_uncompacted_calls_on_the_card(suzanne_hi_args, uncompacted, monkeypatch, setting):
    """suzanne_hi at 256x256, 16 iterations: compacting every 2 (the
    reference's cadence) or 4 iterations, and every iteration under each
    RT_COMPACT_KEY, permutes the lanes and gives K = 0's image, counts and
    stats bit for bit."""
    every, key = COMPACTIONS[setting]
    for knob in ("RT_COMPACT_EVERY", "RT_COMPACT_KEY", "RT_COMPACT_MORTON_BITS"):
        monkeypatch.delenv(knob, raising=False)
    if key:
        monkeypatch.setenv("RT_COMPACT_KEY", key)
    permuted, permute = [], Wavefront.permute

    def counted(self):
        permuted.append(1)
        return permute(self)

    monkeypatch.setattr(Wavefront, "permute", counted)
    got = render_freerun(*suzanne_hi_args, 0, (256, 256), 16, 8, with_stats=True, compact_every=every)
    assert permuted
    _same_render(got, uncompacted)


@pytest.fixture(scope="module")
def morton_image(suzanne_hi_args):
    return _freerun_image(*suzanne_hi_args, 256, 32)


@pytest.mark.parametrize("order", sorted(ORDER_KNOBS))
def test_chunk_orders_render_mortons_image(dev, suzanne_hi_args, morton_image, order):
    """suzanne_hi stored in the bvh, treelet or host order renders the
    default (Morton) order's 256x256 free-run image by the flip-aware
    criteria: a tie between triangles in two chunks may resolve apart."""
    ds = _ordered_scene(_scene("suzanne_hi"), dev, order)
    assert route(ds) == CHUNKED
    _same_image(_freerun_image(ds, *suzanne_hi_args[1:], 256, 32), morton_image)


def test_bvh_route_renders_the_chunked_routes_image(dev, suzanne_hi_args):
    """suzanne_hi at 256x256, 4 spp, through the BVH route and the chunked
    route: the leaf tests round apart, so a few paths flip."""
    ds, env, cam = suzanne_hi_args
    bvh = build_device_scene(_scene("suzanne_hi"), dev, with_bvh=True)
    assert route(bvh) == BVH
    via_bvh, via_chunks = (render_wavefront(s, env, cam, 0, (256, 256), 4, 8).cpu().numpy() / 4 for s in (bvh, ds))
    flipped, rel = _flip_criteria(via_bvh, via_chunks)
    assert flipped < FLIPPED_MAX and rel < UNFLIPPED_REL_RMSE_MAX, (flipped, rel)


@pytest.mark.parametrize("name,intersector", [("house", "sweep"), ("suzanne", "bvh"), ("spheres", "bvh")])
def test_auto_route_on_the_card(dev, name, intersector):
    """A Renderer with the default intersector on the card keeps house (8
    + 56 sphere and triangle lanes) on the small route and walks the BVH
    past CUDA_BVH_ABOVE_LANES (suzanne, spheres)."""
    envs = EnvironmentMaps([Environment.from_texture("s", procedural_sky(64, 32))])
    assert Renderer(_scene(name), 16, 16, environments=envs, device=dev).intersector == intersector


@pytest.mark.parametrize("name", ["house_tiled16", "house_tiled64"])
def test_small_route_past_the_unroll_budget(dev, name):
    """house_tiled16 (328 padded lanes, its table staged in a block's
    shared memory) and house_tiled64 (a table past it, read from global
    memory) under with_bvh=False: the small route; TRACE, SHADE, CLOSEST,
    ANY and FUSED on a 128x128 loop state at the gates, CLOSEST and ANY on
    the scan integrator's states bit for bit; the 256x256 image is the BVH
    route's by the flip-aware criteria ('auto' walks house_tiled64's)."""
    scene = _scene(name)
    ds = build_device_scene(scene, dev)
    table = ds.trace_table.numel() * 4
    assert route(ds) == SMALL
    if name == "house_tiled16":
        assert ds.num_lanes == 328 and table <= SWEEP_MAX_SHARED
    else:
        rows = (ds.sph_radius.shape[0], ds.pln_valid.shape[0], ds.tri_valid.shape[0])
        assert table > SWEEP_MAX_SHARED and auto_bvh(*rows, dev, ds.mat_roughness.shape[0])
    state = _loop_state(ds, scene, dev)
    _compare_trace(state["trace"])
    _compare_shade(cw.shade_call, cw.shade_plain, state["shade"])
    for kfn, pfn, ints in sweep_calls(state["trace"])[0].values():
        _compare(kfn(), pfn(), ints)
    _scan_states_bitwise(ds, scene, dev)
    bvh = build_device_scene(scene, dev, with_bvh="auto" if name == "house_tiled64" else True)
    assert route(bvh) == BVH
    env, cam = _sky(dev), camera_pytree(scene.camera, dev)
    _same_image(_freerun_image(ds, env, cam, 256, 8), _freerun_image(bvh, env, cam, 256, 8))


def test_big_mesh_kernels_on_a_spheres_loop_state(dev):
    """spheres (1,000 spheres in sphere windows) at 128x128: ENV_DRAW's
    draw bitwise, CHUNKED_CLOSEST and CHUNKED_ANY bitwise on every lane,
    BIG_SHADE at the gates."""
    scene = _scene("spheres")
    ds = build_device_scene(scene, dev)
    assert route(ds) == CHUNKED and ds.chunks.n_sph_chunks > 0
    state = _loop_state(ds, scene, dev)
    _compare_env_draw(state["env_draw"])
    args = state["closest"]
    for a, b in zip(ci.chunked_closest_call(*args), intersect.chunked_closest_plain(*args)):
        assert int(_bits_differ(a, b).sum()) == 0
    args = state["occlusion"]
    assert torch.equal(ci.chunked_occlusion_call(*args), ci.chunked_occlusion_plain(*args))
    _compare_shade(cw.big_shade_call, cw.big_shade_plain, state["big_shade"])


def test_sync_rounds_on_the_chunked_route(dev):
    """render_spp_sync on suzanne (the chunked route) at 64x64, 2 rounds of
    8 bounces: each big-mesh kernel once an iteration of every round, no
    other kernel, 2 samples on every pixel."""
    scene = _scene("suzanne")
    ds = build_device_scene(scene, dev)
    (img, counts), launched = _launched_by(
        lambda: render_spp_sync(ds, _sky(dev), camera_pytree(scene.camera, dev), 0, (64, 64), 2, 8))
    assert launched == dict.fromkeys(ROUTE_LAUNCHES[CHUNKED], 2 * 8)
    assert bool((counts == 2).all()) and bool(torch.isfinite(img).all())


def test_dryrun_on_slots_of_the_card(dev):
    """parallel.sharding.dryrun over four slots of the card (a 2x2 mesh)."""
    from rsoderh_raytracing_tpu_torch.parallel.sharding import dryrun

    dryrun(4, device=dev)


def test_viewer_frame_rate_tool_on_the_card(dev):
    """viewer.fps on house at 64x36, 4 frames a scenario: both records
    name the card's platform and a rate above 0."""
    from rsoderh_raytracing_tpu_torch.viewer import fps

    records, _ = fps.measure("house", 64, 36, 4, device=dev)
    assert [r["metric"] for r in records] == ["viewer_fps_converge", "viewer_fps_moving"]
    assert all(r["platform"] == "gpu" and r["value"] > 0 for r in records)
