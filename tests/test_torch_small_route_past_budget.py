"""The small route past the 192-lane unroll budget: scenes past Mosaic's
budget that the chunked route does not take, where the reference sweeps
densely in XLA, render through the packed table of any size (staged in a
block's shared memory, or read from global memory past it), against the
JAX package's sweep, the BVH route and RT_DISABLE_PALLAS's composed body.

The scenes are profiling.tiled_house(16) (house with a 16 x 16
checkerboard of ground planes: 8 + 256 + 64 padded lanes, a packed table
of 26,112 bytes, which the sweep kernels stage in shared memory),
tiled_house(64) (4,096 planes, a table of 271,872 bytes, past a block's
shared memory: the kernels read it from global memory, and 'auto' walks
the BVH on the card) and the 200-plane scene of test_torch_scene.py.

closest_hit and any_hit are held to the JAX package's on the CPU, where
the reference runs its XLA sweep (_sweep_xla, no Pallas), on 256 seeded
rays from the camera, by the plain-vs-Pallas bounds of ROADMAP: integer
outputs equal on >= 99.9% of lanes, floats isclose(1e-4, 1e-5) on
>= 99.5%. Measured here: every output on 100% of the lanes of both
scenes.
"""

import types
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu.accel import bvh as j_bvh
from rsoderh_raytracing_tpu.ops import bvh_traverse as j_walk
from rsoderh_raytracing_tpu.ops import intersect as j_intersect
from rsoderh_raytracing_tpu.scene import device as j_device
from rsoderh_raytracing_tpu_torch import _device
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.profiling import tiled_house
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import kernel_loop_enabled, render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import (
    BVH, SMALL, SWEEP_MAX_SHARED, auto_bvh, build_device_scene, route, sweep_shared_bytes,
)
from rsoderh_raytracing_tpu_torch.scene.types import Plane
from test_torch_sweep import seeded_rays

torch.set_num_threads(2)

INT_EQUAL_MIN = 0.999
FLOAT_CLOSE_MIN = 0.995
RTOL, ATOL = 1e-4, 1e-5
# The anchors' flip-aware image criteria (tests/test_reference_estimator.py).
FLIP_ABS, FLIPPED_MAX, UNFLIPPED_REL_RMSE_MAX = 1e-2, 0.03, 0.005
SIZE, BUDGET, BOUNCES = 16, 8, 4


def planes_200():
    """house with its ground planes replaced by 200 planes in a row (past
    the unroll budget; planes never chunk)."""
    scene = tiled_house(1)
    scene.planes = [Plane(pos=(float(i), -1.0, -4.0), right=(0.5, 0.0, 0.0),
                          forward=(0.0, 0.0, 0.5), material_id=0) for i in range(200)]
    return scene


SCENES = {"house_tiled16": lambda: tiled_house(16), "house_tiled64": lambda: tiled_house(64),
          "planes_200": planes_200}
# The route of each scene on the CPU under each intersector.
ROUTES = {
    "house_tiled16": {"sweep": SMALL, "auto": SMALL, "bvh": BVH},
    "house_tiled64": {"sweep": SMALL, "auto": SMALL, "bvh": BVH},
    "planes_200": {"sweep": SMALL, "auto": SMALL, "bvh": BVH},
}
WITH_BVH = {"sweep": False, "auto": "auto", "bvh": True}


@pytest.fixture(scope="module")
def scenes():
    return {name: make() for name, make in SCENES.items()}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for knob in ("RT_DISABLE_PALLAS", "RT_DEBUG_NANS", "RT_BVH_ABOVE_TRIS", "RT_DISABLE_WFKERNELS"):
        monkeypatch.delenv(knob, raising=False)


def _counts(ds):
    return (ds.sph_radius.shape[0], ds.pln_valid.shape[0], ds.tri_valid.shape[0],
            ds.mat_roughness.shape[0])


@pytest.mark.parametrize("intersector", ["sweep", "auto", "bvh"])
@pytest.mark.parametrize("name", list(SCENES))
def test_route_by_intersector(scenes, name, intersector):
    ds = build_device_scene(scenes[name], "cpu", with_bvh=WITH_BVH[intersector])
    assert route(ds) == ROUTES[name][intersector]
    if route(ds) == SMALL:
        assert ds.trace_table.numel() * 4 == sweep_shared_bytes(*_counts(ds)) and ds.chunks is None


def test_tiled_scenes_lanes(scenes):
    """house_tiled16: 8 + 256 + 64 lanes (triangles pad to a chunk past the
    budget, as the reference pads them), 26,112 bytes; house_tiled64 past
    a block's shared memory."""
    small = build_device_scene(scenes["house_tiled16"], "cpu")
    assert _counts(small)[:3] == (8, 256, 64) and small.num_lanes == 328
    assert sweep_shared_bytes(*_counts(small)) == 26112
    big = build_device_scene(scenes["house_tiled64"], "cpu")
    assert _counts(big)[:3] == (8, 4096, 64)
    assert sweep_shared_bytes(*_counts(big)) == 271872 > SWEEP_MAX_SHARED
    # the small table's kinds: CLOSEST and ANY sweep the valid rows
    assert small.sweep_rows == (2, 256, 52)


@pytest.mark.parametrize("name", list(SCENES))
def test_card_auto_takes_the_bvh_only_past_a_blocks_shared_memory(scenes, name):
    """On the card 'auto' walks the BVH exactly where the small route's
    table would not fit a block's shared memory (house_tiled64)."""
    ds = build_device_scene(scenes[name], "cpu")
    past = sweep_shared_bytes(*_counts(ds)) > SWEEP_MAX_SHARED
    assert auto_bvh(*_counts(ds)[:3], torch.device("cuda"), _counts(ds)[3]) == past
    assert past == (name == "house_tiled64")


@pytest.mark.parametrize("name", list(SCENES))
def test_cpu_auto_is_the_references_decision(scenes, name, monkeypatch):
    """The CPU 'auto' attaches a BVH exactly where the reference's does
    (its builder stubbed: only its decision is read)."""
    monkeypatch.setattr(j_bvh, "build_bvh", lambda s: "tree")
    monkeypatch.setattr(j_walk, "device_bvh", lambda tree: tree)
    ref_bvh = j_device.build_device_scene(scenes[name], with_bvh="auto").bvh is not None
    assert (route(build_device_scene(scenes[name], "cpu", with_bvh="auto")) == BVH) == ref_bvh


@pytest.fixture(scope="module")
def query_pairs(scenes):
    """closest_hit and any_hit of both packages on 256 seeded camera rays,
    by scene: (reference outputs, port outputs, lanes both hit)."""
    out = {}
    for name in ("house_tiled16", "house_tiled64"):
        scene = scenes[name]
        jscene = j_device.build_device_scene(scene)
        ds = build_device_scene(scene, "cpu")
        ro, rd, nd = seeded_rays(5, n=256, spread=0.5, origin=scene.camera.pos)
        rd = rd.copy()
        rd[1] = -np.abs(rd[1])  # toward the ground
        rd /= np.linalg.norm(rd, axis=0)
        jro, jrd, jnd = (jnp.asarray(x.T) for x in (ro, rd, nd))
        jhit = j_intersect.closest_hit(jscene, jro, jrd)
        jocc = j_intersect.any_hit(jscene, jhit.point, jnd)
        comps = [tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in x) for x in (ro, rd, nd)]
        hit = intersect.closest_hit(ds, comps[0], comps[1])
        point = tuple(torch.from_numpy(np.ascontiguousarray(np.asarray(jhit.point)[:, k]))
                      for k in range(3))
        occ = intersect.any_hit(ds, point, comps[2])
        ref = dict(did_hit=jhit.did_hit, distance=jhit.distance, point=jhit.point,
                   normal=jhit.normal, material_id=jhit.material_id, any_hit=jocc)
        got = dict(did_hit=hit.did_hit, distance=hit.distance, point=torch.stack(hit.point, -1),
                   normal=torch.stack(hit.normal, -1), material_id=hit.material_id, any_hit=occ)
        both = np.asarray(jhit.did_hit) & hit.did_hit.numpy()
        out[name] = ({k: np.asarray(v) for k, v in ref.items()},
                     {k: v.numpy() for k, v in got.items()}, both)
    return out


@pytest.mark.parametrize("field", ["did_hit", "distance", "point", "normal", "material_id", "any_hit"])
@pytest.mark.parametrize("name", ["house_tiled16", "house_tiled64"])
def test_queries_match_the_reference_sweep(query_pairs, name, field):
    ref, got, both = query_pairs[name]
    assert 0.3 < both.mean() < 1.0  # hits on the tiles and misses to the sky
    a, b = got[field], ref[field]
    if field in ("normal", "material_id"):
        a, b = a[both], b[both]
    if field in ("did_hit", "material_id", "any_hit"):
        share = (a.astype(np.int64) == b.astype(np.int64)).mean()
        assert share >= INT_EQUAL_MIN, f"{share:.5f}"
    else:
        share = np.isclose(a, b, rtol=RTOL, atol=ATOL).all(axis=-1).mean() if a.ndim > 1 else \
            np.isclose(a, b, rtol=RTOL, atol=ATOL).mean()
        assert share >= FLOAT_CLOSE_MIN, f"{share:.5f}"


def test_tiles_are_hit(query_pairs):
    """Both materials of the checkerboard are hit on each scene."""
    for name in ("house_tiled16", "house_tiled64"):
        _, got, both = query_pairs[name]
        assert {0, 3} <= set(np.unique(got["material_id"][both]).tolist())


def _freerun_mean(ds, scene, env):
    img, counts = render_freerun(ds, env, camera_pytree(scene.camera, "cpu"), 0, (SIZE, SIZE),
                                 BUDGET, BOUNCES)
    return (img / counts[..., None]).numpy(), counts.numpy()


@pytest.fixture(scope="module")
def sky():
    return device_environment(Environment.from_texture("s", procedural_sky(64, 32)), device="cpu")


@pytest.mark.parametrize("name", ["house_tiled16", "house_tiled64"])
def test_render_against_the_bvh_route(scenes, sky, name):
    """A 16x16 free-run render through the scene's sweep route (small)
    against the BVH route's, by the anchors' flip-aware criteria; the
    sample counts are equal."""
    scene = scenes[name]
    swept = build_device_scene(scene, "cpu")
    assert route(swept) == ROUTES[name]["sweep"]
    img, counts = _freerun_mean(swept, scene, sky)
    ref, ref_counts = _freerun_mean(build_device_scene(scene, "cpu", with_bvh=True), scene, sky)
    assert np.isfinite(img).all() and (counts == ref_counts).all()
    diff = img - ref
    flipped = np.abs(diff).max(-1) > FLIP_ABS
    rel = np.sqrt((diff[~flipped] ** 2).mean()) / np.sqrt((ref[~flipped] ** 2).mean())
    assert flipped.mean() < FLIPPED_MAX and rel < UNFLIPPED_REL_RMSE_MAX, (flipped.mean(), rel)


def test_big_table_renders_as_sweep_without_a_warning(scenes, monkeypatch):
    """Renderer(intersector='sweep') on house_tiled64: the small route,
    reported as 'sweep' as the reference reports it, and no warning: no
    plain version stands in for a kernel; the scan integrator's sample is
    finite."""
    monkeypatch.setattr(_device, "_warned", set())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = Renderer(scenes["house_tiled64"], 12, 8, max_bounces=3, intersector="sweep", device="cpu")
        assert route(r.device_scene) == SMALL and r.intersector == "sweep"
        r.step()
        r.step()
    assert np.isfinite(r.film.mean_radiance()).all()


def test_small_queries_answer_only_masked_lanes(scenes):
    """CLOSEST and ANY over house_tiled64's table answer the lanes of their
    mask: each of those equals the full sweep's answer, every other lane
    is a miss."""
    ds = build_device_scene(scenes["house_tiled64"], "cpu")
    ro, rd, _ = seeded_rays(7, n=200, spread=0.5, origin=scenes["house_tiled64"].camera.pos)
    rd[1] = -np.abs(rd[1])
    ro, rd = (tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in x) for x in (ro, rd))
    mask = torch.from_numpy((np.arange(200) % 3 != 0).astype(np.int32))
    rec = ci.closest_call(ds, ro, rd, mask)
    t, ptype, pidx = rec["t"], rec["type"], rec["index"]
    full = intersect.closest_sweep(ds, *ro, *rd)
    on = mask != 0
    for got, ref in zip((t, ptype, pidx), full):
        assert torch.equal(got[on], ref[on])
    assert (t[~on] == intersect.INF).all() and (ptype[~on] == -1).all() and (pidx[~on] == 0).all()
    occ = ci.any_call(ds, ro, rd, mask)
    assert torch.equal(occ[on], intersect.any_sweep(ds, *ro, *rd)[on]) and not occ[~on].any()


def test_disable_pallas_takes_the_composed_body_on_the_cpu(scenes, sky, monkeypatch, assets_dir):
    """RT_DISABLE_PALLAS=1, read at call time, on the CPU: the wavefront
    takes its composed body, the routes stay, no kernel launches, and the
    knob warns once. house renders bitwise the kernel loop's image (both
    plain on the CPU); unset again, the kernel loop serves."""
    import os

    from rsoderh_raytracing_tpu_torch import load_scene

    house = load_scene(os.path.join(assets_dir, "scenes", "house.toml"))
    small = build_device_scene(house, "cpu")
    ref, ref_counts = _freerun_mean(small, house, sky)
    monkeypatch.setattr(_device, "_warned", set())
    monkeypatch.setenv("RT_DISABLE_PALLAS", "1")
    with pytest.warns(RuntimeWarning, match="RT_DISABLE_PALLAS=1: no hand-written kernel"):
        assert _device.kernels_disabled()
    assert not kernel_loop_enabled(sky)
    assert _device.use_plain(small.sph_pos, "test")
    assert route(build_device_scene(house, "cpu")) == SMALL
    assert route(build_device_scene(scenes["house_tiled16"], "cpu")) == SMALL
    assert route(build_device_scene(scenes["house_tiled16"], "cpu", with_bvh=True)) == BVH
    cw.reset_launches()
    ci.reset_launches()
    img, counts = _freerun_mean(small, house, sky)
    assert set(cw.LAUNCHES.values()) == set(ci.LAUNCHES.values()) == {0}
    assert (counts == ref_counts).all() and np.array_equal(img, ref)
    monkeypatch.delenv("RT_DISABLE_PALLAS")
    assert not _device.kernels_disabled() and kernel_loop_enabled(sky)


def test_disable_pallas_is_refused_on_the_card(monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel: under
    RT_DISABLE_PALLAS=1 it raises instead of running its plain version
    there, naming the knob and device='cpu'; unset, it launches."""
    card = types.SimpleNamespace(device=torch.device("cuda"))
    monkeypatch.setattr(_device, "_warned", set())
    monkeypatch.setenv("RT_DISABLE_PALLAS", "1")
    with pytest.warns(RuntimeWarning), pytest.raises(RuntimeError, match="device='cpu'"):
        _device.use_plain(card, "closest_call")
    monkeypatch.delenv("RT_DISABLE_PALLAS")
    assert not _device.use_plain(card, "closest_call")
    with pytest.raises(ValueError, match="unsupported device"):
        _device.use_plain(types.SimpleNamespace(device=torch.device("meta")), "closest_call")
