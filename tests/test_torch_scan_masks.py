"""The scan integrator's masked queries: CLOSEST with its hit record and
ANY under a lane mask, their plain versions against the Pallas kernels,
and the repaired reference API (compact_every, the parity report's
output names).

The Pallas kernels (pallas_intersect.closest_sweep, any_sweep) run in
interpret mode on the CPU (RT_PALLAS_INTERPRET=1) on test_torch_trace.py's
tiny scene (pad_to=1) over one 64x128 tile of seeded rays and seeded
lane masks; the same scene padded to 8 lanes a kind checks the valid
rows CLOSEST and ANY sweep.
Tolerances as in test_torch_sweep.py on the lanes a mask keeps (torch
and XLA round sqrt differently and XLA contracts multiply-adds): integer
outputs equal on >= 99.9% of them, t isclose(1e-4, 1e-5) on >= 99.5%.
Every other lane must hold the fixed record exactly. Inside the port the
checks are bitwise: the plain record against _hit_attributes and
material_values, and render_sample with the masks against render_sample
without them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu.ops import pallas_intersect as pint
from rsoderh_raytracing_tpu.render import renderer as j_renderer
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import EnvironmentMaps as JEnvironmentMaps
from rsoderh_raytracing_tpu.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.env.environment import Environment, EnvironmentMaps, device_environment
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.profiling import capture_scan, scan_bounds, scene_gathers
from rsoderh_raytracing_tpu_torch.render import integrator
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene
from test_torch_sweep import CLOSEST_NAMES, N, agree, comps, seeded_rays
from test_torch_trace import port_scene, tiny_scene

torch.set_num_threads(2)

INT_EQUAL_MIN = 0.999
FLOAT_CLOSE_MIN = 0.995
DEAD = {"t": np.float32(3.0e38), "type": -1}
MASKS = ("all", "half", "sparse", "none_set")


def seeded_mask(name, seed=0, n=N):
    g = np.random.default_rng(seed)
    share = {"all": 1.0, "half": 0.5, "sparse": 0.03, "none_set": 0.0}[name]
    return (g.uniform(size=n) < share).astype(np.int32)


@pytest.fixture(scope="module")
def padded_pair():
    """(port scene, rays) of the tiny scene, and the Pallas closest and
    occlusion sweeps of the rays (the occlusion rays start at the closest
    hits' points)."""
    jscene = j_build(tiny_scene(), pad_to=1)
    scene = port_scene(jscene)
    ro, rd, nd = seeded_rays(4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RT_PALLAS_INTERPRET", "1")
        j_closest = [np.asarray(x) for x in pint.closest_sweep(jscene, jnp.asarray(ro.T), jnp.asarray(rd.T))]
        t_safe = np.where(j_closest[1] >= 0, j_closest[0], 0.0).astype(np.float32)
        p = (ro + rd * t_safe[None, :]).astype(np.float32)
        j_any = np.asarray(pint.any_sweep(jscene, jnp.asarray(p.T), jnp.asarray(nd.T)))
    return scene, (ro, rd, nd, p), dict(zip(CLOSEST_NAMES, j_closest)), j_any


def test_padded_scene_sweeps_only_valid_rows(house_scene):
    scene = port_scene(j_build(tiny_scene()))
    assert scene.sph_valid.shape[0] == scene.pln_valid.shape[0] == scene.tri_valid.shape[0] == 8
    assert scene.sweep_rows == (1, 1, 1)
    house = build_device_scene(house_scene, device="cpu")
    assert (house.sph_valid.shape[0], house.pln_valid.shape[0], house.tri_valid.shape[0]) == (8, 8, 56)
    assert house.sweep_rows == (2, 2, 52)


@pytest.mark.parametrize("mask_name", MASKS)
def test_masked_closest_plain_matches_pallas(padded_pair, mask_name):
    """On live lanes the plain CLOSEST record's winner is Pallas's; every
    dead lane holds (3e38, -1, 0) and zero attributes."""
    scene, (ro, rd, _, _), ref, _ = padded_pair
    live = seeded_mask(mask_name, 1)
    got = {k: v.numpy() for k, v in ci.closest_call(scene, comps(ro), comps(rd), torch.from_numpy(live)).items()}
    assert tuple(got) == ci.CLOSEST_OUT_NAMES
    on = live != 0
    if on.any():
        for name in CLOSEST_NAMES:
            share = agree(got[name][on], ref[name][on], name != "t")
            assert share >= (INT_EQUAL_MIN if name != "t" else FLOAT_CLOSE_MIN), (name, share)
        assert set(np.unique(got["type"][on])) == {-1, 0, 1, 2}
    for name, values in got.items():
        assert (values[~on] == DEAD.get(name, 0)).all(), name


@pytest.mark.parametrize("mask_name", MASKS)
def test_masked_any_plain_matches_pallas(padded_pair, mask_name):
    scene, (_, _, nd, p), _, ref = padded_pair
    mask = seeded_mask(mask_name, 2)
    got = ci.any_call(scene, comps(p), comps(nd), torch.from_numpy(mask)).numpy()
    on = mask != 0
    assert got.dtype == np.bool_
    assert not got[~on].any()
    if on.any():
        assert agree(got[on], ref[on], True) >= INT_EQUAL_MIN
        assert got[on].any() and not got[on].all()


def test_plain_record_is_hit_attributes_and_materials(padded_pair, house_scene):
    """closest_record = closest_sweep + _hit_attributes + material_values,
    bit for bit on the live lanes, on the tiny scene and on house."""
    for scene, seed in ((port_scene(j_build(tiny_scene())), 5),
                        (build_device_scene(house_scene, device="cpu"), 6)):
        ro, rd, _ = seeded_rays(seed, n=4096, spread=1.0, origin=(0.0, 1.0, 4.0))
        ro, rd = comps(ro), comps(rd)
        live = torch.from_numpy(seeded_mask("half", seed, 4096))
        rec = intersect.closest_record(scene, ro, rd, live)
        t, ptype, pidx = intersect.closest_sweep(scene, *ro, *rd)
        hit = intersect._hit_attributes(scene, ro, rd, t, ptype, pidx)
        ref = dict(zip(CLOSEST_NAMES, (t, ptype, pidx)))
        ref.update(px=hit.point[0], py=hit.point[1], pz=hit.point[2], nx=hit.normal[0],
                   ny=hit.normal[1], nz=hit.normal[2], material_id=hit.material_id)
        ref.update(zip(intersect.MATERIAL_NAMES, intersect.material_values(scene, hit.material_id)))
        on = live != 0
        assert set(rec) == set(ref)
        for k in ref:
            assert torch.equal(rec[k][on], ref[k][on]), k
        assert (ptype[on] >= 0).any() and (ptype[on] < 0).any()


@pytest.fixture(scope="module")
def house_cpu(house_scene):
    env = device_environment(Environment.from_texture("s", procedural_sky(64, 32)), device="cpu")
    return (build_device_scene(house_scene, device="cpu"), env,
            integrator.camera_pytree(house_scene.camera, device="cpu"))


def test_render_sample_with_masks_is_bitwise_without(house_cpu, monkeypatch):
    """The scan integrator passes its alive and alive-and-hit masks to the
    two queries; every use of their answers is masked by the same lanes, so
    the image equals, bit for bit, one traced with every lane live."""
    masked = integrator.render_sample(*house_cpu, 3, (16, 16), 8).numpy()
    closest, occlusion = intersect.closest_hit, intersect.any_hit
    monkeypatch.setattr(intersect, "closest_hit", lambda s, ro, rd, live=None: closest(s, ro, rd))
    monkeypatch.setattr(intersect, "any_hit", lambda s, ro, rd, mask=None: occlusion(s, ro, rd))
    unmasked = integrator.render_sample(*house_cpu, 3, (16, 16), 8).numpy()
    assert masked.view(np.uint32).tobytes() == unmasked.view(np.uint32).tobytes()
    assert masked.mean() > 0


def test_scan_capture_counts_and_bounds(house_cpu):
    """capture_scan records the integrator's masks; the live lanes shrink
    by bounce 3; scan_bounds counts the valid-row sweep; on the CPU the
    plain record gathers 16 scene rows a bounce, as the parent's glue did."""
    scene, env, cam = house_cpu
    states = capture_scan(scene, env, cam, 16, 8)
    live0, live3 = (int(states[b]["closest"][2].sum()) for b in (0, 3))
    mask0 = int(states[0]["any"][2].sum())
    assert live0 == 256 and 0 < live3 < live0 and 0 < mask0 < live0
    (c_ms, c_by), (a_ms, _), n_live, n_mask = scan_bounds(scene, states[0])
    assert (n_live, n_mask, c_by) == (256, mask0, "operations")
    assert c_ms == pytest.approx(256 * 2586 / 67e12 * 1e3)
    assert 0 < a_ms < c_ms
    gathers = scene_gathers(scene, lambda: integrator.render_sample(scene, env, cam, 0, (8, 8), 4))
    assert gathers == 16 * 4


def test_compact_every_is_accepted_and_changes_nothing(house_scene):
    """Both packages take compact_every in render_freerun and
    Renderer.step_freerun; in the port it has no effect, bit for bit."""
    sky = procedural_sky(64, 32)
    j = j_renderer.Renderer(house_scene, 16, 12, environments=JEnvironmentMaps([JEnvironment.from_texture("s", sky)]),
                            max_bounces=3)
    assert j.step_freerun(8, compact_every=2) >= 0
    images = []
    for kwargs in ({}, {"compact_every": 2}, {"compact_every": None}):
        r = Renderer(house_scene, 16, 12, environments=EnvironmentMaps([Environment.from_texture("s", sky)]),
                     max_bounces=3, device="cpu")
        r.step_freerun(8, **kwargs)
        images.append((r.film.mean_radiance(), r.film.counts.numpy()))
    for img, counts in images[1:]:
        assert img.view(np.uint32).tobytes() == images[0][0].view(np.uint32).tobytes()
        assert np.array_equal(counts, images[0][1])
    env = device_environment(Environment.from_texture("s", sky), device="cpu")
    scene = build_device_scene(house_scene, device="cpu")
    cam = integrator.camera_pytree(house_scene.camera, device="cpu")
    a = render_freerun(scene, env, cam, 0, (8, 8), 6, 3, compact_every=1)
    b = render_freerun(scene, env, cam, 0, (8, 8), 6, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_parity_names_the_outputs_of_the_largest_differences():
    got = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor([1e6, 5.0]), "k": torch.tensor([1, 2])}
    ref = {"a": torch.tensor([1.0, 1.5]), "b": torch.tensor([1e6 + 2.0, 5.0]), "k": torch.tensor([1, 3])}
    shares, worst_abs, worst_rel = cw.parity(got, ref, {"k"}, 1e-4, 1e-5)
    assert shares == {"a": 0.5, "b": 1.0, "k": 0.5}
    assert worst_abs == (2.0, "b")
    assert worst_rel[1] == "a" and worst_rel[0] == pytest.approx(0.5 / 1.5)
