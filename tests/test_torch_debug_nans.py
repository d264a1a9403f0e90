"""RT_DEBUG_NANS=1 on the port: the reference raises FloatingPointError
where an op makes a NaN (jax_debug_nans, tests/test_debug_nans.py); the
card cannot check every op, so the port checks every wrapper's float
outputs and the wavefront carry once an iteration, whichever ran (kernel
or plain twin). Here on the CPU each check is
reached through a plain twin that is patched to put one NaN in one
output: with the knob set it raises, naming the op and the output; unset,
the NaN passes through unchecked. Clean renders under the knob, on every
route, raise nothing.
"""

import os

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu_torch import _device, load_scene
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.profiling import capture_step, tiled_house
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import NO_LIMIT, Wavefront, render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import BVH, CHUNKED, SMALL, build_device_scene, route

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
SIZE, BOUNCES = 8, 4


def _scene(name):
    return load_scene(os.path.join(ASSETS, "scenes", f"{name}.toml"))


@pytest.fixture(autouse=True)
def _knobs_unset(monkeypatch):
    for knob in ("RT_DEBUG_NANS", "RT_DISABLE_PALLAS", "RT_DISABLE_WFKERNELS"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def sky():
    return device_environment(Environment.from_texture("s", procedural_sky(32, 16)), device="cpu")


def _captured(ds, env, scene):
    """The wrappers' arguments at the second iteration of an 8x8 loop."""
    wave = Wavefront(ds, env, camera_pytree(scene.camera, "cpu"), 0, (SIZE, SIZE), NO_LIMIT, 16,
                     BOUNCES)
    wave.step(0)
    return capture_step(wave, 1)


@pytest.fixture(scope="module")
def states(sky):
    house, suzanne = _scene("house"), _scene("suzanne")
    small = build_device_scene(house, "cpu")
    big = build_device_scene(suzanne, "cpu")
    walk = build_device_scene(house, "cpu", with_bvh=True)
    tiled = build_device_scene(tiled_house(64), "cpu")
    assert (route(small), route(big), route(walk), route(tiled)) == (SMALL, CHUNKED, BVH, SMALL)
    out = {"small": _captured(small, sky, house), "chunked": _captured(big, sky, suzanne),
           "bvh": _captured(walk, sky, house), "scene": small, "tiled": tiled}
    scene, env, carry = out["small"]["trace"]
    out["rays"] = (tuple(carry[k] for k in ("ro0", "ro1", "ro2")),
                   tuple(carry[k] for k in ("rd0", "rd1", "rd2")))
    return out


def _with_nan(value, name):
    """`value` (a dict, a (dict, ...) tuple or a tuple of tensors) with a NaN
    written into lane 0 of its output `name` (a key, or a position)."""
    if isinstance(value, dict):
        value = dict(value)
        value[name] = value[name].clone()
        value[name][0] = float("nan")
        return value
    if isinstance(value[0], dict):
        return (_with_nan(value[0], name), *value[1:])
    out = list(value)
    out[name] = out[name].clone()
    out[name][0] = float("nan")
    return tuple(out)


def _call(states, case):
    """Run the wrapper of `case` on its state."""
    ro, rd = states["rays"]
    scene = states["scene"]
    calls = {
        "TRACE": lambda: cw.trace_call(*states["small"]["trace"]),
        "SHADE": lambda: cw.shade_call(*states["small"]["shade"]),
        "CLOSEST": lambda: ci.closest_call(scene, ro, rd),
        "FUSED": lambda: ci.fused_call(scene, ro, rd, rd),
        "CHUNKED_CLOSEST": lambda: ci.chunked_closest_call(*states["chunked"]["closest"]),
        "ENV_DRAW": lambda: cw.env_draw_call(*states["chunked"]["env_draw"]),
        "BIG_SHADE": lambda: cw.big_shade_call(*states["chunked"]["big_shade"]),
        "BVH_CLOSEST": lambda: ci.bvh_closest_call(*states["bvh"]["closest"]),
        "CLOSEST house_tiled64": lambda: ci.closest_call(states["tiled"], ro, rd),
    }
    return calls[case]()


# case (the op, and the scene where it is not house's): (module, plain twin
# patched, output holding the NaN, its name in the error)
INJECT = {
    "TRACE": (cw, "trace_plain", "ct", "ct"),
    "SHADE": (cw, "shade_plain", "tp0", "tp0"),
    "CLOSEST": (intersect, "closest_record", "px", "px"),
    "FUSED": (intersect, "trace_attrs", "nx", "nx"),
    "CHUNKED_CLOSEST": (intersect, "chunked_closest_plain", 0, "t"),
    "ENV_DRAW": (cw, "env_draw_plain", "nee_u", "nee_u"),
    "BIG_SHADE": (cw, "big_shade_plain", "film0", "film0"),
    "BVH_CLOSEST": (bvh_ops, "closest_plain", 0, "t"),
    "CLOSEST house_tiled64": (intersect, "closest_record", "t", "t"),
}


def _inject(monkeypatch, case):
    module, attr, where, _ = INJECT[case]
    plain = getattr(module, attr)
    monkeypatch.setattr(module, attr, lambda *a, **k: _with_nan(plain(*a, **k), where))


@pytest.mark.parametrize("case", list(INJECT))
def test_nan_in_an_output_raises_naming_it(states, monkeypatch, case):
    _inject(monkeypatch, case)
    monkeypatch.setenv("RT_DEBUG_NANS", "1")
    op = case.split()[0]
    with pytest.raises(FloatingPointError, match=f"{op} output '{INJECT[case][3]}'"):
        _call(states, case)


@pytest.mark.parametrize("case", list(INJECT))
def test_knob_unset_checks_nothing(states, monkeypatch, case):
    _inject(monkeypatch, case)
    out = _call(states, case)
    value = out[0] if isinstance(out, tuple) else out
    value = value[INJECT[case][3]] if isinstance(value, dict) else value
    assert bool(torch.isnan(value).any())


def test_nan_in_the_carry_raises_naming_the_iteration(sky, monkeypatch):
    """Wavefront.step checks the carry after each iteration: a shade that
    leaves a NaN in the incoming radiance raises, naming it."""
    house = _scene("house")
    wave = Wavefront(build_device_scene(house, "cpu"), sky, camera_pytree(house.camera, "cpu"), 0,
                     (SIZE, SIZE), NO_LIMIT, 16, BOUNCES)
    monkeypatch.setenv("RT_DEBUG_NANS", "1")
    with pytest.raises(FloatingPointError, match="wavefront iteration 0: carry output 'inc0'"):
        wave.step(0, shade=lambda *a: _with_nan(cw.shade_plain(*a), "inc0"))


@pytest.mark.parametrize("name,with_bvh,expected", [
    ("house", False, SMALL), ("house", True, BVH), ("suzanne", False, CHUNKED), ("house_tiled64", False, SMALL),
])
def test_clean_renders_raise_nothing(sky, monkeypatch, name, with_bvh, expected):
    """A 16x16 free-run render (8 x 8 for the big scenes) under the knob
    on each route raises nothing, and the knob warns once."""
    scene = tiled_house(64) if name == "house_tiled64" else _scene(name)
    ds = build_device_scene(scene, "cpu", with_bvh=with_bvh)
    assert route(ds) == expected
    monkeypatch.setattr(_device, "_warned", set())
    monkeypatch.setenv("RT_DEBUG_NANS", "1")
    size = 16 if name == "house" else 8
    with pytest.warns(RuntimeWarning, match="RT_DEBUG_NANS=1"):
        img, counts = render_freerun(ds, sky, camera_pytree(scene.camera, "cpu"), 0, (size, size), 4,
                                     BOUNCES)
    assert bool(torch.isfinite(img).all()) and int(counts.min()) > 0


def test_clean_scan_and_composed_paths_raise_nothing(sky, monkeypatch):
    """Under the knob the scan integrator (CLOSEST, ANY) and the composed
    body (FUSED) on house at 16x16 raise nothing either."""
    from rsoderh_raytracing_tpu_torch.env.environment import EnvironmentMaps

    monkeypatch.setenv("RT_DEBUG_NANS", "1")
    host = Environment.from_texture("s", procedural_sky(32, 16))
    r = Renderer(_scene("house"), 16, 16, environments=EnvironmentMaps([host]), max_bounces=BOUNCES,
                 device="cpu")
    r.step()
    monkeypatch.setenv("RT_DISABLE_WFKERNELS", "1")
    r.step_batch(2)
    assert r.film.sample_count == 3 and np.isfinite(r.film.mean_radiance()).all()
