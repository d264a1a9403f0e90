"""Bounce-synchronized rounds (render_spp_sync) and the seeding hook of
the port's wavefront (Wavefront's row0, rows, sample_stride,
sample_offset) on the CPU.

Against the JAX package: render_spp_sync at 24x16, 3 rounds, 6 bounces,
procedural_sky(128, 64), on house (small route) and on conftest's
200-triangle wall (big-mesh route; the port's scene built from the
reference's arrays, as tests/test_torch_wavefront.py does). The JAX side
runs its composed body on the CPU. The bounds are those of
tests/test_torch_wavefront.py: on house ray counts within 1e-3 relative,
image mean within 1e-3 relative, >= 99% of values isclose(1e-4, 1e-5);
on the wall 1e-2, 2e-3 and 98%; counts equal on >= 99% of pixels (both
sides complete exactly `rounds` samples everywhere). Measured here: ray
counts and iterations equal, counts equal everywhere, image means within
1.6e-7 (house) and 8.2e-8 (wall) relative, every value close on both
(46.5% and 44.5% of them bit-equal).

Within the port: render_spp_sync(rounds) is render_wavefront(spp=rounds)
bit for bit on the CPU (the bit-equal share measured 1.0 on both
scenes): both compute every camera ray with the same plain tensor code
(generate_camera_rays and SHADE's plain regeneration round alike here;
on an H100 the SHADE kernel's regenerated rays measured bitwise too,
which chip_smoke.py's sync phase holds to the anchors' flip-aware
criteria).
The hook with row0=0, every row, stride 1 and offset 0 is what
render_freerun runs (render_freerun's result is saved first, through the
public function); two row blocks of 192 lanes each give the whole image's
pixels bit for bit, and a strided sample map renders the global samples
it names.
"""

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import device_environment as j_device_environment
from rsoderh_raytracing_tpu.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu.render.integrator import camera_pytree as j_camera
from rsoderh_raytracing_tpu.render.wavefront import render_spp_sync as j_render_spp_sync
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.wavefront import (
    NO_LIMIT,
    Wavefront,
    render_freerun,
    render_spp_sync,
    render_wavefront,
)
from rsoderh_raytracing_tpu_torch.scene.device import (
    CHUNKED,
    FIELDS,
    SMALL,
    build_device_scene,
    device_scene_from_arrays,
    route,
)

torch.set_num_threads(2)

RES = (24, 16)
ROUNDS = 3
BOUNCES = 6
COUNTS_EQUAL_MIN = 0.99
# (ray counts rtol, image mean rtol, share of values close) by scene
BOUNDS = {"house": (1e-3, 1e-3, 0.99), "wall": (1e-2, 2e-3, 0.98)}


@pytest.fixture(scope="module")
def house_args(house_scene):
    sky = procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15)
    return (build_device_scene(house_scene, device="cpu"),
            device_environment(Environment.from_texture("s", sky), device="cpu"),
            camera_pytree(house_scene.camera, device="cpu"))


def _bits(t):
    return np.ascontiguousarray(np.asarray(t)).view(np.uint32)


@pytest.fixture(scope="module", params=["house", "wall"])
def runs(request, house_scene, big_tri_scene):
    """render_spp_sync on both sides, and the port's scene arguments."""
    scene = house_scene if request.param == "house" else big_tri_scene
    sky = procedural_sky(128, 64)
    js = j_build(scene)
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    assert route(ts) == (SMALL if request.param == "house" else CHUNKED)
    targs = (ts, device_environment(Environment.from_texture("s", sky), device="cpu"),
             camera_pytree(scene.camera, device="cpu"))
    ji, jc, jst = j_render_spp_sync(js, j_device_environment(JEnvironment.from_texture("s", sky)),
                                    j_camera(scene.camera), np.uint32(0), RES, np.uint32(ROUNDS),
                                    BOUNCES, with_stats=True)
    ti, tc, tst = render_spp_sync(*targs, 0, RES, ROUNDS, BOUNCES, with_stats=True)
    return dict(
        name=request.param, args=targs,
        jax=(np.asarray(ji), np.asarray(jc).astype(np.int64), {k: float(v) for k, v in jst.items()}),
        port=(ti.numpy(), tc.numpy(), {k: float(v) for k, v in tst.items()}),
    )


def test_sync_ray_counts_match_jax(runs):
    js, ts = runs["jax"][2], runs["port"][2]
    rtol = BOUNDS[runs["name"]][0]
    for key in ("closest_rays", "shadow_rays"):
        assert abs(ts[key] - js[key]) <= rtol * js[key], key
    assert ts["iterations"] == js["iterations"] <= ROUNDS * BOUNCES


def test_sync_counts_match_jax(runs):
    jc, tc = runs["jax"][1], runs["port"][1]
    assert tc.shape == jc.shape == RES[::-1]
    assert (tc == ROUNDS).all()
    assert (tc == jc).mean() >= COUNTS_EQUAL_MIN


def test_sync_image_matches_jax(runs):
    ji, ti = runs["jax"][0], runs["port"][0]
    _, mean_rtol, close_min = BOUNDS[runs["name"]]
    assert ti.shape == ji.shape == (*RES[::-1], 3)
    assert np.isfinite(ti).all()
    np.testing.assert_allclose(ti.mean(), ji.mean(), rtol=mean_rtol)
    assert np.isclose(ti, ji, rtol=1e-4, atol=1e-5).mean() >= close_min


def test_sync_equals_wavefront(runs):
    """The same samples in the same per-lane order: image, counts and ray
    counts bit for bit on the CPU (the iterations differ: each round
    drains before the next starts)."""
    img, counts, stats = runs["port"]
    wf, wst = render_wavefront(*runs["args"], 0, RES, ROUNDS, BOUNCES, with_stats=True)
    np.testing.assert_array_equal(_bits(img), _bits(wf.numpy()))
    assert (counts == ROUNDS).all()
    for key in ("closest_rays", "shadow_rays"):
        assert stats[key] == float(wst[key]), key


def test_sync_resumes_from_counts(runs):
    """Rounds 0..1 then 2..3 (resumed from the first call's counts) equal
    one 4-sample render_wavefront, within the reference's bound."""
    args = runs["args"]
    a_img, a_counts = render_spp_sync(*args, 0, RES, 2, 5)
    b_img, b_counts = render_spp_sync(*args, a_counts, RES, 2, 5)
    full = render_wavefront(*args, 0, RES, 4, 5)
    np.testing.assert_allclose((a_img + b_img).numpy(), full.numpy(), rtol=2e-5, atol=2e-5)
    assert (b_counts == 2).all()


@pytest.mark.parametrize("form", ["hw", "flat", "scalar"])
def test_sync_base_counts_forms(house_args, form):
    """base_counts as (H, W), flat (H*W,) in pixel order, or a scalar: a
    uniform base gives the same image in each form, and a per-pixel base
    renders each pixel's own samples (pixel order, not lane order)."""
    args = house_args
    w, h = RES
    uniform = {"hw": np.full((h, w), 5, np.uint32), "flat": np.full(h * w, 5, np.uint32),
               "scalar": 5}[form]
    ref = render_wavefront(*args, 5, RES, 2, 4)
    img, counts = render_spp_sync(*args, uniform, RES, 2, 4)
    np.testing.assert_array_equal(_bits(img.numpy()), _bits(ref.numpy()))
    assert (counts == 2).all()
    per_pixel = (np.arange(h * w, dtype=np.uint32) % 7).reshape(h, w)
    if form != "scalar":
        base = per_pixel if form == "hw" else per_pixel.reshape(-1)
        img, _ = render_spp_sync(*args, base, RES, 2, 4)
        ref = render_wavefront(*args, per_pixel, RES, 2, 4)
        np.testing.assert_array_equal(_bits(img.numpy()), _bits(ref.numpy()))
    with pytest.raises(ValueError, match="values for"):
        render_spp_sync(*args, np.zeros(h * w + 1, np.uint32), RES, 1, 4)




def test_hook_whole_image_is_render_freerun(house_args):
    """row0=0, every row, stride 1, offset 0: render_freerun's result."""
    w, h = RES
    base = (np.arange(h * w, dtype=np.uint32) % 5).reshape(h, w)
    saved_img, saved_counts = render_freerun(*house_args, base, RES, 10, BOUNCES)
    wave = Wavefront(*house_args, base, RES, NO_LIMIT, 10, BOUNCES,
                     row0=0, rows=h, sample_stride=1, sample_offset=0)
    wave.run()
    film, counts, _ = wave.results()
    np.testing.assert_array_equal(_bits(film.reshape(h, w, 3).numpy()), _bits(saved_img.numpy()))
    np.testing.assert_array_equal(counts.reshape(h, w).numpy(), saved_counts.numpy())


def test_hook_row_blocks_are_the_image(house_args):
    """Two blocks of 8 rows seed with the global pixel index and the whole
    image's height: stacked, they are the whole image's free-run (a block
    that regenerated with local rows would repeat the top half)."""
    w, h = RES
    base = (np.arange(h * w, dtype=np.uint32) % 5).reshape(h, w)
    img, counts = render_freerun(*house_args, base, RES, 10, BOUNCES)
    blocks = []
    for row0 in (0, h // 2):
        wave = Wavefront(*house_args, base[row0:row0 + h // 2], RES, NO_LIMIT, 10, BOUNCES,
                         row0=row0, rows=h // 2)
        wave.run()
        film, cnt, _ = wave.results()
        blocks.append((film.reshape(h // 2, w, 3), cnt.reshape(h // 2, w)))
    np.testing.assert_array_equal(_bits(torch.cat([b[0] for b in blocks]).numpy()), _bits(img.numpy()))
    np.testing.assert_array_equal(torch.cat([b[1] for b in blocks]).numpy(), counts.numpy())
    assert not torch.equal(blocks[0][0], blocks[1][0])


def test_hook_sample_map(house_args):
    """Local samples 0 and 1 under stride 3, offset 2 are global samples 2
    and 5 (the second one regenerated inside SHADE's plain version)."""
    wave = Wavefront(*house_args, 0, RES, 2, NO_LIMIT, BOUNCES, sample_stride=3, sample_offset=2)
    wave.run()
    film, counts, _ = wave.results()
    ref = render_wavefront(*house_args, 2, RES, 1, BOUNCES) + render_wavefront(*house_args, 5, RES, 1,
                                                                               BOUNCES)
    np.testing.assert_array_equal(_bits(film.reshape(*RES[::-1], 3).numpy()), _bits(ref.numpy()))
    assert (counts == 2).all()
