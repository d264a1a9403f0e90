"""Film, tonemap and Renderer of the port against the JAX package.

Film arithmetic is float32 adds and one division, bitwise equal to
JAX's; the display image goes through the ACES fit and the sRGB curve,
whose pow torch and XLA round differently. Measured here over 200k
seeded values: aces_tonemap within 4.2e-7 absolute (bound 2^-20 =
9.5e-7, eight ulp at 1.0: two 3x3 products around a quotient),
linear_to_srgb within 1.2e-7 (bound 2^-22),
and every srgb8 byte equal (bound: >= 99.9% equal, never more than one
level apart).

The Renderer's own invariants are held inside the port with the
reference's bounds: step() x N equals step_batch(N) within
rtol=atol=2e-5 (tests/test_wavefront.py), a changed camera, environment
or resolution resets the film, exact mode refuses a free-run film, and a
checkpoint crosses between the two packages in both directions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rsoderh_raytracing_tpu_torch as rt_torch
from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import EnvironmentMaps as JEnvironmentMaps
from rsoderh_raytracing_tpu.ops import tonemap as j_tonemap
from rsoderh_raytracing_tpu.render.film import Film as JFilm
from rsoderh_raytracing_tpu.render.renderer import Renderer as JRenderer
from rsoderh_raytracing_tpu_torch.env.environment import Environment, EnvironmentMaps
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky, read_hdr
from rsoderh_raytracing_tpu_torch.ops import tonemap
from rsoderh_raytracing_tpu_torch.render.film import Film
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.scene.device import SMALL, route
from rsoderh_raytracing_tpu_torch.utils.png import read_png

torch.set_num_threads(2)

W, H = 20, 12
ACES_ATOL = 2.0**-20
SRGB_ATOL = 2.0**-22
SRGB8_EQUAL_MIN = 0.999


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def seeded_film_inputs(seed=0):
    g = np.random.default_rng(seed)
    sums = [g.exponential(0.8, (H, W, 3)).astype(np.float32) for _ in range(3)]
    sums[1][0, 0] = [-50.0, 0.2, 0.1]  # a negative mean: painted magenta
    counts = g.integers(1, 9, (H, W)).astype(np.uint32)
    return sums, counts


@pytest.fixture(scope="module")
def films():
    """The same accumulation history in both packages: two uniform
    batches, then one free-run result."""
    sums, counts = seeded_film_inputs()
    jf, tf = JFilm(W, H), Film(W, H, device="cpu")
    jf.add_samples(jnp.asarray(sums[0]), 3)
    tf.add_samples(torch.from_numpy(sums[0]), 3)
    jf.add_sample(jnp.asarray(sums[1]))
    tf.add_sample(torch.from_numpy(sums[1]))
    uniform = (jf.sample_count, tf.sample_count, jf.is_uniform, tf.is_uniform)
    jf.add_freerun(jnp.asarray(sums[2]), jnp.asarray(counts))
    tf.add_freerun(torch.from_numpy(sums[2]), torch.from_numpy(counts.astype(np.int64)))
    return jf, tf, uniform


def test_film_counts_and_sample_count(films):
    jf, tf, uniform = films
    assert uniform == (4, 4, True, True)
    assert not tf.is_uniform and not jf.is_uniform
    assert tf.sample_count == jf.sample_count == int(np.asarray(jf.counts).min())
    assert tf.counts.dtype == torch.int64
    np.testing.assert_array_equal(tf.counts.numpy(), np.asarray(jf.counts).astype(np.int64))
    tf.add_samples(torch.zeros(H, W, 3), 0)  # the cached minimum is dropped, then found again
    assert tf.sample_count == jf.sample_count


@pytest.mark.parametrize("what", ["cumulative", "mean_radiance"])
def test_film_arithmetic_bitwise(films, what):
    jf, tf, _ = films
    got = tf.cumulative.numpy() if what == "cumulative" else tf.mean_radiance()
    ref = np.asarray(jf.cumulative) if what == "cumulative" else jf.mean_radiance()
    assert got.dtype == np.float32 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_film_tonemapped_matches_jax(films):
    jf, tf, _ = films
    got, ref = tf.tonemapped(), jf.tonemapped()
    np.testing.assert_array_equal(got[0, 0], [1.0, 0.0, 1.0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=ACES_ATOL)


def test_film_srgb8_matches_jax(films):
    jf, tf, _ = films
    got, ref = tf.srgb8(), jf.srgb8()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (H, W, 3)
    assert (got == ref).mean() >= SRGB8_EQUAL_MIN
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("fn,atol", [("aces_tonemap", ACES_ATOL), ("linear_to_srgb", SRGB_ATOL)])
def test_tonemap_matches_jax(fn, atol):
    g = np.random.default_rng(3)
    x = g.exponential(1.0, (200_000, 3)).astype(np.float32)
    x[:1000] *= 1e-3  # the linear toe of the sRGB curve
    x[1000:1100] = -x[1000:1100]
    if fn == "linear_to_srgb":
        x = np.clip(x, -0.1, 1.2)
    got = getattr(tonemap, fn)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(j_tonemap, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.fixture(scope="module")
def envs():
    sky = procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15)
    other = np.ones((8, 16, 3), np.float32) * 0.7
    return EnvironmentMaps([Environment.from_texture("sky", sky),
                            Environment.from_texture("grey", other)])


def make_renderer(house_scene, envs, **kwargs):
    kwargs.setdefault("max_bounces", 4)
    return Renderer(house_scene, width=W, height=H, environments=envs, device="cpu", **kwargs)


def test_step_times_n_equals_step_batch(house_scene, envs):
    a = make_renderer(house_scene, envs)
    for _ in range(4):
        a.step()
    b = make_renderer(house_scene, envs)
    b.step_batch(4)
    assert a.film.sample_count == b.film.sample_count == 4
    assert a.film.is_uniform and b.film.is_uniform
    np.testing.assert_allclose(a.film.cumulative.numpy(), b.film.cumulative.numpy(),
                               rtol=2e-5, atol=2e-5)
    # step() continues where step_batch() stopped: the same fifth sample
    a.step()
    b.step()
    np.testing.assert_allclose(a.film.cumulative.numpy(), b.film.cumulative.numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("change", ["camera", "environment", "resize", "none"])
def test_state_hash_reset(house_scene, envs, change):
    import copy

    scene = copy.deepcopy(house_scene)
    r = make_renderer(scene, envs)
    r.step_batch(2)
    if change == "camera":
        r.camera.pos = np.asarray(r.camera.pos, np.float32) + np.float32(0.25)
    elif change == "environment":
        assert r.next_environment() == 1
    elif change == "resize":
        r.resize(W // 2, H)
    assert r.step() == (3 if change == "none" else 1)
    assert r.film.cumulative.shape == (H, r.width, 3)
    if change == "environment":
        assert r.next_environment() == 0  # cycles


def test_freerun_then_exact_raises(house_scene, envs):
    r = make_renderer(house_scene, envs)
    image = r.render(spp=3, mode="freerun")
    assert image.shape == (H, W, 3) and image.min() >= 0.0 and image.max() <= 1.0
    assert r.film.sample_count >= 3 and not r.film.is_uniform
    assert int(r.film.counts.max()) > r.film.sample_count
    assert r.last_stats["closest_rays"] >= W * H and r.last_stats["iterations"] > 0
    assert 0 < r.last_stats["shadow_rays"] <= r.last_stats["closest_rays"]
    with pytest.raises(ValueError, match="exact mode cannot extend"):
        r.render(spp=8)
    with pytest.raises(ValueError, match="unknown mode"):
        r.render(spp=8, mode="sync")


@pytest.mark.parametrize("batch", [None, 1, 2])
def test_render_exact_reaches_spp(house_scene, envs, batch):
    r = make_renderer(house_scene, envs)
    r.render(spp=3, batch=batch)
    assert r.film.sample_count == 3 and bool((r.film.counts == 3).all())
    before = r.film.cumulative.clone()
    r.render(spp=3)  # `spp` is the total target: nothing more to render
    assert torch.equal(r.film.cumulative, before)


def test_renderer_takes_bvh_and_sweep_past_the_budget(house_scene, envs):
    """'bvh' is ported and takes the BVH route; 'sweep' on a scene past the
    unroll budget that the chunked route does not cover (200 plane lanes)
    takes the small route, renders, and reports 'sweep'."""
    assert make_renderer(house_scene, envs, intersector="bvh").intersector == "bvh"
    plane = type(house_scene.planes[0])
    planes = dataclasses.replace(house_scene, spheres=[], planes=[
        plane(pos=(float(i), -1.0, -4.0), right=(0.5, 0.0, 0.0), forward=(0.0, 0.0, 0.5),
              material_id=0) for i in range(200)])
    r = make_renderer(planes, envs, intersector="sweep")
    assert r.intersector == "sweep" and route(r.device_scene) == SMALL
    assert r.device_scene.num_lanes > 192
    r.render(spp=2)
    assert r.film.sample_count == 2 and np.isfinite(r.film.mean_radiance()).all()


def test_renderer_refuses_intersector(house_scene, envs):
    """An unknown intersector raises ValueError."""
    with pytest.raises(ValueError):
        make_renderer(house_scene, envs, intersector="octree")


def test_renderer_defaults_to_the_card(house_scene, envs):
    if torch.cuda.is_available():
        assert Renderer(house_scene, W, H, environments=envs).film.cumulative.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Renderer(house_scene, W, H, environments=envs)


def test_package_render_twice(house_scene, envs):
    """The `render` subpackage must not shadow the function after the
    first call."""
    a = rt_torch.render(house_scene, W, H, spp=1, environments=envs, max_bounces=2, device="cpu")
    b = rt_torch.render(house_scene, W, H, spp=1, environments=envs, max_bounces=2, device="cpu")
    assert a.shape == (H, W, 3) and np.array_equal(a, b)


def test_outputs_read_back(house_scene, envs, tmp_path):
    r = make_renderer(house_scene, envs)
    r.render(spp=2)
    r.save_png(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), r.film.srgb8())
    r.save_hdr(str(tmp_path / "a.hdr"))
    hdr = read_hdr(str(tmp_path / "a.hdr"))
    # RGBE keeps 8 mantissa bits of the largest channel
    mean = r.film.mean_radiance()
    assert np.abs(hdr - mean).max() <= mean.max(-1).max() * 2.0**-7


def j_renderer(house_scene, **kwargs):
    sky = procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15)
    envs = JEnvironmentMaps([JEnvironment.from_texture("sky", sky),
                             JEnvironment.from_texture("grey", np.ones((8, 16, 3), np.float32) * 0.7)])
    return JRenderer(house_scene, width=W, height=H, environments=envs, max_bounces=4, **kwargs)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("history", ["uniform", "freerun"])
def test_checkpoint_crosses_packages(house_scene, envs, tmp_path, direction, history):
    sums, counts = seeded_film_inputs(5)
    path = str(tmp_path / "ckpt.npz")
    jr, tr = j_renderer(house_scene), make_renderer(house_scene, envs)
    np.testing.assert_array_equal(jr._state_stamp(), tr._state_stamp())
    if direction == "jax_to_port":
        jr.film.add_samples(jnp.asarray(sums[0]), 5)
        if history == "freerun":
            jr.film.add_freerun(jnp.asarray(sums[1]), jnp.asarray(counts))
        jr.save_checkpoint(path)
        tr.load_checkpoint(path)
    else:
        tr.film.add_samples(torch.from_numpy(sums[0]), 5)
        if history == "freerun":
            tr.film.add_freerun(torch.from_numpy(sums[1]), torch.from_numpy(counts.astype(np.int64)))
        tr.save_checkpoint(path)
        jr.load_checkpoint(path)
    with np.load(path) as z:
        assert set(z.files) == {"cumulative", "counts", "sample_count", "state_stamp"}
        assert z["cumulative"].dtype == np.float32 and z["counts"].dtype == np.uint32
        assert z["state_stamp"].dtype == np.int64
    np.testing.assert_array_equal(_bits(tr.film.cumulative.numpy()), _bits(jr.film.cumulative))
    np.testing.assert_array_equal(tr.film.counts.numpy(), np.asarray(jr.film.counts).astype(np.int64))
    assert tr.film.sample_count == jr.film.sample_count == (5 + counts.min() if history == "freerun" else 5)
    assert tr.film.is_uniform == jr.film.is_uniform == (history == "uniform")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_stamp_mismatch_raises(house_scene, envs, tmp_path, writer):
    import copy

    path = str(tmp_path / "ckpt.npz")
    (j_renderer(house_scene) if writer == "jax" else make_renderer(house_scene, envs)).save_checkpoint(path)
    moved = copy.deepcopy(house_scene)
    moved.camera.pos = np.asarray(moved.camera.pos, np.float32) + np.float32(1.0)
    with pytest.raises(ValueError, match="different"):
        make_renderer(moved, envs).load_checkpoint(path)
    other_env = make_renderer(house_scene, envs)
    other_env.next_environment()
    with pytest.raises(ValueError, match="different"):
        other_env.load_checkpoint(path)
    wrong_size = Renderer(house_scene, width=W, height=H + 1, environments=envs, device="cpu")
    with pytest.raises(ValueError):
        wrong_size.load_checkpoint(path)


def test_checkpoint_without_stamp_or_counts_loads(house_scene, envs, tmp_path):
    path = str(tmp_path / "old.npz")
    np.savez(path, cumulative=np.ones((H, W, 3), np.float32), sample_count=7)
    r = make_renderer(house_scene, envs)
    r.load_checkpoint(path)
    assert r.film.sample_count == 7 and r.film.is_uniform and bool((r.film.counts == 7).all())


def test_debug_views_match_jax(house_scene, envs):
    tr, jr = make_renderer(house_scene, envs), j_renderer(house_scene)
    got, ref = tr.debug_alias_scatter(draws_per_pixel=3), jr.debug_alias_scatter(draws_per_pixel=3)
    assert got.shape == ref.shape == (32, 64, 3)
    np.testing.assert_array_equal(_bits(got.astype(np.float32)), _bits(ref.astype(np.float32)))
    assert tr.debug_alias_scatter(draws_per_pixel=3) is got  # cached
    np.testing.assert_array_equal(tr.debug_hdri_view(), jr.debug_hdri_view())
