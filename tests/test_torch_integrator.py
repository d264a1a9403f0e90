"""The scan integrator and the composed wavefront body of the port.

Against JAX: ``render_sample`` on house at 24x16, 3 bounces (one jit of
the reference); the camera rays; the legacy float32 / bfloat16
environment layouts field for field (bfloat16 as bit patterns) and the
environment functions the scan integrator calls.

Both sides draw the same RNG stream per (pixel, sample), so a pixel
differs only where torch and XLA round a transcendental or contract an
FMA differently (ROADMAP queue 3), and rarely a path flips. Measured
here for render_sample: 42-46% of pixels bit-equal in all three
channels (a lit pixel's sum passes through sin, cos, atan2 and sqrt),
every pixel isclose(1e-4, 1e-5), relative RMSE 1.3e-6 to 6.2e-6.
Bounds: >= 30% bit-equal, >= 99% of pixels close, relative RMSE < 1e-4.

Inside the port (no tolerance beyond the reference's own): the sum of
``render_sample`` over samples against ``render_wavefront``
(rtol=atol=2e-5, as tests/test_wavefront.py holds the reference), on
house and on the 200-triangle wall (chunked route); the composed body
(RT_DISABLE_WFKERNELS=1, or a legacy environment) against the kernel
loop's plain path: with the RGBE quad both run the same tensor code on
the CPU, so counts, ray statistics and image are equal; the float32
legacy quad stores the alias table's pmf where the RGBE path recomputes
it (ulp-scale), and bfloat16 rounds that pmf by about 0.4%.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import device_environment as j_device_environment
from rsoderh_raytracing_tpu.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu.ops import envmap as jenv
from rsoderh_raytracing_tpu.ops import rng as jrng
from rsoderh_raytracing_tpu.render import integrator as j_integrator
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu_torch.env.environment import (
    Environment,
    bfloat16_bits,
    device_environment,
    device_environment_from_arrays,
)
from rsoderh_raytracing_tpu_torch.ops import envmap
from rsoderh_raytracing_tpu_torch.render import integrator
from rsoderh_raytracing_tpu_torch.render.wavefront import (
    kernel_loop_enabled,
    render_freerun,
    render_wavefront,
)
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene

torch.set_num_threads(2)

RES = (24, 16)
BOUNCES = 3
BIT_EQUAL_MIN = 0.30
CLOSE_MIN = 0.99
REL_RMSE_MAX = 1e-4
SKY = dict(sun_intensity=50.0, sun_radius=0.15)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


@pytest.fixture(scope="module")
def sky():
    return procedural_sky(64, 32, **SKY)


@pytest.fixture(scope="module")
def house(house_scene, sky):
    """(JAX scene, env, camera), (port scene, env, camera) of house."""
    jargs = (j_build(house_scene), j_device_environment(JEnvironment.from_texture("s", sky)),
             j_integrator.camera_pytree(house_scene.camera))
    targs = (build_device_scene(house_scene, device="cpu"),
             device_environment(Environment.from_texture("s", sky), device="cpu"),
             integrator.camera_pytree(house_scene.camera, device="cpu"))
    return jargs, targs


@pytest.mark.parametrize("sample", [0, 1, 7])
def test_render_sample_matches_jax(house, sample):
    jargs, targs = house
    ref = np.asarray(j_integrator.render_sample(*jargs, np.uint32(sample), RES, BOUNCES))
    got = integrator.render_sample(*targs, sample, RES, BOUNCES).numpy()
    assert got.shape == ref.shape == (RES[1], RES[0], 3)
    assert np.isfinite(got).all()
    bit_equal = (_bits(got) == _bits(ref)).all(-1).mean()
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(-1).mean()
    rel = np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))
    assert bit_equal >= BIT_EQUAL_MIN, f"bit-equal share {bit_equal:.4f}"
    assert close >= CLOSE_MIN, f"close share {close:.4f}"
    assert rel < REL_RMSE_MAX, f"relative RMSE {rel:.2e}"


def test_generate_camera_rays_matches_jax(house):
    jargs, targs = house
    width, height = RES
    lane = np.arange(width * height)
    x, y = (lane % width).astype(np.int32), (lane // width).astype(np.int32)
    jstate = jrng.seed(jnp.asarray(lane.astype(np.uint32)), jnp.uint32(5))
    js, jo, jd = j_integrator.generate_camera_rays(jstate, jnp.asarray(x), jnp.asarray(y), jargs[2], RES)
    tstate = torch.from_numpy(np.asarray(jstate).astype(np.int64))
    ts, to, td = integrator.generate_camera_rays(
        tstate, torch.from_numpy(x), torch.from_numpy(y), targs[2], RES)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(torch.stack(to, -1).numpy(), np.asarray(jo))
    # the jitter goes through sqrt, sin and cos: 4 ulp at 1.0 (ROADMAP queue 3)
    np.testing.assert_allclose(torch.stack(td, -1).numpy(), np.asarray(jd), rtol=0, atol=2.0**-21)


@pytest.mark.parametrize("case", ["house_spp5", "house_base3", "wall"])
def test_render_sample_sum_matches_render_wavefront(house, big_tri_scene, sky, case):
    """Inside the port, as tests/test_wavefront.py holds the reference:
    the wavefront's image is the sum of the same per-sample images."""
    if case == "wall":
        args = (build_device_scene(big_tri_scene, device="cpu"),
                device_environment(Environment.from_texture("s", sky), device="cpu"),
                integrator.camera_pytree(big_tri_scene.camera, device="cpu"))
        base, spp, res, bounces = 0, 2, (12, 8), 4
    else:
        args = house[1]
        base, spp = (3, 2) if case == "house_base3" else (0, 5)
        res, bounces = RES, 6
    wf, wf_stats = render_wavefront(*args, base, res, spp, bounces, with_stats=True)
    seq = torch.zeros_like(wf)
    closest = shadow = 0
    for s in range(base, base + spp):
        img, stats = integrator.render_sample(*args, s, res, bounces, with_stats=True)
        seq += img
        closest += int(stats["closest_rays"])
        shadow += int(stats["shadow_rays"])
    np.testing.assert_allclose(wf.numpy(), seq.numpy(), rtol=2e-5, atol=2e-5)
    assert closest == int(wf_stats["closest_rays"])
    assert shadow == int(wf_stats["shadow_rays"])
    assert 0 < shadow <= closest and closest >= res[0] * res[1] * spp


@pytest.fixture(scope="module")
def bodies(house, big_tri_scene, sky):
    """render_freerun through the kernel loop's plain path and through
    the composed body (RT_DISABLE_WFKERNELS=1), RGBE quad, per scene."""
    host = Environment.from_texture("s", sky)
    wall = (build_device_scene(big_tri_scene, device="cpu"),
            device_environment(host, device="cpu"),
            integrator.camera_pytree(big_tri_scene.camera, device="cpu"))
    runs = {}
    for name, args, res in (("house", house[1], RES), ("wall", wall, (12, 8))):
        assert kernel_loop_enabled(args[1])
        kernel = render_freerun(*args, 0, res, 8, 4, with_stats=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RT_DISABLE_WFKERNELS", "1")
            assert not kernel_loop_enabled(args[1])
            composed = render_freerun(*args, 0, res, 8, 4, with_stats=True)
        runs[name] = (kernel, composed)
    return runs


@pytest.mark.parametrize("name", ["house", "wall"])
def test_composed_body_equals_kernel_loop(bodies, name):
    (k_img, k_cnt, k_st), (c_img, c_cnt, c_st) = bodies[name]
    assert int(k_cnt.min()) > 0
    assert torch.equal(c_cnt, k_cnt)
    assert {k: int(v) for k, v in c_st.items()} == {k: int(v) for k, v in k_st.items()}
    if name == "house":
        # the same tensor code on the CPU: trace_attrs, trace_epilogue, shade_plain
        assert torch.equal(c_img, k_img)
    else:
        # the chunked route's composed body sweeps every lane and takes
        # the winner's attributes per field; BIG_SHADE's plain version
        # reads the union row: the same values
        np.testing.assert_allclose(c_img.numpy(), k_img.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,mean_rtol,close_min", [("float32", 1e-5, 0.99), ("bfloat16", 1e-2, 0.5)])
def test_legacy_environment_takes_the_composed_body(house, sky, dtype, mean_rtol, close_min):
    """A legacy quad renders through the composed body and agrees with
    the RGBE kernel loop: float32 within rounding of the stored pmf
    (measured here: counts equal, every value isclose(1e-4, 1e-5), 96.6%
    bit-equal), bfloat16 within its 0.4% pmf rounding (measured here:
    counts equal, image mean within 1.6e-4 relative, 65.9% of values
    isclose(1e-4, 1e-5))."""
    scene, env, cam = house[1]
    legacy = device_environment(Environment.from_texture("s", sky), device="cpu", radiance_dtype=dtype)
    assert not kernel_loop_enabled(legacy)
    ref, ref_cnt = render_freerun(scene, env, cam, 0, RES, 8, 4)
    got, cnt = render_freerun(scene, legacy, cam, 0, RES, 8, 4)
    assert bool(torch.isfinite(got).all())
    assert (cnt == ref_cnt).double().mean() >= 0.99
    np.testing.assert_allclose(float(got.mean()), float(ref.mean()), rtol=mean_rtol)
    assert np.isclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5).mean() >= close_min


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def legacy_envs(request, sky):
    jd = j_device_environment(JEnvironment.from_texture("s", sky), radiance_dtype=request.param)
    td = device_environment(Environment.from_texture("s", sky), device="cpu",
                            radiance_dtype=request.param)
    return request.param, jd, td


def _quad_bits(quad):
    a = np.asarray(quad)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def test_legacy_device_environment_bitwise(legacy_envs):
    dtype, jd, td = legacy_envs
    assert td.texture_shape == tuple(jd.texture_shape)
    assert td.quad.shape == tuple(jd.quad.shape) == (64 * 32, 16)
    assert td.quad.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    ours = td.quad.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" else _bits(td.quad.numpy())
    np.testing.assert_array_equal(ours, _quad_bits(jd.quad))
    np.testing.assert_array_equal(_bits(td.alias_pair.numpy()), _bits(jd.alias_pair))
    np.testing.assert_array_equal(_bits(td.pmf_norm.numpy()), _bits(jd.pmf_norm))


def test_legacy_environment_from_arrays_round_trip(legacy_envs):
    _, jd, td = legacy_envs
    rt = device_environment_from_arrays(
        jd.texture_shape, np.asarray(jd.quad), np.asarray(jd.alias_pair), np.asarray(jd.pmf_norm),
        device="cpu",
    )
    assert rt.quad.dtype == td.quad.dtype
    assert torch.equal(rt.quad.view(torch.int16), td.quad.view(torch.int16))


def test_bfloat16_bits_round_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.01171875, -3.0e38, 0.0, 1.0 + 2.0**-8 + 2.0**-20], np.float32)
    ref = np.asarray(jnp.asarray(x, dtype=jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(bfloat16_bits(x), ref)


def test_legacy_radiance_and_pmf_matches_jax(legacy_envs):
    """Legacy rows: the radiance is exact arithmetic on stored texels and
    the pmf a stored column, so both are bitwise equal."""
    _, jd, td = legacy_envs
    uv = np.random.default_rng(17).random((20_000, 2), dtype=np.float32)
    uv[:6] = [[1.0, 1.0], [0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1e-7, 0.5], [0.99999994, 0.5]]
    jr, jp = jenv.radiance_and_pmf(jd, jnp.asarray(uv))
    (r, g, b), p = envmap.radiance_and_pmf(
        td, torch.from_numpy(uv[:, 0].copy()), torch.from_numpy(uv[:, 1].copy()))
    np.testing.assert_array_equal(_bits(torch.stack([r, g, b], -1).numpy()), _bits(jr))
    np.testing.assert_array_equal(_bits(p.numpy()), _bits(jp))


@pytest.fixture(scope="module", params=["rgbe", "float32"])
def env_pair(request, sky):
    return (j_device_environment(JEnvironment.from_texture("s", sky), radiance_dtype=request.param),
            device_environment(Environment.from_texture("s", sky), device="cpu",
                               radiance_dtype=request.param))


def test_sample_environment_matches_jax(env_pair):
    """Four draws, the alias row and one quad row: state, radiance and
    the uv are exact; direction and pdf go through sin and cos."""
    jd, td = env_pair
    state = np.random.default_rng(5).integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32)
    js, jdir, jrad, jpdf = jenv.sample_environment(jnp.asarray(state), jd)
    ts, tdir, trad, tpdf = envmap.sample_environment(torch.from_numpy(state.astype(np.int64)), td)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(_bits(torch.stack(trad, -1).numpy()), _bits(jrad))
    np.testing.assert_allclose(torch.stack(tdir, -1).numpy(), np.asarray(jdir), rtol=0, atol=2.0**-22)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-5)


def test_sky_light_and_direction_pdf_match_jax(env_pair):
    """Through atan2/asin, which torch and XLA round differently: a uv
    one ulp apart may fetch the neighbouring texel, so the radiance is
    held on >= 99.9% of lanes and the pdf to 1e-4 relative on >= 99.9%."""
    jd, td = env_pair
    d = np.random.default_rng(11).normal(size=(50_000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    comps = tuple(torch.from_numpy(d[:, k].copy()) for k in range(3))
    rad = torch.stack(envmap.sky_light(td, *comps), -1).numpy()
    ref = np.asarray(jenv.sky_light(jd, jnp.asarray(d)))
    assert np.isclose(rad, ref, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.999
    pdf = envmap.direction_pdf(td, *comps).numpy()
    assert np.isclose(pdf, np.asarray(jenv.direction_pdf(jd, jnp.asarray(d))), rtol=1e-4).mean() >= 0.999
