"""SHADE: the port's shade_plain against the Pallas shade_call.

The Pallas kernel runs in interpret mode on the CPU
(RT_PALLAS_INTERPRET=1) on one 32x128 tile. Every input is seeded: the
carry, the trace products, the quad words (real RGBE rows of a
procedural sky at each lane's fused uv, with the uv edges 0, 1 and just
outside [0, 1] included) and the scalars. spp is small, so the unsigned
`next_sample < spp` regeneration test takes both branches.

Tolerances as in test_torch_trace.py: torch and XLA round sin, cos and
sqrt differently and XLA contracts FMAs (ROADMAP queue 3). Integer
outputs must agree on >= 99.9% of lanes, floats be
isclose(rtol=1e-4, atol=1e-5) on >= 99.5%.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import device_environment as j_device_environment
from rsoderh_raytracing_tpu.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu.ops import pallas_wavefront as pwf
from rsoderh_raytracing_tpu.scene.camera import Camera
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import envmap

torch.set_num_threads(2)

INT_EQUAL_MIN = 0.999
FLOAT_CLOSE_MIN = 0.995
RTOL, ATOL = 1e-4, 1e-5
ROWS, LANES = 32, 128
N = ROWS * LANES
WIDTH, HEIGHT = 64, 64
MAX_BOUNCES = 4
ISCAL = (7, 3, 9, 1, 0)  # it_next, spp, budget, stride, offset


def seeded_inputs(env):
    g = np.random.default_rng(42)
    env_h, env_w = env.texture_shape
    f32 = lambda *a: a[0].astype(np.float32)  # noqa: E731

    def unit(n):
        v = g.normal(size=(3, n))
        return (v / np.linalg.norm(v, axis=0)).astype(np.float32)

    fu = g.random(N, dtype=np.float32)
    fv = g.random(N, dtype=np.float32)
    fu[:6] = [0.0, 1.0, -8.4e-7, 1.0000008, 0.5, 0.99999994]
    fv[:6] = [0.0, 1.0, 0.5, 0.5, 1.0, 1e-7]
    qidx = envmap.quad_index(torch.from_numpy(fu), torch.from_numpy(fv), env_w, env_h).numpy()
    quad = np.asarray(env.quad)[qidx]
    bd = unit(N)
    tr = dict(
        hit=(g.random(N) < 0.6).astype(np.int32),
        occ=(g.random(N) < 0.3).astype(np.int32),
        px=f32(g.normal(0, 2, N)), py=f32(g.normal(0, 2, N)), pz=f32(g.normal(0, 2, N)),
        er=f32(np.where(g.random(N) < 0.1, g.random(N) * 3, 0.0)),
        eg=f32(np.where(g.random(N) < 0.1, g.random(N) * 3, 0.0)),
        eb=f32(np.where(g.random(N) < 0.1, g.random(N) * 3, 0.0)),
        ct=f32(np.maximum(g.normal(0.3, 0.4, N), 0.0)),
        ns0=f32(g.random(N) * 0.4), ns1=f32(g.random(N) * 0.4), ns2=f32(g.random(N) * 0.4),
        npdf=f32(g.exponential(1.0, N)),
        bd0=bd[0], bd1=bd[1], bd2=bd[2],
        bpdf=f32(np.where(g.random(N) < 0.05, 0.0, g.exponential(1.0, N))),
        bs0=f32(g.random(N) * 0.4), bs1=f32(g.random(N) * 0.4), bs2=f32(g.random(N) * 0.4),
        bz=(g.random(N) < 0.02).astype(np.int32),
        cb=f32(g.random(N)),
        state=g.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32),
        fu=fu, fv=fv,
    )
    rd = unit(N)
    carry = dict(
        tp0=f32(g.random(N)), tp1=f32(g.random(N)), tp2=f32(g.random(N)),
        inc0=f32(g.random(N)), inc1=f32(g.random(N)), inc2=f32(g.random(N)),
        last_pdf=f32(np.where(g.random(N) < 0.3, 1.0, g.exponential(2.0, N))),
        bounce=g.integers(0, MAX_BOUNCES, N).astype(np.int32),
        sample=g.integers(0, 5, N).astype(np.uint32),
        in_path=(g.random(N) < 0.9).astype(np.int32),
        film0=f32(g.random(N) * 4), film1=f32(g.random(N) * 4), film2=f32(g.random(N) * 4),
        ro0=f32(g.normal(0, 1, N)), ro1=f32(g.normal(0, 1, N)), ro2=f32(g.normal(0, 1, N)),
        rd0=rd[0], rd1=rd[1], rd2=rd[2],
    )
    lane = np.arange(N)
    pix = dict(
        pixel_index=(lane % (WIDTH * HEIGHT)).astype(np.uint32),
        pixel_x=(lane % WIDTH).astype(np.int32),
        pixel_y=((lane // WIDTH) % HEIGHT).astype(np.int32),
        base_sample=g.integers(0, 1000, N).astype(np.uint32),
    )
    cam = Camera(pos=[0.3, 1.0, 2.0], yaw=0.4, pitch=-0.2, fov_y=1.1)
    scal = np.concatenate([
        [np.sin(np.float32(cam.fov_y) / np.float32(2.0)), np.float32(WIDTH / HEIGHT)],
        np.asarray(cam.pos, np.float32), np.asarray(cam.rot_transform(), np.float32).reshape(9),
        np.asarray(env.pmf_norm, np.float32),
    ]).astype(np.float32)
    npmf = f32(g.exponential(1.0 / (env_w * env_h), N))
    return quad, tr, npmf, carry, pix, scal


@pytest.fixture(scope="module")
def shade_pair():
    env = j_device_environment(
        JEnvironment.from_texture("s", procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15))
    )
    env_h, env_w = env.texture_shape
    quad, tr, npmf, carry, pix, scal = seeded_inputs(env)

    def tile(a):
        return jnp.asarray(np.asarray(a).reshape(ROWS, LANES))

    old = os.environ.get("RT_PALLAS_INTERPRET")
    os.environ["RT_PALLAS_INTERPRET"] = "1"
    try:
        new_carry, act, hitm = pwf.shade_call(
            env_w, env_h, WIDTH, HEIGHT, MAX_BOUNCES,
            tuple(tile(quad[:, k]) for k in range(4)),
            {k: tile(v) for k, v in tr.items()}, tile(npmf),
            {k: tile(v) for k, v in carry.items()},
            tile(pix["pixel_index"]), tile(pix["pixel_x"]), tile(pix["pixel_y"]),
            tile(pix["base_sample"]), jnp.asarray(scal),
            jnp.asarray(np.array(ISCAL, np.uint32)),
        )
    finally:
        if old is None:
            del os.environ["RT_PALLAS_INTERPRET"]
        else:
            os.environ["RT_PALLAS_INTERPRET"] = old
    ref = cw.tiles_to_flat(
        {**{k: np.asarray(v) for k, v in new_carry.items()},
         "active": np.asarray(act), "hitmask": np.asarray(hitm)}
    )

    t = cw.tiles_to_flat
    counters = cw.RayCounters("cpu")
    got_carry = cw.shade_plain(
        env_w, env_h, WIDTH, HEIGHT, MAX_BOUNCES,
        torch.from_numpy(quad.view(np.int32).copy()), t(tr), torch.from_numpy(npmf), t(carry),
        *(t(pix)[k] for k in ("pixel_index", "pixel_x", "pixel_y", "base_sample")),
        torch.from_numpy(scal), ISCAL, counters,
    )
    got = {**got_carry, **counters.stats()}
    return ref, got


def test_inputs_take_every_branch(shade_pair):
    ref, got = shade_pair
    in_path = got["in_path"].numpy()
    sample = got["sample"].numpy()
    assert 0.1 < in_path.mean() < 0.9
    assert (got["bounce"].numpy() == 0).any()  # regenerated lanes
    assert (sample >= ISCAL[1]).any()  # lanes past their spp quota
    assert int(got["shadow_rays"]) > 0
    assert int(got["iterations"]) == 1


# The Pallas twin's per-lane flags, which the port sums into its ray
# counters instead of writing them
COUNTED = {"active": "closest_rays", "hitmask": "shadow_rays"}


@pytest.mark.parametrize("name", (*cw.SHADE_OUT_NAMES, *COUNTED))
def test_shade_plain_matches_pallas(shade_pair, name):
    ref, got = shade_pair
    if name in COUNTED:
        assert int(got[COUNTED[name]]) == int((ref[name].numpy() != 0).sum())
        return
    a, b = got[name].numpy(), ref[name].numpy()
    assert a.shape == b.shape == (N,)
    if name in ("state", "bounce", "sample", "in_path"):
        assert a.dtype == np.int32
        assert (a == b).mean() >= INT_EQUAL_MIN, f"{(a != b).sum()} lanes differ"
    else:
        close = np.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
        assert close.mean() >= FLOAT_CLOSE_MIN, f"{(~close).sum()} lanes differ"
