"""BIG_SHADE: the port's big_shade_plain against the Pallas
big_shade_call in interpret mode (RT_PALLAS_INTERPRET=1), on one 32x128
tile over the big-mesh scene of conftest's big_tri_scene (200 triangles
in 4 chunks, one sphere, one plane: every winner type).

Both sides get one host scene and one seeded numpy input: winner (t,
type, index) triples with misses, NEE directions and uvs, RNG states and
the carry. The Pallas twin takes the hit flag and the hit points ro + rd
* t, the 19 slot tiles of JAX's winner_table rows at the global winner
index (render/wavefront.py:1003-1010 of the reference) and the fused uv
(the NEE uv on hit lanes, the carried ray's miss uv on the others) with
its gathered quad rows; the port takes the (t, type, index) triples, the
NEE uv and the quad table, derives the hit flag and point, and reads its
own union rows (scene.winner) and quad rows. The NEE uvs of the first
four hit lanes lie on and just past the texture's edges. The Pallas
twin's per-lane active and hitmask are the port's ray counters' sums.

big_shade_plain, which derives the hit point, computes the fused uv and
gathers its quad row itself, is held bitwise to that composition spelled
out (the hit point, the fused uv, envmap.quad_index, one index_select,
then big_shade_body).

Tolerances as in tests/test_torch_shade.py and test_torch_trace.py:
torch and XLA round sqrt, sin and cos differently and XLA contracts
multiply-adds, so integer outputs must agree on >= 99.9% of lanes and
floats be isclose(1e-4, 1e-5) on >= 99.5%. The near-specular caveat of
test_torch_trace.py applies to the one output that carries the GGX pdf
itself, last_pdf: on continuing lanes of a material with alpha < 0.01
it is held to the same bound through the path weight instead, which
enters the throughput (tp0..tp2), and those lanes' last_pdf is not
compared.
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
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import envmap
from rsoderh_raytracing_tpu_torch.scene.device import FIELDS, device_scene_from_arrays

torch.set_num_threads(2)

INT_EQUAL_MIN = 0.999
FLOAT_CLOSE_MIN = 0.995
RTOL, ATOL = 1e-4, 1e-5
SPECULAR_ALPHA = 0.01
ROWS, LANES = 32, 128
N = ROWS * LANES
WIDTH, HEIGHT = 64, 64
MAX_BOUNCES = 4
ISCAL = (7, 3, 9, 1, 0)  # it_next, spp, budget, stride, offset


def seeded_inputs(js, env):
    g = np.random.default_rng(21)
    env_h, env_w = env.texture_shape
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731

    def unit(n):
        v = g.normal(size=(3, n))
        return (v / np.linalg.norm(v, axis=0)).astype(np.float32)

    n_sph, n_pln = js.sph_radius.shape[0], js.pln_valid.shape[0]
    real = {0: 1, 1: 1, 2: int(np.asarray(js.tri_valid).sum())}
    btype = g.choice([-1, 0, 1, 2], N, p=[0.15, 0.2, 0.15, 0.5]).astype(np.int32)
    bidx = np.array([g.integers(0, real[t]) if t >= 0 else 0 for t in btype], np.int32)
    gidx = np.where(btype == 0, bidx, np.where(btype == 1, n_sph + bidx,
                                               np.where(btype == 2, n_sph + n_pln + bidx, 0)))
    nee_u = g.random(N, dtype=np.float32)
    nee_v = g.random(N, dtype=np.float32)
    edges = np.flatnonzero(btype >= 0)[:4]
    nee_u[edges] = [0.0, 1.0, -8.4e-7, 1.0000008]
    nee_v[edges] = [0.0, 1.0, 0.5, 0.5]
    rd = -unit(N)
    rd[2] = -np.abs(rd[2])
    rd /= np.linalg.norm(rd, axis=0)
    miss_u, miss_v = (t.numpy() for t in envmap.direction_to_equirect_uv(*torch.from_numpy(rd)))
    fu = np.where(btype >= 0, nee_u, miss_u)
    fv = np.where(btype >= 0, nee_v, miss_v)
    qidx = envmap.quad_index(torch.from_numpy(fu), torch.from_numpy(fv), env_w, env_h).numpy()
    carry = dict(
        tp0=f32(g.random(N)), tp1=f32(g.random(N)), tp2=f32(g.random(N)),
        inc0=f32(g.random(N)), inc1=f32(g.random(N)), inc2=f32(g.random(N)),
        last_pdf=f32(np.where(g.random(N) < 0.3, 1.0, g.exponential(2.0, N))),
        bounce=g.integers(0, MAX_BOUNCES, N).astype(np.int32),
        sample=g.integers(0, 5, N).astype(np.uint32),
        in_path=(g.random(N) < 0.9).astype(np.int32),
        film0=f32(g.random(N) * 4), film1=f32(g.random(N) * 4), film2=f32(g.random(N) * 4),
        ro0=f32(g.normal(0, 0.3, N)), ro1=f32(0.5 + g.normal(0, 0.3, N)), ro2=f32(1.0 + g.normal(0, 0.3, N)),
        rd0=rd[0], rd1=rd[1], rd2=rd[2],
    )
    t = f32(g.uniform(0.5, 4.0, N))
    tr = dict(
        hit=(btype >= 0).astype(np.int32),
        occ=(g.random(N) < 0.3).astype(np.int32),
        btype=btype, bidx=bidx,
        px=f32(carry["ro0"] + rd[0] * t), py=f32(carry["ro1"] + rd[1] * t),
        pz=f32(carry["ro2"] + rd[2] * t),
    )
    nee = unit(N)
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
    return dict(
        gidx=gidx, quad=np.asarray(env.quad)[qidx], tr=tr, t=t, carry=carry, pix=pix, scal=scal,
        nee=nee, state=g.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32),
        fu=fu, fv=fv, nee_u=nee_u, nee_v=nee_v, npmf=f32(g.exponential(1.0 / (env_w * env_h), N)),
    )


@pytest.fixture(scope="module")
def big_shade_inputs(big_tri_scene):
    """(JAX scene, port scene, JAX environment, seeded inputs)."""
    js = j_build(big_tri_scene)
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    env = j_device_environment(
        JEnvironment.from_texture("s", procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15))
    )
    return js, ts, env, seeded_inputs(js, env)


def port_args(ts, env, x):
    """big_shade_plain's arguments from the seeded inputs: the winner's (t,
    type, index), the quad table and the NEE uv, which it turns into the
    fused uv's quad rows; fresh ray counters."""
    env_h, env_w = env.texture_shape
    t = cw.tiles_to_flat
    quad = torch.from_numpy(np.asarray(env.quad).view(np.int32).copy())
    tr = t({k: x["tr"][k] for k in ("occ", "btype", "bidx")})
    tr["t"] = torch.from_numpy(x["t"])
    return (
        ts, env_w, env_h, WIDTH, HEIGHT, MAX_BOUNCES, quad, tr,
        tuple(torch.from_numpy(x["nee"][k].copy()) for k in range(3)),
        torch.from_numpy(x["state"].view(np.int32).copy()),
        torch.from_numpy(x["nee_u"]), torch.from_numpy(x["nee_v"]), torch.from_numpy(x["npmf"]),
        t(x["carry"]), *(t(x["pix"])[k] for k in ("pixel_index", "pixel_x", "pixel_y", "base_sample")),
        torch.from_numpy(x["scal"]), ISCAL, cw.RayCounters("cpu"),
    )


@pytest.fixture(scope="module")
def big_shade_pair(big_shade_inputs):
    js, ts, env, x = big_shade_inputs
    env_h, env_w = env.texture_shape

    def tile(a):
        return jnp.asarray(np.asarray(a).reshape(ROWS, LANES))

    rows = np.asarray(pwf.winner_table(js))[x["gidx"]]
    old = os.environ.get("RT_PALLAS_INTERPRET")
    os.environ["RT_PALLAS_INTERPRET"] = "1"
    try:
        new_carry, act, hitm = pwf.big_shade_call(
            js, env_w, env_h, WIDTH, HEIGHT, MAX_BOUNCES,
            tuple(tile(x["quad"][:, k]) for k in range(4)),
            {k: tile(x["tr"][k]) for k in ("hit", "occ", "btype", "px", "py", "pz")},
            tuple(tile(rows[:, k]) for k in range(19)),
            tuple(tile(x["nee"][k]) for k in range(3)), tile(x["state"]),
            tile(x["fu"]), tile(x["fv"]), tile(x["npmf"]),
            {k: tile(v) for k, v in x["carry"].items()},
            *(tile(x["pix"][k]) for k in ("pixel_index", "pixel_x", "pixel_y", "base_sample")),
            jnp.asarray(x["scal"]), jnp.asarray(np.array(ISCAL, np.uint32)),
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

    args = port_args(ts, env, x)
    got = {**cw.big_shade_plain(*args), **args[-1].stats()}
    rough = np.asarray(js.mat_roughness)
    mat = np.rint(rows[:, 18]).astype(np.int64)
    specular = (x["tr"]["hit"] != 0) & (rough[mat] ** 2 < SPECULAR_ALPHA)
    return ref, got, specular


def test_big_shade_plain_equals_the_old_composition(big_shade_inputs):
    """The hit flag and point (what the big-mesh iteration ran as tensor
    code before BIG_SHADE derived them), the fused uv, its quad_index and
    one index_select of the quad table (before BIG_SHADE read its own
    row), then big_shade_body: bitwise big_shade_plain's outputs and
    counts."""
    _, ts, env, x = big_shade_inputs
    args = port_args(ts, env, x)
    env_h, env_w = env.texture_shape
    quad, tr, nee_u, nee_v, carry = args[6], args[7], args[10], args[11], args[13]
    hit = tr["btype"] >= 0
    t_safe = torch.where(hit, tr["t"], 0.0)
    p = [carry[f"ro{k}"] + carry[f"rd{k}"] * t_safe for k in range(3)]
    old_tr = dict(tr, hit=hit.to(torch.int32), px=p[0], py=p[1], pz=p[2])
    miss_u, miss_v = envmap.direction_to_equirect_uv(carry["rd0"], carry["rd1"], carry["rd2"])
    fu, fv = torch.where(hit, nee_u, miss_u), torch.where(hit, nee_v, miss_v)
    qwords = quad.index_select(0, envmap.quad_index(fu, fv, env_w, env_h))
    assert torch.equal(qwords, torch.from_numpy(x["quad"].view(np.int32)))
    counted = cw.RayCounters("cpu")
    want = cw.big_shade_body(*args[:6], qwords, old_tr, args[8], args[9], fu, fv, *args[12:-1], counted)
    got = cw.big_shade_plain(*args)
    for a, b in zip(got.values(), want.values()):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(args[-1].slots, counted.slots)


def test_inputs_take_every_branch(big_shade_pair):
    ref, got, specular = big_shade_pair
    in_path = got["in_path"].numpy()
    assert 0.1 < in_path.mean() < 0.9
    assert (got["bounce"].numpy() == 0).any()  # regenerated lanes
    assert (got["sample"].numpy() >= ISCAL[1]).any()  # lanes past their spp quota
    assert 0.05 < specular.mean() < 0.5
    continues = (ref["hitmask"].numpy() != 0) & (got["in_path"].numpy() != 0) & (got["bounce"].numpy() > 0)
    assert continues.mean() > 0.1


# The Pallas twin's per-lane flags, which the port sums into its ray
# counters instead of writing them
COUNTED = {"active": "closest_rays", "hitmask": "shadow_rays"}


@pytest.mark.parametrize("name", (*cw.SHADE_OUT_NAMES, *COUNTED))
def test_big_shade_plain_matches_pallas(big_shade_pair, name):
    ref, got, specular = big_shade_pair
    if name in COUNTED:
        assert int(got[COUNTED[name]]) == int((ref[name].numpy() != 0).sum())
        return
    a, b = got[name].numpy(), ref[name].numpy()
    assert a.shape == b.shape == (N,)
    if name in cw.SHADE_INT_NAMES:
        assert a.dtype == np.int32
        assert (a == b).mean() >= INT_EQUAL_MIN, f"{(a != b).sum()} lanes differ"
        return
    if name == "last_pdf":
        a, b = a[~specular], b[~specular]
    close = np.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
    assert close.mean() >= FLOAT_CLOSE_MIN, f"{(~close).sum()} lanes differ"
