"""TRACE: the port's trace_plain against the JAX composition that it
replaces, and the plain sweep on house against JAX's composed trace_nee.

The port's TRACE takes the carried ray and RNG state and the environment.
Its reference is the JAX kernel loop's iteration up to SHADE
(render/wavefront.py:928-938 and the quad take): envmap.sample_alias_index,
equirect_uv_to_direction and the arctan2/arcsin miss uv, then the Pallas
trace_call in interpret mode on the CPU (RT_PALLAS_INTERPRET=1, as
tests/test_wavefront.py runs it), then jnp.take(env.quad, qidx). It runs
on a tiny scene (one sphere, one plane, one triangle, pad_to=1), a seeded
64x32 environment and one 32x128 tile of seeded rays; four of them escape
along -x (dz = -0 and +0) and +-y, where the miss uv leaves [0, 1] and
the quad index clamps. House is compared through JAX's composed path,
which on the CPU is plain XLA.

Tolerances: torch and XLA round sqrt, sin and cos differently, and XLA
contracts multiply-adds into FMAs (ROADMAP queue 3), so float outputs are
compared with isclose(rtol=1e-4, atol=1e-5) and a grazing ray may flip a
hit or an occlusion. Integer outputs must agree on >= 99.9% of lanes and
floats be close on >= 99.5%. The alias draw is exact integer and IEEE
arithmetic on both sides: its index and NEE pmf must be bitwise JAX's on
every lane, and the quad row on every lane where the hit flags agree (a
flipped hit takes the other uv). Every assertion on a share of lanes
reports the number of lanes that differ.

Near-specular lanes (a hit on a material with alpha = roughness^2 <
0.01; here the mirror sphere, alpha 0.0025) are the exception for the
bounce sample's pdf, scattering and cosine: the GGX D term at such alpha
turns the last ulp of h.z into tens of percent of the pdf (measured: 22%
for bpdf, 30% for bs, 6% for cb). Their ratio, the path weight
bs * cb / bpdf that the integrator uses, is well conditioned, and it is
held to the standard bounds on those lanes instead (measured: 99.5th
percentile 9.4e-6 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import device_environment as j_device_environment
from rsoderh_raytracing_tpu.ops import envmap as jenv
from rsoderh_raytracing_tpu.ops import intersect as j_intersect
from rsoderh_raytracing_tpu.ops import pallas_wavefront as pwf
from rsoderh_raytracing_tpu.scene.camera import Camera
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu.scene.types import Material, PackedMeshes, Plane, Scene, Sphere
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import envmap, intersect, rng
from rsoderh_raytracing_tpu_torch.scene.device import FIELDS, device_scene_from_arrays

torch.set_num_threads(2)

INT_EQUAL_MIN = 0.999
FLOAT_CLOSE_MIN = 0.995
RTOL, ATOL = 1e-4, 1e-5
SPECULAR_ALPHA = 0.01
SPECULAR_SENSITIVE = ("bpdf", "bs0", "bs1", "bs2", "cb")
ROWS, LANES = 32, 128
N = ROWS * LANES
ENV_W, ENV_H = 64, 32


def tiny_scene():
    """One sphere, one plane and one triangle, with an emissive material
    so the emission outputs are exercised."""
    meshes = PackedMeshes(
        vertices=np.array([[-1.5, -0.5, -2.5], [-0.5, -0.5, -2.5], [-1.0, 0.6, -2.5]], np.float32),
        normals=np.array([[0.0, 0.0, 1.0], [0.2, 0.0, 0.98], [0.0, 0.2, 0.98]], np.float32),
        triangles=np.array([[0, 1, 2, 0, 1, 2, 2]], np.int32),
    )
    return Scene(
        materials=[
            Material((0.7, 0.3, 0.2), 0.5, 0.0, (0, 0, 0)),
            Material((0.9, 0.9, 0.9), 0.05, 1.0, (0, 0, 0)),
            Material((0.4, 0.8, 0.3), 0.3, 0.2, (1.5, 0.5, 0.2)),
        ],
        spheres=[Sphere(pos=(0.6, 0.0, -3.0), radius=1.0, material_id=1)],
        planes=[Plane(pos=(-4.0, -1.2, -8.0), right=(8.0, 0.0, 0.0),
                      forward=(0.0, 0.0, 8.0), material_id=0)],
        meshes=meshes,
        camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=1.2),
    )


def port_scene(jscene):
    return device_scene_from_arrays({f: np.asarray(getattr(jscene, f)) for f in FIELDS}, device="cpu")


def seeded_texture(seed):
    """A 64x32 HDR texture with a wide range, so the alias table has both
    kept and aliased texels."""
    g = np.random.default_rng(seed)
    return (g.uniform(0.0, 2.0, (ENV_H, ENV_W, 3)) ** 4).astype(np.float32)


def seeded_inputs(seed):
    """Ray origins, directions and u32 states, (3, N), (3, N) and (N,);
    lanes 0-3 escape along -x (dz = -0 and +0), +y and -y."""
    g = np.random.default_rng(seed)
    ro = g.normal(0.0, 0.3, (3, N)).astype(np.float32)
    rd = np.stack([g.uniform(-0.9, 0.9, N), g.uniform(-0.8, 0.5, N), -np.ones(N)])
    rd = (rd / np.linalg.norm(rd, axis=0)).astype(np.float32)
    ro[:, :4] = [[0.0] * 4, [0.0] * 4, [0.5] * 4]
    rd[:, :4] = [[-1.0, -1.0, 0.0, 0.0], [0.0, 0.0, 1.0, -1.0], [-0.0, 0.0, 0.0, 0.0]]
    state = g.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return ro, rd, state


def port_inputs(seed):
    """The port's (environment, carry) for seeded_inputs(seed)."""
    ro, rd, state = seeded_inputs(seed)
    env = device_environment(Environment.from_texture("s", seeded_texture(seed)), device="cpu")
    carry = {f"{k}{i}": torch.from_numpy(np.ascontiguousarray(a[i])) for k, a in (("ro", ro), ("rd", rd))
             for i in range(3)}
    carry["state"] = torch.from_numpy(state.view(np.int32))
    return env, carry


def jax_trace(jscene, seed):
    """The JAX kernel loop's iteration up to SHADE on seeded_inputs(seed):
    the alias draw, the NEE direction, the miss uv, the Pallas TRACE in
    interpret mode and the quad take. Returns its outputs as flat tensors
    by the port's TRACE_OUT_NAMES, plus the Pallas qidx and the alias
    index."""
    import os

    ro, rd, state = seeded_inputs(seed)
    jd = j_device_environment(JEnvironment.from_texture("s", seeded_texture(seed)))
    drawn, index, nee_uv, nee_pmf = jenv.sample_alias_index(jnp.asarray(state), jd)
    nd = jenv.equirect_uv_to_direction(nee_uv)
    miss_u = jnp.arctan2(rd[2], rd[0]) * (jenv.INV_PI * 0.5) + 0.5
    miss_v = 0.5 - jnp.arcsin(jnp.clip(rd[1], -1.0, 1.0)) * jenv.INV_PI

    def tiles(*a):
        return tuple(jnp.asarray(x).reshape(ROWS, LANES) for x in a)

    old = os.environ.get("RT_PALLAS_INTERPRET")
    os.environ["RT_PALLAS_INTERPRET"] = "1"
    try:
        ref = pwf.trace_call(
            jscene, ENV_W, ENV_H, tiles(*ro), tiles(*rd), tiles(nd[:, 0], nd[:, 1], nd[:, 2]),
            tiles(nee_uv[:, 0], nee_uv[:, 1]), tiles(miss_u, miss_v),
            drawn.reshape(ROWS, LANES),
        )
    finally:
        if old is None:
            del os.environ["RT_PALLAS_INTERPRET"]
        else:
            os.environ["RT_PALLAS_INTERPRET"] = old
    ref = dict(ref, nee_pmf=nee_pmf, alias_index=index)
    ref["quad"] = jnp.take(jd.quad, ref["qidx"].reshape(-1), axis=0)
    return cw.tiles_to_flat({k: np.asarray(v) for k, v in ref.items()}) | {
        "quad": torch.from_numpy(np.asarray(ref["quad"]).view(np.int32).copy())}


@pytest.fixture(scope="module")
def trace_pair():
    """(JAX outputs, plain outputs, near-specular lanes) on identical
    inputs."""
    jscene = j_build(tiny_scene(), pad_to=1)
    ref = jax_trace(jscene, 0)
    scene = port_scene(jscene)
    env, carry = port_inputs(0)
    got = cw.trace_plain(scene, env, carry)
    _, _, nee_u, nee_v, _ = envmap.sample_alias_index(rng.from_bits(carry["state"]), env)
    nd = envmap.equirect_uv_to_direction(nee_u, nee_v)
    attrs = intersect.trace_attrs(scene, *(carry[k] for k in ("ro0", "ro1", "ro2", "rd0", "rd1", "rd2")),
                                  *nd)
    specular = attrs["did_hit"].numpy() & (attrs["rough"].numpy() ** 2 < SPECULAR_ALPHA)
    return ref, got, specular


def test_tiny_scene_exercises_every_winner(trace_pair):
    _, got, specular = trace_pair
    hit = got["hit"].numpy()
    assert 0.05 < specular.mean() < 0.5
    assert 0.2 < hit.mean() < 0.95
    assert got["occ"].numpy().any() and not got["occ"].numpy().all()
    assert (got["er"].numpy() > 0).any()  # the emissive triangle is hit


@pytest.mark.parametrize("name", cw.TRACE_OUT_NAMES + ("qidx",))
def test_trace_plain_matches_pallas(trace_pair, name):
    """Each output against JAX's; "qidx": the row the port read is the
    row at the Pallas kernel's quad index."""
    ref, got, specular = trace_pair
    same_hit = got["hit"].numpy() == ref["hit"].numpy()
    if name == "qidx":
        env, _ = port_inputs(0)
        rows = env.quad.numpy()[ref["qidx"].numpy()]
        differ = (got["quad"].numpy() != rows).any(-1)
        assert not differ[same_hit].any(), f"{differ[same_hit].sum()} lanes differ"
        return
    a, b = got[name].numpy(), ref[name].numpy()
    assert a.shape == b.shape and a.shape[0] == N
    if name in ("nee_pmf", "quad"):
        differ = (a.view(np.int32) != b.view(np.int32)).reshape(N, -1).any(-1)
        where = slice(None) if name == "nee_pmf" else same_hit
        assert not differ[where].any(), f"{differ[where].sum()} lanes differ"
    if name in cw.TRACE_INT_NAMES:
        assert a.dtype == np.int32
        equal = (a == b).reshape(N, -1).all(-1)
        assert equal.mean() >= INT_EQUAL_MIN, f"{(~equal).sum()} lanes differ"
        return
    if name in SPECULAR_SENSITIVE:
        a, b = a[~specular], b[~specular]
    close = np.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
    assert close.mean() >= FLOAT_CLOSE_MIN, f"{(~close).sum()} lanes differ"


def test_alias_draw_bitwise(trace_pair):
    """The alias index of the plain glue is JAX's on every lane, and so is
    the NEE uv (fu, fv) on the lanes where both hit."""
    ref, got, _ = trace_pair
    env, carry = port_inputs(0)
    _, index, nee_u, nee_v, _ = envmap.sample_alias_index(rng.from_bits(carry["state"]), env)
    differ = index.numpy() != ref["alias_index"].numpy()
    assert not differ.any(), f"{differ.sum()} lanes differ"
    both = (got["hit"].numpy() != 0) & (ref["hit"].numpy() != 0)
    for k in ("fu", "fv"):
        differ = got[k].numpy().view(np.int32) != ref[k].numpy().view(np.int32)
        assert not differ[both].any(), f"{k}: {differ[both].sum()} lanes differ"


@pytest.mark.parametrize("channel", [0, 1, 2])
def test_specular_path_weight_matches_pallas(trace_pair, channel):
    ref, got, specular = trace_pair

    def weight(out):
        bs = out[f"bs{channel}"].numpy()[specular]
        return bs * out["cb"].numpy()[specular] / np.maximum(out["bpdf"].numpy()[specular], 1e-30)

    close = np.isclose(weight(got), weight(ref), rtol=RTOL, atol=ATOL)
    assert close.mean() >= FLOAT_CLOSE_MIN, f"{(~close).sum()} lanes differ"


def test_wrappers_on_cpu_run_plain_and_count_nothing(trace_pair):
    ref, got, _ = trace_pair
    jscene = j_build(tiny_scene(), pad_to=1)
    env, carry = port_inputs(0)
    cw.reset_launches()
    out = cw.trace_call(port_scene(jscene), env, carry)
    assert cw.LAUNCHES == {"trace": 0, "shade": 0, "env_draw": 0, "big_shade": 0}
    assert out.keys() == got.keys()
    assert all(torch.equal(out[k], got[k]) for k in out)
    equal = out["hit"].numpy() == ref["hit"].numpy()
    assert equal.mean() >= INT_EQUAL_MIN, f"{(~equal).sum()} lanes differ"


def test_house_sweep_matches_composed_trace_nee(assets_dir):
    """Plain sweep + attributes on house (72 lanes) against JAX's
    composed trace_nee: hit, point and occlusion on every lane; normals
    and materials on hit lanes (the paths fill miss lanes differently)."""
    import os

    from rsoderh_raytracing_tpu import load_scene

    scene = load_scene(os.path.join(assets_dir, "scenes", "house.toml"))
    jscene = j_build(scene)
    g = np.random.default_rng(21)
    n = 8192
    ro = (np.asarray(scene.camera.pos, np.float32)[:, None]
          + g.normal(0.0, 1.0, (3, n))).astype(np.float32)
    rd = g.normal(size=(3, n))
    rd = (rd / np.linalg.norm(rd, axis=0)).astype(np.float32)
    nd = g.normal(size=(3, n))
    nd[1] = np.abs(nd[1])
    nd = (nd / np.linalg.norm(nd, axis=0)).astype(np.float32)

    (hit, point, normal, color, rough, metal, emission, occ) = (
        np.asarray(x) for x in j_intersect.trace_nee(
            jscene, jnp.asarray(ro.T), jnp.asarray(rd.T), jnp.asarray(nd.T)
        )
    )
    a = intersect.trace_attrs(
        port_scene(jscene), *(torch.from_numpy(x) for x in (*ro, *rd, *nd))
    )
    t_hit = a["did_hit"].numpy()
    assert 0.2 < hit.mean() < 0.95

    def share_at_least(agree, bound):
        assert agree.mean() >= bound, f"{(~agree).sum()} of {agree.size} lanes differ"

    share_at_least(t_hit == hit, INT_EQUAL_MIN)
    share_at_least(a["occ"].numpy() == occ, INT_EQUAL_MIN)
    p = np.stack([a["px"].numpy(), a["py"].numpy(), a["pz"].numpy()], -1)
    share_at_least(np.isclose(p, point, rtol=RTOL, atol=ATOL).all(-1), FLOAT_CLOSE_MIN)
    both = t_hit & hit
    nrm = np.stack([a["nx"].numpy(), a["ny"].numpy(), a["nz"].numpy()], -1)
    share_at_least(np.isclose(nrm[both], normal[both], rtol=RTOL, atol=ATOL).all(-1), FLOAT_CLOSE_MIN)
    mats = np.stack([a[k].numpy() for k in ("cr", "cg", "cb", "rough", "metal", "er", "eg", "eb")], -1)
    ref = np.concatenate([color, rough[:, None], metal[:, None], emission], -1)
    share_at_least((mats[both] == ref[both]).all(-1), INT_EQUAL_MIN)
