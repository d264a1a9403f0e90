"""TRACE: the port's trace_plain against the Pallas trace_call, and the
plain sweep on house against JAX's composed trace_nee.

The Pallas kernel runs in interpret mode on the CPU
(RT_PALLAS_INTERPRET=1, as tests/test_wavefront.py runs it) on a tiny
scene (one sphere, one plane, one triangle, pad_to=1) and one 32x128
tile of seeded rays. House is compared through JAX's composed path,
which on the CPU is plain XLA.

Tolerances: torch and XLA round sqrt, sin and cos differently, and XLA
contracts multiply-adds into FMAs (ROADMAP queue 3), so float outputs are
compared with isclose(rtol=1e-4, atol=1e-5) and a grazing ray may flip a
hit or an occlusion. Integer outputs must agree on >= 99.9% of lanes and
floats be close on >= 99.5%.

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

from rsoderh_raytracing_tpu.ops import intersect as j_intersect
from rsoderh_raytracing_tpu.ops import pallas_wavefront as pwf
from rsoderh_raytracing_tpu.scene.camera import Camera
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu.scene.types import Material, PackedMeshes, Plane, Scene, Sphere
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import intersect
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


def seeded_inputs(seed):
    g = np.random.default_rng(seed)
    ro = g.normal(0.0, 0.3, (3, N)).astype(np.float32)
    rd = np.stack([g.uniform(-0.9, 0.9, N), g.uniform(-0.8, 0.5, N), -np.ones(N)])
    rd = (rd / np.linalg.norm(rd, axis=0)).astype(np.float32)
    nd = g.normal(size=(3, N))
    nd[1] = np.abs(nd[1])
    nd = (nd / np.linalg.norm(nd, axis=0)).astype(np.float32)
    nee_uv = g.random((2, N), dtype=np.float32)
    miss_uv = g.random((2, N), dtype=np.float32)
    miss_uv[:, :4] = [[0.0, 1.0, -8.4e-7, 1.0000008], [0.0, 1.0, 0.5, 0.5]]
    state = g.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return ro, rd, nd, nee_uv, miss_uv, state


@pytest.fixture(scope="module")
def trace_pair():
    """(pallas outputs, plain outputs) on identical inputs."""
    import os

    jscene = j_build(tiny_scene(), pad_to=1)
    ro, rd, nd, nee_uv, miss_uv, state = seeded_inputs(0)

    def tiles(a):
        return tuple(jnp.asarray(x.reshape(ROWS, LANES)) for x in a)

    old = os.environ.get("RT_PALLAS_INTERPRET")
    os.environ["RT_PALLAS_INTERPRET"] = "1"
    try:
        ref = pwf.trace_call(
            jscene, ENV_W, ENV_H, tiles(ro), tiles(rd), tiles(nd), tiles(nee_uv),
            tiles(miss_uv), jnp.asarray(state.reshape(ROWS, LANES)),
        )
    finally:
        if old is None:
            del os.environ["RT_PALLAS_INTERPRET"]
        else:
            os.environ["RT_PALLAS_INTERPRET"] = old
    ref = cw.tiles_to_flat({k: np.asarray(v) for k, v in ref.items()})

    def flat(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)

    scene = port_scene(jscene)
    got = cw.trace_plain(
        scene, ENV_W, ENV_H, flat(ro), flat(rd), flat(nd), flat(nee_uv),
        flat(miss_uv), torch.from_numpy(state.view(np.int32)),
    )
    attrs = intersect.trace_attrs(scene, *flat(ro), *flat(rd), *flat(nd))
    specular = attrs["did_hit"].numpy() & (attrs["rough"].numpy() ** 2 < SPECULAR_ALPHA)
    return ref, got, specular


def test_tiny_scene_exercises_every_winner(trace_pair):
    _, got, specular = trace_pair
    hit = got["hit"].numpy()
    assert 0.05 < specular.mean() < 0.5
    assert 0.2 < hit.mean() < 0.95
    assert got["occ"].numpy().any() and not got["occ"].numpy().all()
    assert (got["er"].numpy() > 0).any()  # the emissive triangle is hit


@pytest.mark.parametrize("name", cw.TRACE_OUT_NAMES)
def test_trace_plain_matches_pallas(trace_pair, name):
    ref, got, specular = trace_pair
    a, b = got[name].numpy(), ref[name].numpy()
    assert a.shape == b.shape == (N,)
    if name in ("hit", "occ", "bz", "qidx", "state"):
        assert a.dtype == np.int32
        assert (a == b).mean() >= INT_EQUAL_MIN, f"{(a != b).sum()} lanes differ"
        return
    if name in SPECULAR_SENSITIVE:
        a, b = a[~specular], b[~specular]
    close = np.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
    assert close.mean() >= FLOAT_CLOSE_MIN, f"{(~close).sum()} lanes differ"


@pytest.mark.parametrize("channel", [0, 1, 2])
def test_specular_path_weight_matches_pallas(trace_pair, channel):
    ref, got, specular = trace_pair

    def weight(out):
        bs = out[f"bs{channel}"].numpy()[specular]
        return bs * out["cb"].numpy()[specular] / np.maximum(out["bpdf"].numpy()[specular], 1e-30)

    close = np.isclose(weight(got), weight(ref), rtol=RTOL, atol=ATOL)
    assert close.mean() >= FLOAT_CLOSE_MIN, f"{(~close).sum()} lanes differ"


def test_wrappers_on_cpu_run_plain_and_count_nothing(trace_pair):
    ref, _, _ = trace_pair
    jscene = j_build(tiny_scene(), pad_to=1)
    ro, rd, nd, nee_uv, miss_uv, state = seeded_inputs(0)

    def flat(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)

    cw.reset_launches()
    out = cw.trace_call(
        port_scene(jscene), ENV_W, ENV_H, flat(ro), flat(rd), flat(nd), flat(nee_uv),
        flat(miss_uv), torch.from_numpy(state.view(np.int32)),
    )
    assert cw.LAUNCHES == {"trace": 0, "shade": 0, "big_shade": 0}
    assert (out["hit"].numpy() == ref["hit"].numpy()).mean() >= INT_EQUAL_MIN


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
    assert (t_hit == hit).mean() >= INT_EQUAL_MIN
    assert (a["occ"].numpy() == occ).mean() >= INT_EQUAL_MIN
    p = np.stack([a["px"].numpy(), a["py"].numpy(), a["pz"].numpy()], -1)
    assert np.isclose(p, point, rtol=RTOL, atol=ATOL).all(-1).mean() >= FLOAT_CLOSE_MIN
    both = t_hit & hit
    nrm = np.stack([a["nx"].numpy(), a["ny"].numpy(), a["nz"].numpy()], -1)
    assert np.isclose(nrm[both], normal[both], rtol=RTOL, atol=ATOL).all(-1).mean() >= FLOAT_CLOSE_MIN
    mats = np.stack([a[k].numpy() for k in ("cr", "cg", "cb", "rough", "metal", "er", "eg", "eb")], -1)
    ref = np.concatenate([color, rough[:, None], metal[:, None], emission], -1)
    assert (mats[both] == ref[both]).all(-1).mean() >= INT_EQUAL_MIN
