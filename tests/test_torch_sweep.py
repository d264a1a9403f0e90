"""CLOSEST, ANY and FUSED: the port's plain sweeps against the Pallas
kernels, and the scene-level queries against JAX's composed forms.

The Pallas kernels (pallas_intersect.closest_sweep, any_sweep,
fused_trace) run in interpret mode on the CPU (RT_PALLAS_INTERPRET=1) on
the tiny scene of test_torch_trace.py (one sphere, one plane, one
triangle, pad_to=1) and one 64x128 tile of seeded rays. The queries
closest_hit, any_hit and trace_nee are compared on house through JAX's
composed path, which on the CPU is plain XLA, and closest_hit and any_hit
on the 200-triangle wall of conftest's big_tri_scene, where the port
takes its chunked route.

Tolerances as in test_torch_trace.py: torch and XLA round sqrt
differently and XLA contracts multiply-adds into FMAs (ROADMAP queue 3),
so a grazing ray may flip a hit. Integer outputs must agree on >= 99.9%
of lanes, floats be isclose(rtol=1e-4, atol=1e-5) on >= 99.5%. Normals
and materials are compared on lanes where both sides hit the same way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu.ops import intersect as j_intersect
from rsoderh_raytracing_tpu.ops import pallas_intersect as pint
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.scene.device import CHUNKED, SMALL, route
from test_torch_trace import port_scene, tiny_scene

torch.set_num_threads(2)

INT_EQUAL_MIN = 0.999
FLOAT_CLOSE_MIN = 0.995
RTOL, ATOL = 1e-4, 1e-5
N = 64 * 128
CLOSEST_NAMES = ("t", "type", "index")
FUSED_INTS = ("did_hit", "occ")


def seeded_rays(seed, n=N, spread=0.3, origin=(0.0, 0.0, 0.0)):
    g = np.random.default_rng(seed)
    ro = (np.asarray(origin, np.float32)[:, None] + g.normal(0.0, spread, (3, n))).astype(np.float32)
    rd = np.stack([g.uniform(-0.9, 0.9, n), g.uniform(-0.8, 0.5, n), -np.ones(n)])
    rd = (rd / np.linalg.norm(rd, axis=0)).astype(np.float32)
    nd = g.normal(size=(3, n))
    nd[1] = np.abs(nd[1])
    nd = (nd / np.linalg.norm(nd, axis=0)).astype(np.float32)
    return ro, rd, nd


def comps(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)


def as_numpy(outputs):
    return {k: np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()
            for k, v in outputs.items()}


def agree(got, ref, integer):
    """Share of lanes on which got and ref agree."""
    if integer:
        return (np.asarray(got).astype(np.int64) == np.asarray(ref).astype(np.int64)).mean()
    return np.isclose(got, ref, rtol=RTOL, atol=ATOL, equal_nan=True).mean()


@pytest.fixture(scope="module")
def sweep_pair():
    """{kernel: (Pallas outputs, plain outputs)} on identical inputs."""
    jscene = j_build(tiny_scene(), pad_to=1)
    scene = port_scene(jscene)
    ro, rd, nd = seeded_rays(0)
    jro, jrd, jnd = (jnp.asarray(x.T) for x in (ro, rd, nd))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RT_PALLAS_INTERPRET", "1")
        j_closest = pint.closest_sweep(jscene, jro, jrd)
        j_fused = pint.fused_trace(jscene, jro, jrd, jnd)
        # occlusion rays start at the hit points, as the integrators call it
        j_any = pint.any_sweep(jscene, j_fused[1], jnd)
    hit, point, normal, color, rough, metal, emission, occ = (np.asarray(x) for x in j_fused)
    fused_ref = dict(
        did_hit=hit, px=point[:, 0], py=point[:, 1], pz=point[:, 2],
        nx=normal[:, 0], ny=normal[:, 1], nz=normal[:, 2],
        cr=color[:, 0], cg=color[:, 1], cb=color[:, 2], rough=rough, metal=metal,
        er=emission[:, 0], eg=emission[:, 1], eb=emission[:, 2], occ=occ,
    )
    fused_got = as_numpy(intersect.trace_attrs(scene, *comps(ro), *comps(rd), *comps(nd)))
    # the port's occlusion sweep starts at the reference's points, so the
    # comparison is of the sweep alone
    any_got = intersect.any_sweep(scene, *comps(point.T.copy()), *comps(nd)).numpy()
    return {
        "closest": (dict(zip(CLOSEST_NAMES, (np.asarray(x) for x in j_closest))),
                    as_numpy(dict(zip(CLOSEST_NAMES, intersect.closest_sweep(scene, *comps(ro), *comps(rd)))))),
        "any": ({"occ": np.asarray(j_any)}, {"occ": any_got}),
        "fused": (fused_ref, fused_got),
    }


def test_tiny_scene_exercises_the_sweeps(sweep_pair):
    ref, got = sweep_pair["closest"]
    assert set(np.unique(got["type"])) == {-1, 0, 1, 2}
    assert (got["t"][got["type"] < 0] == np.float32(3.0e38)).all()
    assert (got["index"][got["type"] < 0] == 0).all()
    occ = sweep_pair["any"][1]["occ"]
    assert occ.any() and not occ.all()


@pytest.mark.parametrize("name", CLOSEST_NAMES)
def test_closest_plain_matches_pallas(sweep_pair, name):
    ref, got = sweep_pair["closest"]
    assert got[name].shape == ref[name].shape == (N,)
    assert got[name].dtype == ref[name].dtype
    share = agree(got[name], ref[name], name != "t")
    assert share >= (INT_EQUAL_MIN if name != "t" else FLOAT_CLOSE_MIN), f"{share:.5f}"


def test_any_plain_matches_pallas(sweep_pair):
    ref, got = sweep_pair["any"]
    assert got["occ"].dtype == np.bool_
    assert agree(got["occ"], ref["occ"], True) >= INT_EQUAL_MIN


@pytest.mark.parametrize("name", ci.FUSED_OUT_NAMES)
def test_fused_plain_matches_pallas(sweep_pair, name):
    """Every lane, miss lanes too: they hold the ray origin as point and
    row 0's normal and material, like the reference's selects."""
    ref, got = sweep_pair["fused"]
    assert got[name].shape == ref[name].shape == (N,)
    if name in FUSED_INTS:
        assert agree(got[name], ref[name], True) >= INT_EQUAL_MIN
        return
    assert agree(got[name], ref[name], False) >= FLOAT_CLOSE_MIN


def test_wrappers_on_cpu_run_plain_and_count_nothing():
    scene = port_scene(j_build(tiny_scene(), pad_to=1))
    ro, rd, nd = (comps(x) for x in seeded_rays(1, n=512))
    ci.reset_launches()
    closest = ci.closest_call(scene, ro, rd)
    occ = ci.any_call(scene, ro, rd)
    fused = ci.fused_call(scene, ro, rd, nd)
    assert set(ci.LAUNCHES.values()) == {0}
    for a, b in zip(closest, intersect.closest_sweep(scene, *ro, *rd)):
        assert torch.equal(a, b)
    assert torch.equal(occ, intersect.any_sweep(scene, *ro, *rd))
    ref = intersect.trace_attrs(scene, *ro, *rd, *nd)
    assert fused.keys() == ref.keys() == set(ci.FUSED_OUT_NAMES)
    assert all(torch.equal(fused[k], ref[k]) for k in ref)


@pytest.fixture(scope="module", params=["house", "wall"])
def query_pair(request, house_scene, big_tri_scene):
    """closest_hit, any_hit and trace_nee of both packages on a scene of
    the small route (house) and one of the chunked route (the wall)."""
    scene = house_scene if request.param == "house" else big_tri_scene
    jscene = j_build(scene)
    tscene = port_scene(jscene)
    assert route(tscene) == (SMALL if request.param == "house" else CHUNKED)
    ro, rd, nd = seeded_rays(21, n=4096, spread=0.5, origin=scene.camera.pos)
    jro, jrd, jnd = (jnp.asarray(x.T) for x in (ro, rd, nd))
    jhit = j_intersect.closest_hit(jscene, jro, jrd)
    jocc = j_intersect.any_hit(jscene, jhit.point, jnd)
    jnee = j_intersect.trace_nee(jscene, jro, jrd, jnd)
    thit = intersect.closest_hit(tscene, comps(ro), comps(rd))
    tocc = intersect.any_hit(tscene, comps(np.asarray(jhit.point).T.copy()), comps(nd))
    tnee = intersect.trace_nee(tscene, comps(ro), comps(rd), comps(nd))

    def stack(v):
        return torch.stack(v, dim=-1).numpy() if isinstance(v, tuple) else v.numpy()

    ref = dict(
        did_hit=jhit.did_hit, distance=jhit.distance, point=jhit.point, normal=jhit.normal,
        material_id=jhit.material_id, any_hit=jocc,
        **{f"nee_{k}": v for k, v in zip(
            ("did_hit", "point", "normal", "color", "rough", "metal", "emission", "occ"), jnee)},
    )
    got = dict(
        did_hit=thit.did_hit, distance=thit.distance, point=thit.point, normal=thit.normal,
        material_id=thit.material_id, any_hit=tocc,
        **{f"nee_{k}": v for k, v in zip(
            ("did_hit", "point", "normal", "color", "rough", "metal", "emission", "occ"), tnee)},
    )
    both = np.asarray(jhit.did_hit) & thit.did_hit.numpy()
    return {k: np.asarray(v) for k, v in ref.items()}, {k: stack(v) for k, v in got.items()}, both


QUERY_FIELDS = (
    "did_hit", "distance", "point", "normal", "material_id", "any_hit",
    "nee_did_hit", "nee_point", "nee_normal", "nee_color", "nee_rough", "nee_metal",
    "nee_emission", "nee_occ",
)
# Filled from row 0 on a miss by both packages, but through different
# paths; compared on lanes both sides hit.
HIT_LANES_ONLY = {"normal", "material_id", "nee_normal", "nee_color", "nee_rough", "nee_metal",
                  "nee_emission"}


@pytest.mark.parametrize("field", QUERY_FIELDS)
def test_scene_queries_match_jax(query_pair, field):
    ref, got, both = query_pair
    assert 0.2 < ref["did_hit"].mean() < 0.98
    a, b = got[field], ref[field]
    assert a.shape == b.shape
    if field in HIT_LANES_ONLY:
        a, b = a[both], b[both]
    integer = a.dtype.kind in "bi"
    lanes = (a == b) if integer else np.isclose(a, b, rtol=RTOL, atol=ATOL)
    if lanes.ndim == 2:
        lanes = lanes.all(-1)
    assert lanes.mean() >= (INT_EQUAL_MIN if integer else FLOAT_CLOSE_MIN), f"{(~lanes).sum()} lanes differ"
