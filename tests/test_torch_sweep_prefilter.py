"""The sweep's division-free pre-test (csrc/wavefront_common.cuh:sweep)
never rejects a primitive that the exact test accepts.

The CUDA sweep of TRACE, FUSED, CLOSEST and ANY runs a primitive's
divisions, square root and exact test only where the pre-test holds, so
its hits stay those of the exact test only if the pre-test holds wherever
the exact test does. ``intersect.prefilter_hits`` is the pre-test in plain
tensor code, with the kernel's constants (checked here against the CUDA
source); IEEE +, -, *, / and sqrt round alike on the CPU and on the card,
so these comparisons against the exact test (``intersect._hits``) hold
there too. The rays: seeded rays on house and on a one-sphere,
one-plane, one-triangle scene, and rays built to sit on each boundary of
the exact test: u = 0, v = 0 and u + v = 1 (the three edges), t at
TRI_T_EPS, |det| at TRI_DET_EPS, tangent spheres (disc = 0) and grazing
planes (|denom| at PLANE_DENOM_EPS, the origin on the plane). Each edge
family must straddle its boundary (some lanes hit, some miss) and no lane
may pass the exact test and fail the pre-test.
"""

import os
import re

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.scene.camera import Camera
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene
from rsoderh_raytracing_tpu_torch.scene.types import Material, PackedMeshes, Plane, Scene, Sphere

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUH = os.path.join(ROOT, "rsoderh_raytracing_tpu_torch", "csrc", "wavefront_common.cuh")
N = 20000
KINDS = {"sphere": intersect.SPHERE, "plane": intersect.PLANE, "triangle": intersect.TRIANGLE}

TRI = np.array([[-0.7, -0.4, -2.1], [0.9, -0.2, -2.6], [0.1, 0.8, -2.3]], np.float32)
SPH_C, SPH_R = np.array([0.3, 0.1, -4.0], np.float32), 1.25
PLN_POS = np.array([-2.0, -1.0, -6.0], np.float32)
PLN_RIGHT = np.array([4.0, 0.3, 0.0], np.float32)
PLN_FORWARD = np.array([0.0, 0.2, 4.0], np.float32)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def edge_scene():
    """One slanted triangle, one sphere and one slanted plane."""
    scene = Scene(
        materials=[Material((0.5, 0.5, 0.5), 0.5, 0.0, (0, 0, 0))],
        spheres=[Sphere(pos=SPH_C, radius=SPH_R, material_id=0)],
        planes=[Plane(pos=PLN_POS, right=PLN_RIGHT, forward=PLN_FORWARD, material_id=0)],
        meshes=PackedMeshes(vertices=TRI, normals=np.tile(_unit(np.cross(TRI[1] - TRI[0], TRI[2] - TRI[0])), (3, 1)),
                            triangles=np.array([[0, 1, 2, 0, 1, 2, 0]], np.int32)),
        camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=1.0),
    )
    return build_device_scene(scene, device="cpu", pad_to=1)


def _masks(scene, kind, o, d):
    """(exact hit, pre-test) of rays o + t d, (n, 3) float32 each, against
    every primitive of `kind`: (n, k) bool each."""
    r = intersect._ray_terms(*(torch.from_numpy(np.ascontiguousarray(a[:, k], np.float32))
                               for a in (o, d) for k in range(3)))
    k = intersect._n_prims(scene, kind)
    return intersect._hits(scene, kind, 0, k, r)[1], intersect.prefilter_hits(scene, kind, 0, k, r)


def _assert_sound(exact, pre, straddle=True):
    missed = exact & ~pre
    assert not bool(missed.any()), f"the pre-test rejects {int(missed.sum())} exact hits"
    if straddle:
        assert bool(exact.any()) and not bool(exact.all()), (
            f"{int(exact.sum())} of {exact.numel()} pairs hit: the rays do not straddle the boundary")


def test_constants_are_the_kernels():
    """prefilter_hits uses the CUDA source's TRI_PRE_* constants, and the t
    floor lies below TRI_T_EPS by more than the divided test's roundings."""
    src = open(CUH).read()
    consts = {m.group(1): float.fromhex(m.group(2)) for m in
              re.finditer(r"constexpr float (TRI_PRE_\w+) = (0x[0-9a-fA-Fp.+-]+)f;", src)}
    assert consts == {"TRI_PRE_MARGIN": intersect.TRI_PRE_MARGIN, "TRI_PRE_ONE": intersect.TRI_PRE_ONE,
                      "TRI_PRE_T_EPS": intersect.TRI_PRE_T_EPS}
    eps = 2.0**-24
    assert np.float32(intersect.TRI_PRE_T_EPS) == intersect.TRI_PRE_T_EPS
    assert intersect.TRI_PRE_T_EPS < float(np.float32(intersect.TRI_T_EPS)) * (1 - 8 * eps)
    assert intersect.TRI_PRE_MARGIN >= 8 * eps and intersect.TRI_PRE_ONE - 1 >= 8 * eps


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_house_seeded_rays(assets_dir, kind):
    """Camera-like rays and incoherent rays from around the house."""
    scene = build_device_scene(load_scene(os.path.join(assets_dir, "scenes", "house.toml")), device="cpu")
    g = np.random.default_rng(31)
    cam = np.asarray(load_scene(os.path.join(assets_dir, "scenes", "house.toml")).camera.pos, np.float32)
    o = np.concatenate([np.tile(cam, (N // 2, 1)), cam + g.normal(0.0, 3.0, (N // 2, 3))]).astype(np.float32)
    d = _unit(g.normal(size=(N, 3))).astype(np.float32)
    exact, pre = _masks(scene, KINDS[kind], o, d)
    _assert_sound(exact, pre)
    assert float(pre.double().mean()) < 0.5, "the pre-test passes most pairs"


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_edge_scene_seeded_rays(edge_scene, kind):
    g = np.random.default_rng(32)
    o = g.normal(0.0, 1.0, (N, 3)).astype(np.float32)
    target = g.normal(0.0, 2.0, (N, 3)) + np.array([0.0, 0.0, -3.5])
    d = _unit(target - o).astype(np.float32)
    _assert_sound(*_masks(edge_scene, KINDS[kind], o, d))


def _nudge(g, shape, scale):
    """Offsets of a few ulps to a few thousand: scale * k * 2^-23, k
    from a symmetric log range."""
    k = np.exp(g.uniform(0.0, np.log(4096.0), shape)) * g.choice([-1.0, 1.0], shape)
    return scale * k * 2.0**-23


@pytest.mark.parametrize("edge", ["ab", "ac", "bc"])
def test_triangle_edge_rays(edge_scene, edge):
    """Rays through points on one edge of the triangle, nudged across it:
    v = 0 (a-b), u = 0 (a-c) and u + v = 1 (b-c)."""
    g = np.random.default_rng(40 + "ab ac bc".split().index(edge))
    p0, p1 = TRI["abc".index(edge[0])], TRI["abc".index(edge[1])]
    normal = _unit(np.cross(TRI[1] - TRI[0], TRI[2] - TRI[0]))
    across = _unit(np.cross(normal, p1 - p0))
    s = g.uniform(0.0, 1.0, (N, 1))
    p = p0 + s * (p1 - p0) + across * _nudge(g, (N, 1), 1.0)
    d = _unit(g.normal(size=(N, 3)) * 0.4 - normal)
    o = (p - g.uniform(0.5, 3.0, (N, 1)) * d).astype(np.float32)
    _assert_sound(*_masks(edge_scene, intersect.TRIANGLE, o, d.astype(np.float32)))


def test_triangle_t_at_its_epsilon(edge_scene):
    """Origins at t = TRI_T_EPS before a point inside the triangle."""
    g = np.random.default_rng(43)
    w = g.dirichlet([1.0, 1.0, 1.0], N)
    p = w @ TRI
    normal = _unit(np.cross(TRI[1] - TRI[0], TRI[2] - TRI[0]))
    d = _unit(g.normal(size=(N, 3)) * 0.5 - normal)
    t = intersect.TRI_T_EPS * (1.0 + _nudge(g, (N, 1), 8.0e4))
    o = (p - t * d).astype(np.float32)
    _assert_sound(*_masks(edge_scene, intersect.TRIANGLE, o, d.astype(np.float32)))


def test_triangle_t_ulp_scan():
    """Triangles in the plane z = 0 of sizes that are no powers of two, and
    rays straight down from every float height within 300 ulps of
    TRI_T_EPS: t lands on its bound with every rounding of T / |det|."""
    g = np.random.default_rng(47)
    k = 16
    size = g.uniform(0.3, 3.0, (k, 2))
    corner = g.uniform(-5.0, 5.0, (k, 2))
    verts = np.zeros((k, 3, 3), np.float32)
    verts[:, :, :2] = corner[:, None, :]
    verts[:, 1, 0] += size[:, 0]
    verts[:, 2, 1] += size[:, 1]
    scene = build_device_scene(Scene(
        materials=[Material((0.5, 0.5, 0.5), 0.5, 0.0, (0, 0, 0))], spheres=[], planes=[],
        meshes=PackedMeshes(vertices=verts.reshape(-1, 3), normals=np.tile([[0.0, 0.0, 1.0]], (3 * k, 1)),
                            triangles=np.array([[3 * i, 3 * i + 1, 3 * i + 2] * 2 + [0] for i in range(k)],
                                               np.int32)),
        camera=Camera(pos=[0, 0, 1], yaw=0, pitch=0, fov_y=1.0),
    ), device="cpu", pad_to=1)
    heights = np.float32(intersect.TRI_T_EPS) + np.arange(-300, 301) * np.spacing(np.float32(1e-5))
    xy = corner + size * 0.25
    o = np.zeros((k, heights.size, 3), np.float32)
    o[:, :, :2] = xy[:, None, :]
    o[:, :, 2] = heights[None, :]
    o = o.reshape(-1, 3)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (o.shape[0], 1))
    exact, pre = _masks(scene, intersect.TRIANGLE, o, d)
    lane_tri = np.repeat(np.arange(k), heights.size)
    own = torch.from_numpy(np.arange(k)[None, :] == lane_tri[:, None])
    _assert_sound(exact & own, pre & own)


def test_triangle_det_at_its_epsilon(edge_scene):
    """Directions almost in the triangle's plane: |det| around TRI_DET_EPS."""
    g = np.random.default_rng(44)
    cdet = edge_scene.tri_cdet[0].numpy().astype(np.float64)
    n_hat = _unit(cdet)
    in_plane = _unit(np.cross(n_hat, g.normal(size=(N, 3))))
    det = intersect.TRI_DET_EPS * np.exp(g.uniform(-1.0, 1.0, (N, 1))) * g.choice([-1.0, 1.0], (N, 1))
    d = _unit(in_plane + n_hat * det / np.linalg.norm(cdet))
    p = g.dirichlet([1.0, 1.0, 1.0], N) @ TRI
    o = (p - g.uniform(0.1, 2.0, (N, 1)) * d).astype(np.float32)
    d = d.astype(np.float32)
    r = intersect._ray_terms(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (o, d) for k in range(3)))
    got = intersect._tri_numerators(edge_scene, 0, 1, r)[0].abs()
    assert bool((got < intersect.TRI_DET_EPS).any()) and bool((got >= intersect.TRI_DET_EPS).any())
    _assert_sound(*_masks(edge_scene, intersect.TRIANGLE, o, d), straddle=False)


def test_sphere_tangent_rays(edge_scene):
    """Rays passing the sphere at its radius (disc = 0), nudged in and out."""
    g = np.random.default_rng(45)
    d = _unit(g.normal(size=(N, 3)))
    w = _unit(np.cross(d, g.normal(size=(N, 3))))
    offset = SPH_R * (1.0 + _nudge(g, (N, 1), 1.0))
    o = (SPH_C + w * offset - g.uniform(2.0, 5.0, (N, 1)) * d).astype(np.float32)
    _assert_sound(*_masks(edge_scene, intersect.SPHERE, o, d.astype(np.float32)))


@pytest.mark.parametrize("case", ["denominator", "origin_on_plane"])
def test_grazing_plane_rays(edge_scene, case):
    """Directions with |d . n| around PLANE_DENOM_EPS, or origins within a
    few ulps of the plane (the t numerator's sign)."""
    g = np.random.default_rng(46 + (case == "origin_on_plane"))
    n_hat = _unit(np.cross(PLN_FORWARD, PLN_RIGHT).astype(np.float64))
    inside = PLN_POS + g.uniform(0.0, 1.0, (N, 1)) * PLN_RIGHT + g.uniform(0.0, 1.0, (N, 1)) * PLN_FORWARD
    if case == "denominator":
        denom = intersect.PLANE_DENOM_EPS * (1.0 + _nudge(g, (N, 1), 1.0)) * g.choice([-1.0, 1.0], (N, 1))
        d = _unit(_unit(np.cross(n_hat, g.normal(size=(N, 3)))) + n_hat * denom)
        o = inside - g.uniform(0.1, 2.0, (N, 1)) * d
    else:
        d = _unit(g.normal(size=(N, 3)))
        o = inside + n_hat * _nudge(g, (N, 1), 4.0)
        o = o - d * intersect.PLANE_T_EPS * g.uniform(0.0, 2.0, (N, 1))
    _assert_sound(*_masks(edge_scene, intersect.PLANE, o.astype(np.float32), d.astype(np.float32)))
