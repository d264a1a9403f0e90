"""The big-mesh route's sweeps on sphere windows: the port's plain
chunked sweeps against the Pallas kernels in interpret mode on a seeded
200-sphere cloud over one plane. 200 spheres pad to 256, 4 sphere
chunks, and the (empty) triangle lanes pad to one chunk of 64, as the
reference pads them. Same tile, masks and bounds as
tests/test_torch_chunked.py; here the equal-t sphere override and the
sphere windows' divided occlusion test are what is held.

The occlusion rays start just short of the closest hit (pulled back by
1e-3 of t), not on the surface: a ray that leaves a sphere from its own
surface has an exit root next to the 1e-4 epsilon, where XLA's
contracted multiply-adds and torch's separate roundings decide the test
differently (measured from the hit point: 1 of 323 masked lanes, exit
root 1.12e-4).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu.ops import pallas_intersect as pint
from rsoderh_raytracing_tpu.scene.camera import Camera
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu.scene.types import Material, PackedMeshes, Plane, Scene, Sphere
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.scene.device import FIELDS, device_scene_from_arrays

torch.set_num_threads(2)

EQUAL_MIN = 0.999
RTOL, ATOL = 1e-4, 1e-5
ROWS, LANES = 8, 128
N = ROWS * LANES


def sphere_cloud():
    g = np.random.default_rng(5)
    centres = g.uniform(-2.0, 2.0, (200, 3))
    radii = g.uniform(0.1, 0.3, 200)
    return Scene(
        materials=[Material((0.7, 0.3, 0.2), 0.5, 0.0, (0, 0, 0)),
                   Material((0.9, 0.9, 0.9), 0.05, 1.0, (0, 0, 0))],
        spheres=[Sphere(pos=tuple(c), radius=float(r), material_id=i % 2)
                 for i, (c, r) in enumerate(zip(centres, radii))],
        planes=[Plane(pos=(-4.0, -2.5, -4.0), right=(8.0, 0.0, 0.0), forward=(0.0, 0.0, 8.0),
                      material_id=0)],
        meshes=PackedMeshes(vertices=np.zeros((0, 3), np.float32),
                            normals=np.zeros((0, 3), np.float32),
                            triangles=np.zeros((0, 7), np.int32)),
        camera=Camera(pos=[0, 0, 5], yaw=0, pitch=0, fov_y=1.2),
    )


def _pallas(fn, js, o, d, mask):
    tile = lambda a: jnp.asarray(np.ascontiguousarray(a).reshape(ROWS, LANES))  # noqa: E731
    old = os.environ.get("RT_PALLAS_INTERPRET")
    os.environ["RT_PALLAS_INTERPRET"] = "1"
    try:
        out = fn(js, tuple(tile(o[:, k]) for k in range(3)), tuple(tile(d[:, k]) for k in range(3)),
                 tile(mask), sublanes=ROWS)
    finally:
        if old is None:
            del os.environ["RT_PALLAS_INTERPRET"]
        else:
            os.environ["RT_PALLAS_INTERPRET"] = old
    if isinstance(out, tuple):
        return tuple(np.asarray(x).reshape(-1) for x in out)
    return np.asarray(out).reshape(-1)


def _comps(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3))


@pytest.fixture(scope="module")
def cloud_pair():
    js = j_build(sphere_cloud())
    assert js.sph_radius.shape[0] == 256 and pint._chunk_spheres(js)
    assert pint.scene_chunk_count(js) == 5
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    g = np.random.default_rng(13)
    o = g.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    d = g.normal(0.0, 1.0, (N, 3)).astype(np.float32)
    d[:4] = [[0, 0, -1], [0, -1, 0], [1, 0, 0], [0, 1, 0]]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    live = (g.random(N) < 0.8).astype(np.int32)
    ref = _pallas(pint.chunked_closest_tiles, js, o, d, live)
    got = tuple(x.numpy() for x in intersect.chunked_closest_plain(
        ts, _comps(o), _comps(d), torch.from_numpy(live)))
    t = np.where(ref[1] >= 0, ref[0] * np.float32(0.999), 0.0).astype(np.float32)
    p = (o + d * t[:, None]).astype(np.float32)
    s = g.normal(0.0, 1.0, (N, 3)).astype(np.float32)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    hit_mask = ((ref[1] >= 0) & (live != 0)).astype(np.int32)
    ref_occ = _pallas(pint.chunked_any_tiles, js, p, s, hit_mask)
    got_occ = intersect.chunked_any_plain(ts, _comps(p), _comps(s), torch.from_numpy(hit_mask)).numpy()
    return dict(live=live, hit_mask=hit_mask, ref=ref, got=got, ref_occ=ref_occ, got_occ=got_occ)


def test_cloud_rays_hit_spheres_and_plane(cloud_pair):
    types = cloud_pair["got"][1][cloud_pair["live"] != 0]
    assert {-1, 0, 1} <= set(types.tolist())
    occ = cloud_pair["got_occ"][cloud_pair["hit_mask"] != 0]
    assert 0.05 < occ.mean() < 0.95


@pytest.mark.parametrize("out", ["t", "type", "index"])
def test_sphere_windows_closest_matches_pallas(cloud_pair, out):
    live = cloud_pair["live"] != 0
    k = ("t", "type", "index").index(out)
    a, b = cloud_pair["got"][k][live], cloud_pair["ref"][k][live]
    if out == "t":
        assert np.isclose(a, b, rtol=RTOL, atol=ATOL).mean() >= EQUAL_MIN
    else:
        assert (a == b).mean() >= EQUAL_MIN, f"{(a != b).sum()} lanes differ"


def test_sphere_windows_any_matches_pallas(cloud_pair):
    masked = cloud_pair["hit_mask"] != 0
    a, b = cloud_pair["got_occ"][masked], cloud_pair["ref_occ"][masked]
    assert (a == b).mean() >= EQUAL_MIN, f"{(a != b).sum()} lanes differ"
