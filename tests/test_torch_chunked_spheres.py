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


# -- the model of the CUDA kernels' traversal on sphere windows -----------------
# intersect.chunked_*_model against the plain versions (bit-equal on every
# lane, t by its bits) and against the Pallas kernels (the bounds above, on
# live or masked lanes): batches of 1 chunk, of 2 (the 5 chunks end on a
# ragged batch that mixes nothing: chunk 0 is the empty triangle window) and
# of 8 (one batch), every lane live, the seeded mask and no lane live.

BATCHES = (1, 2, 8)
MASKS = ("all_live", "mixed", "all_dead")


def _cloud_inputs():
    """The scenes and rays of cloud_pair (same seeds)."""
    js = j_build(sphere_cloud())
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    g = np.random.default_rng(13)
    o = g.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    d = g.normal(0.0, 1.0, (N, 3)).astype(np.float32)
    d[:4] = [[0, 0, -1], [0, -1, 0], [1, 0, 0], [0, 1, 0]]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g.random(N)  # cloud_pair's live mask
    return js, ts, o, d, g


@pytest.fixture(scope="module")
def cloud_inputs(cloud_pair):
    js, ts, o, d, g = _cloud_inputs()
    ref = cloud_pair["ref"]
    t = np.where(ref[1] >= 0, ref[0] * np.float32(0.999), 0.0).astype(np.float32)
    p = (o + d * t[:, None]).astype(np.float32)
    s = g.normal(0.0, 1.0, (N, 3)).astype(np.float32)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    return dict(js=js, ts=ts, o=o, d=d, p=p, s=s, live=cloud_pair["live"], hit_mask=cloud_pair["hit_mask"])


@pytest.fixture(scope="module")
def cloud_all_live(cloud_inputs):
    """Pallas closest and occlusion with every lane live."""
    c, ones = cloud_inputs, np.ones(N, np.int32)
    return (_pallas(pint.chunked_closest_tiles, c["js"], c["o"], c["d"], ones),
            _pallas(pint.chunked_any_tiles, c["js"], c["p"], c["s"], ones))


def _mask(kind, seeded):
    return {"all_live": np.ones(N, np.int32), "mixed": seeded, "all_dead": np.zeros(N, np.int32)}[kind]


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_cloud_inputs_repeat_the_pair(cloud_inputs, cloud_pair):
    c = cloud_inputs
    got = intersect.chunked_closest_plain(c["ts"], _comps(c["o"]), _comps(c["d"]), torch.from_numpy(c["live"]))
    for a, b in zip(got, cloud_pair["got"]):
        assert np.array_equal(a.numpy(), b)
    occ = intersect.chunked_any_plain(c["ts"], _comps(c["p"]), _comps(c["s"]), torch.from_numpy(c["hit_mask"]))
    assert np.array_equal(occ.numpy(), cloud_pair["got_occ"])


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("batch", BATCHES)
def test_sphere_closest_model_equals_plain(cloud_inputs, batch, mask_kind):
    c = cloud_inputs
    mask = torch.from_numpy(_mask(mask_kind, c["live"]))
    plain = intersect.chunked_closest_plain(c["ts"], _comps(c["o"]), _comps(c["d"]), mask)
    *got, pairs = intersect.chunked_closest_model(c["ts"], _comps(c["o"]), _comps(c["d"]), mask, batch=batch)
    for a, b in zip(got, plain):
        assert _same_bits(a, b)
    assert (pairs == 0) == (mask_kind == "all_dead")


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("batch", BATCHES)
def test_sphere_any_model_equals_plain(cloud_inputs, batch, mask_kind):
    c = cloud_inputs
    mask = torch.from_numpy(_mask(mask_kind, c["hit_mask"]))
    plain = intersect.chunked_any_plain(c["ts"], _comps(c["p"]), _comps(c["s"]), mask)
    got, pairs = intersect.chunked_any_model(c["ts"], _comps(c["p"]), _comps(c["s"]), mask, batch=batch)
    assert torch.equal(got, plain)
    assert (pairs == 0) == (mask_kind == "all_dead")


@pytest.mark.parametrize("mask_kind", MASKS[:2])
@pytest.mark.parametrize("batch", BATCHES)
def test_sphere_closest_model_matches_pallas(cloud_inputs, cloud_pair, cloud_all_live, batch, mask_kind):
    c = cloud_inputs
    mask = _mask(mask_kind, c["live"])
    ref = cloud_all_live[0] if mask_kind == "all_live" else cloud_pair["ref"]
    got = intersect.chunked_closest_model(c["ts"], _comps(c["o"]), _comps(c["d"]),
                                          torch.from_numpy(mask), batch=batch)
    live = mask != 0
    for k, out in enumerate(("t", "type", "index")):
        a, b = got[k].numpy()[live], ref[k][live]
        if out == "t":
            assert np.isclose(a, b, rtol=RTOL, atol=ATOL).mean() >= EQUAL_MIN
        else:
            assert (a == b).mean() >= EQUAL_MIN, f"{out}: {(a != b).sum()} lanes differ"


@pytest.mark.parametrize("mask_kind", MASKS[:2])
@pytest.mark.parametrize("batch", BATCHES)
def test_sphere_any_model_matches_pallas(cloud_inputs, cloud_pair, cloud_all_live, batch, mask_kind):
    c = cloud_inputs
    mask = _mask(mask_kind, c["hit_mask"])
    ref = cloud_all_live[1] if mask_kind == "all_live" else cloud_pair["ref_occ"]
    got, _ = intersect.chunked_any_model(c["ts"], _comps(c["p"]), _comps(c["s"]),
                                         torch.from_numpy(mask), batch=batch)
    masked = mask != 0
    assert (got.numpy()[masked] == ref[masked]).mean() >= EQUAL_MIN


# -- ties: the same sphere in two sphere chunks -----------------------------------

TIE_LOW, TIE_HIGH = 3, 130  # spheres of sphere chunks 0 and 2


@pytest.fixture(scope="module")
def sphere_tie():
    """The cloud with sphere TIE_LOW copied over sphere TIE_HIGH and rays
    aimed at it from 1000 lanes (no multiple of Pallas's tile, which gets
    1024): two hits at the same t in two chunks, and the lower index
    has to win."""
    import dataclasses

    js, _, _, _, _ = _cloud_inputs()
    fields = [f for f in FIELDS if f.startswith("sph_")]
    js = dataclasses.replace(
        js, **{f: getattr(js, f).at[TIE_HIGH].set(getattr(js, f)[TIE_LOW]) for f in fields})
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    centre = np.asarray(js.sph_pos)[TIE_LOW]
    radius = float(np.asarray(js.sph_radius)[TIE_LOW])
    g = np.random.default_rng(29)
    away = g.normal(0.0, 1.0, (N, 3)).astype(np.float32)
    away /= np.linalg.norm(away, axis=-1, keepdims=True)
    o = (centre + away * np.float32(radius * 1.5)).astype(np.float32)
    d = (centre + g.normal(0.0, 0.4 * radius, (N, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones(N, np.int32)
    ref = _pallas(pint.chunked_closest_tiles, js, o, d, ones)
    n = 1000
    cut = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:n, k])) for k in range(3))  # noqa: E731
    mask = torch.ones(n, dtype=torch.int32)
    plain = tuple(x.numpy() for x in intersect.chunked_closest_plain(ts, cut(o), cut(d), mask))
    model = tuple(x.numpy() for x in intersect.chunked_closest_model(
        ts, cut(o), cut(d), mask, batch=2)[:3])
    return tuple(x[:n] for x in ref), plain, model


def test_tie_rays_hit_the_copied_sphere(sphere_tie):
    _, plain, _ = sphere_tie
    assert ((plain[1] == 0) & (plain[2] == TIE_LOW)).mean() > 0.5
    assert not (plain[2][plain[1] == 0] == TIE_HIGH).any()


@pytest.mark.parametrize("out", ["type", "index"])
def test_sphere_tie_lower_index_wins_everywhere(sphere_tie, out):
    ref, plain, model = sphere_tie
    k = ("t", "type", "index").index(out)
    assert np.array_equal(model[k], plain[k])
    assert (plain[k] == ref[k]).mean() >= EQUAL_MIN, f"{(plain[k] != ref[k]).sum()} lanes differ"
