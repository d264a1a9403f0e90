"""The big-mesh route's sweeps: the port's chunk tables and its plain
chunked sweeps against the JAX package.

Chunk tables (scene/device.py) against pallas_intersect's chunk_bounds,
sphere_chunk_bounds, tri_const_table and sphere_const_table: bitwise, on
the 200-triangle wall of conftest's big_tri_scene, suzanne, suzanne_hi
and spheres.

``chunked_closest_plain`` and ``chunked_any_plain`` against the Pallas
kernels (``chunked_closest_tiles`` / ``chunked_any_tiles``) in interpret
mode on one 8x128 tile (rows = sublanes = 8, no shortlist at 4-5
chunks), on the wall (4 triangle chunks) with seeded rays and a seeded
mask that leaves about a fifth of the lanes out. The Pallas kernel culls
a chunk for a whole tile, the port per lane; both are exact only on the
lanes the wavefront reads, so the comparison takes the live lanes
(closest) or the masked lanes (occlusion). One case with every lane
live holds the per-lane cull's result against the per-tile cull on all
lanes.

Bounds: type and index equal on >= 99.9% of the compared lanes, t
isclose(1e-4, 1e-5) on as many (torch and XLA round the same
expressions, but XLA contracts multiply-adds; measured: every lane
equal), occlusion equal on >= 99.9%.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu import load_scene as j_load_scene
from rsoderh_raytracing_tpu.ops import pallas_intersect as pint
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.scene.device import (
    CHUNKED,
    FIELDS,
    build_device_scene,
    device_scene_from_arrays,
    route,
    scene_chunk_count,
)

torch.set_num_threads(2)

EQUAL_MIN = 0.999
RTOL, ATOL = 1e-4, 1e-5
ROWS, LANES = 8, 128
N = ROWS * LANES


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def _jax_chunk_tables(js):
    bounds, windows = [], []
    if js.tri_valid.shape[0]:
        bounds.append(np.asarray(pint.chunk_bounds(js)))
        windows.append(np.asarray(pint.tri_const_table(js)))
    if pint._chunk_spheres(js):
        bounds.append(np.asarray(pint.sphere_chunk_bounds(js)))
        windows.append(np.asarray(pint.sphere_const_table(js)))
    return np.concatenate(bounds), np.concatenate(windows)


@pytest.fixture(scope="module", params=["wall", "suzanne", "suzanne_hi", "spheres"])
def table_pair(request, assets_dir, big_tri_scene):
    if request.param == "wall":
        js = j_build(big_tri_scene)
        ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    else:
        path = os.path.join(assets_dir, "scenes", f"{request.param}.toml")
        js = j_build(j_load_scene(path))
        ts = build_device_scene(load_scene(path), device="cpu")
    return js, ts


def test_chunk_bounds_bitwise(table_pair):
    js, ts = table_pair
    bounds, _ = _jax_chunk_tables(js)
    assert route(ts) == CHUNKED
    assert ts.chunks.count == scene_chunk_count(ts) == pint.scene_chunk_count(js)
    assert ts.chunks.bounds.shape == bounds.shape
    np.testing.assert_array_equal(_bits(ts.chunks.bounds.numpy()), _bits(bounds))


def test_chunk_windows_bitwise(table_pair):
    js, ts = table_pair
    _, windows = _jax_chunk_tables(js)
    assert ts.chunks.windows.shape == windows.shape
    np.testing.assert_array_equal(_bits(ts.chunks.windows.numpy()), _bits(windows))
    assert ts.chunks.n_tri_chunks == js.tri_valid.shape[0] // pint.TRI_CHUNK


def wall_rays():
    """Rays from around the camera of big_tri_scene toward the wall, the
    sphere and the plane; a few axis-parallel directions (1/d = inf)."""
    g = np.random.default_rng(7)
    o = np.array([0.0, 0.5, 1.0], np.float32) + g.normal(0.0, 0.3, (N, 3)).astype(np.float32)
    d = g.normal(0.0, 0.6, (N, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.4
    d[:8] = [[0, 0, -1], [0, -1, 0], [1, 0, 0], [0, 0, 1], [0.6, 0, -0.8], [0, 0.6, -0.8],
             [-0.6, 0, -0.8], [0, -0.8, -0.6]]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), g


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


def closest_pair(js, ts, o, d, mask):
    ref = _pallas(pint.chunked_closest_tiles, js, o, d, mask)
    got = intersect.chunked_closest_plain(ts, _comps(o), _comps(d), torch.from_numpy(mask))
    return ref, tuple(x.numpy() for x in got)


@pytest.fixture(scope="module")
def wall_pair(big_tri_scene):
    """Closest and occlusion from both sides, with about a fifth of the
    lanes not live. Occlusion rays start at the closest hit point, toward
    a seeded direction, with the hit mask of the live lanes that hit, as
    the wavefront sends them."""
    js = j_build(big_tri_scene)
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    assert pint._chunked_applicable(js) and pint._shortlist_group(pint.scene_chunk_count(js), 1) == 0
    o, d, g = wall_rays()
    mask = (g.random(N) < 0.8).astype(np.int32)
    ref, got = closest_pair(js, ts, o, d, mask)
    t = np.where(ref[1] >= 0, ref[0], 0.0).astype(np.float32)
    p = (o + d * t[:, None]).astype(np.float32)
    g = np.random.default_rng(11)
    s = g.normal(0.0, 1.0, (N, 3)).astype(np.float32)
    s[:, 1] = np.abs(s[:, 1])
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    hit_mask = ((ref[1] >= 0) & (mask != 0)).astype(np.int32)
    ref_occ = _pallas(pint.chunked_any_tiles, js, p, s, hit_mask)
    got_occ = intersect.chunked_any_plain(ts, _comps(p), _comps(s), torch.from_numpy(hit_mask)).numpy()
    return dict(mask=mask, hit_mask=hit_mask, ref=ref, got=got, ref_occ=ref_occ, got_occ=got_occ)


@pytest.fixture(scope="module")
def wall_all_live(big_tri_scene):
    """The closest hit with every lane live: the per-lane cull against
    the per-tile cull on every lane."""
    js = j_build(big_tri_scene)
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    o, d, _ = wall_rays()
    return closest_pair(js, ts, o, d, np.ones(N, np.int32))


def test_wall_rays_reach_every_winner_type(wall_pair):
    types = wall_pair["got"][1][wall_pair["mask"] != 0]
    assert {-1, 0, 1, 2} <= set(types.tolist())
    occ = wall_pair["got_occ"][wall_pair["hit_mask"] != 0]
    assert 0.05 < occ.mean() < 0.95


def _agree(out, a, b):
    if out == "t":
        assert np.isclose(a, b, rtol=RTOL, atol=ATOL).mean() >= EQUAL_MIN
    else:
        assert (a == b).mean() >= EQUAL_MIN, f"{(a != b).sum()} lanes differ"


@pytest.mark.parametrize("out", ["t", "type", "index"])
def test_chunked_closest_plain_matches_pallas(wall_pair, out):
    live = wall_pair["mask"] != 0
    k = ("t", "type", "index").index(out)
    _agree(out, wall_pair["got"][k][live], wall_pair["ref"][k][live])


@pytest.mark.parametrize("out", ["t", "type", "index"])
def test_all_live_closest_matches_pallas(wall_all_live, out):
    ref, got = wall_all_live
    k = ("t", "type", "index").index(out)
    _agree(out, got[k], ref[k])


def test_chunked_any_plain_matches_pallas(wall_pair):
    masked = wall_pair["hit_mask"] != 0
    a, b = wall_pair["got_occ"][masked], wall_pair["ref_occ"][masked]
    assert (a == b).mean() >= EQUAL_MIN, f"{(a != b).sum()} lanes differ"


def test_wrappers_on_cpu_run_plain_and_count_nothing(big_tri_scene):
    js = j_build(big_tri_scene)
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    o, d, g = wall_rays()
    mask = torch.from_numpy((g.random(N) < 0.8).astype(np.int32))
    ci.reset_launches()
    got = ci.chunked_closest_call(ts, _comps(o), _comps(d), mask)
    occ = ci.chunked_any_call(ts, _comps(o), _comps(d), mask)
    assert set(ci.LAUNCHES.values()) == {0}
    for a, b in zip(got, intersect.chunked_closest_plain(ts, _comps(o), _comps(d), mask)):
        assert torch.equal(a, b)
    assert torch.equal(occ, intersect.chunked_any_plain(ts, _comps(o), _comps(d), mask))
