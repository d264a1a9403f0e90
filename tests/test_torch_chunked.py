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


# -- the model of the CUDA kernels' traversal (intersect.chunked_*_model) ------
# Held bit-equal to the plain versions (t by its bits) on every lane, and to
# the Pallas kernels within the bounds above on the live (masked) lanes, for
# batches of 1 chunk, of 8 (more than the wall's 4 chunks, so one batch) and
# of 3 (two batches, the second ragged), with every lane live, the seeded
# mask and no lane live.

BATCHES = (1, 3, 8)
MASKS = ("all_live", "mixed", "all_dead")


def _wall_scenes(big_tri_scene):
    js = j_build(big_tri_scene)
    return js, device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")


def _mask(kind, seeded):
    return {"all_live": np.ones(N, np.int32), "mixed": seeded, "all_dead": np.zeros(N, np.int32)}[kind]


@pytest.fixture(scope="module")
def wall_inputs(big_tri_scene, wall_pair):
    """The wall's torch scene, the rays of wall_pair (closest rays, and
    occlusion rays from the Pallas hit points) and its two seeded masks."""
    _, ts = _wall_scenes(big_tri_scene)
    o, d, _ = wall_rays()
    ref = wall_pair["ref"]
    t = np.where(ref[1] >= 0, ref[0], 0.0).astype(np.float32)
    p = (o + d * t[:, None]).astype(np.float32)
    g = np.random.default_rng(11)
    s = g.normal(0.0, 1.0, (N, 3)).astype(np.float32)
    s[:, 1] = np.abs(s[:, 1])
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    return dict(ts=ts, o=o, d=d, p=p, s=s, mask=wall_pair["mask"], hit_mask=wall_pair["hit_mask"])


@pytest.fixture(scope="module")
def wall_any_all_live(big_tri_scene, wall_inputs):
    """Pallas occlusion with every lane masked in."""
    js, _ = _wall_scenes(big_tri_scene)
    return _pallas(pint.chunked_any_tiles, js, wall_inputs["p"], wall_inputs["s"], np.ones(N, np.int32))


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("batch", BATCHES)
def test_closest_model_equals_plain(wall_inputs, batch, mask_kind):
    w = wall_inputs
    mask = torch.from_numpy(_mask(mask_kind, w["mask"]))
    plain = intersect.chunked_closest_plain(w["ts"], _comps(w["o"]), _comps(w["d"]), mask)
    *got, pairs = intersect.chunked_closest_model(w["ts"], _comps(w["o"]), _comps(w["d"]), mask, batch=batch)
    for a, b in zip(got, plain):
        assert _same_bits(a, b)
    assert (pairs == 0) == (mask_kind == "all_dead")


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("batch", BATCHES)
def test_any_model_equals_plain(wall_inputs, batch, mask_kind):
    w = wall_inputs
    mask = torch.from_numpy(_mask(mask_kind, w["hit_mask"]))
    plain = intersect.chunked_any_plain(w["ts"], _comps(w["p"]), _comps(w["s"]), mask)
    got, pairs = intersect.chunked_any_model(w["ts"], _comps(w["p"]), _comps(w["s"]), mask, batch=batch)
    assert torch.equal(got, plain)
    assert (pairs == 0) == (mask_kind == "all_dead")


@pytest.mark.parametrize("mask_kind", MASKS[:2])
@pytest.mark.parametrize("batch", BATCHES)
def test_closest_model_matches_pallas(wall_inputs, wall_pair, wall_all_live, batch, mask_kind):
    w = wall_inputs
    mask = _mask(mask_kind, w["mask"])
    ref = wall_all_live[0] if mask_kind == "all_live" else wall_pair["ref"]
    got = intersect.chunked_closest_model(w["ts"], _comps(w["o"]), _comps(w["d"]),
                                          torch.from_numpy(mask), batch=batch)
    live = mask != 0
    for k, out in enumerate(("t", "type", "index")):
        _agree(out, got[k].numpy()[live], ref[k][live])


@pytest.mark.parametrize("mask_kind", MASKS[:2])
@pytest.mark.parametrize("batch", BATCHES)
def test_any_model_matches_pallas(wall_inputs, wall_pair, wall_any_all_live, batch, mask_kind):
    w = wall_inputs
    mask = _mask(mask_kind, w["hit_mask"])
    ref = wall_any_all_live if mask_kind == "all_live" else wall_pair["ref_occ"]
    got, _ = intersect.chunked_any_model(w["ts"], _comps(w["p"]), _comps(w["s"]),
                                         torch.from_numpy(mask), batch=batch)
    masked = mask != 0
    assert (got.numpy()[masked] == ref[masked]).mean() >= EQUAL_MIN


@pytest.mark.parametrize("closest", [True, False])
def test_model_pairs_by_batch(wall_inputs, closest):
    """Batches of one chunk test each slab against the running best, the
    per-lane chunk order that profiling.cull_counts counts; a larger batch
    tests against an older best and can only sweep more pairs. The union
    box never costs a pair: one batch over all chunks sweeps what a dense
    slab test lets through."""
    from rsoderh_raytracing_tpu_torch import profiling

    w = wall_inputs
    if closest:
        ro, rd, mask = _comps(w["o"]), _comps(w["d"]), torch.from_numpy(w["mask"])
        model = intersect.chunked_closest_model
    else:
        ro, rd, mask = _comps(w["p"]), _comps(w["s"]), torch.from_numpy(w["hit_mask"])
        model = intersect.chunked_any_model
    pairs = [model(w["ts"], ro, rd, mask, batch=b)[-1] for b in BATCHES]
    assert pairs[0] == profiling.cull_counts(w["ts"], ro, rd, mask, closest)[1]
    assert pairs[0] <= pairs[1] <= pairs[2]
    counts = {}
    model(w["ts"], ro, rd, mask, batch=2, counts=counts)
    assert counts["pairs"] <= counts["candidates"] * 2 and counts["candidates"] > 0


def test_model_on_a_ragged_lane_count(wall_inputs, wall_pair):
    """1000 lanes, no multiple of Pallas's tile or of a chunk's rows: the
    model against the plain version on every lane and against Pallas's
    first 1000 on live ones."""
    w, n = wall_inputs, 1000
    cut = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:n, k])) for k in range(3))  # noqa: E731
    mask = torch.from_numpy(w["mask"][:n].copy())
    plain = intersect.chunked_closest_plain(w["ts"], cut(w["o"]), cut(w["d"]), mask)
    got = intersect.chunked_closest_model(w["ts"], cut(w["o"]), cut(w["d"]), mask, batch=3)
    for a, b in zip(got, plain):
        assert _same_bits(a, b)
    live = w["mask"][:n] != 0
    for k, out in enumerate(("t", "type", "index")):
        _agree(out, got[k].numpy()[live], wall_pair["ref"][k][:n][live])


# -- ties: the same triangle in two chunks ------------------------------------

TIE_LOW, TIE_HIGH = 5, 150  # rows of chunk 0 and chunk 2


@pytest.fixture(scope="module")
def tie_pair(big_tri_scene):
    """The wall with triangle TIE_LOW copied over triangle TIE_HIGH, and
    rays from in front of the wall through points inside that triangle: two
    hits at the same t in two chunks, and the lower index has to win."""
    import dataclasses

    js = j_build(big_tri_scene)
    fields = [f for f in FIELDS if f.startswith("tri_")]
    js = dataclasses.replace(
        js, **{f: getattr(js, f).at[TIE_HIGH].set(getattr(js, f)[TIE_LOW]) for f in fields})
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, device="cpu")
    a, e0, e1 = (np.asarray(getattr(js, f))[TIE_LOW] for f in ("tri_a", "tri_edge0", "tri_edge1"))
    g = np.random.default_rng(23)
    u = g.uniform(0.05, 0.9, N).astype(np.float32)
    v = (g.uniform(0.05, 0.95, N) * (0.95 - u)).astype(np.float32)
    target = a + u[:, None] * e0 + v[:, None] * e1
    o = (np.array([0.0, 0.5, 1.0], np.float32) + g.normal(0.0, 0.3, (N, 3))).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.ones(N, np.int32)
    ref = _pallas(pint.chunked_closest_tiles, js, o, d, mask)
    plain = tuple(x.numpy() for x in intersect.chunked_closest_plain(
        ts, _comps(o), _comps(d), torch.from_numpy(mask)))
    model = tuple(x.numpy() for x in intersect.chunked_closest_model(
        ts, _comps(o), _comps(d), torch.from_numpy(mask), batch=1)[:3])
    return ref, plain, model


def test_tie_rays_hit_the_copied_triangle(tie_pair):
    _, plain, _ = tie_pair
    assert ((plain[1] == 2) & (plain[2] == TIE_LOW)).mean() > 0.5
    assert not (plain[2][plain[1] == 2] == TIE_HIGH).any()


@pytest.mark.parametrize("out", ["type", "index"])
def test_tie_lower_index_wins_everywhere(tie_pair, out):
    ref, plain, model = tie_pair
    k = ("t", "type", "index").index(out)
    assert np.array_equal(model[k], plain[k])
    _agree(out, plain[k], ref[k])


# -- a NaN vertex --------------------------------------------------------------
# Its chunk's box gets no constraint on the vertex's axis; the kernels' fast
# slab test needs the NaN on both sides of that axis (csrc/chunked.cu).


def test_pair_nan_bounds_writes_both_sides():
    from rsoderh_raytracing_tpu_torch.scene.device import pair_nan_bounds

    b = np.arange(12, dtype=np.float32).reshape(2, 6)
    b[0, 1] = np.nan  # min y only
    b[1, 5] = np.nan  # max z only
    got = pair_nan_bounds(b)
    assert np.isnan(got[0, [1, 4]]).all() and np.isnan(got[1, [2, 5]]).all()
    keep = np.ones_like(b, bool)
    keep[0, [1, 4]] = keep[1, [2, 5]] = False
    assert np.array_equal(got[keep], b[keep]) and got.dtype == np.float32


@pytest.mark.parametrize("batch", BATCHES)
def test_nan_vertex_model_equals_plain(big_tri_scene, wall_inputs, batch):
    """The wall with a NaN x on one vertex of triangle 70 (chunk 1): that
    chunk's bounds are NaN on both sides of x and only there, and the model
    equals the plain version bit for bit. The hit test reads the triangle's
    precomputed columns, so triangle 70 itself is still found, through a
    box without a constraint on x."""
    js = j_build(big_tri_scene)
    arrays = {f: np.asarray(getattr(js, f)).copy() for f in FIELDS}
    arrays["tri_a"][70, 0] = np.nan
    ts = device_scene_from_arrays(arrays, device="cpu")
    nan = np.isnan(ts.chunks.bounds.numpy())
    assert nan[1, [0, 3]].all() and nan.sum() == 2
    w = wall_inputs
    mask = torch.ones(N, dtype=torch.int32)
    plain = intersect.chunked_closest_plain(ts, _comps(w["o"]), _comps(w["d"]), mask)
    got = intersect.chunked_closest_model(ts, _comps(w["o"]), _comps(w["d"]), mask, batch=batch)
    for a, b in zip(got, plain):
        assert _same_bits(a, b)
    assert bool(((got[1] == 2) & (got[2] == 70)).any())
