"""The wavefront's lane layout on the CPU: block-major lanes
(render/wavefront.lane_order, RT_DISABLE_BLOCK_REMAP) and lane compaction
on the chunked route (compact_every, compact_key, RT_COMPACT_EVERY,
RT_COMPACT_KEY, RT_COMPACT_MORTON_BITS).

Against the JAX package: lane_order equals render.wavefront._lane_order
(pixel x and y, and the to_lanes / from_lanes permutations) at 256x128
and 256x64 (four and two blocks), 128x64 (one block, the same as
row-major), 96x64 (row-major) and 256x128 under RT_DISABLE_BLOCK_REMAP=1;
compact_every_default equals _compact_every_default on stand-in scenes of
16, 33 and 1,025 chunks (tests/test_wavefront.py's SimpleNamespace
scenes) and under RT_COMPACT_EVERY.

Within the port, bit for bit: on conftest's 200-triangle wall (4 chunks,
the chunked route) at 256x64, two blocks of lanes, free-run with
compact_every 1, 2 and 3 and under each RT_COMPACT_KEY (and a 7-bit
Morton grid) gives the image, counts and stats of compact_every=0; the
block-major lanes give the row-major lanes' results on house (small
route) and the wall for render_freerun, render_wavefront and
render_spp_sync (which is render_wavefront(spp=rounds)); a tile-only
split of 256x128 into two row blocks of 64 gives the unsharded render;
Renderer.step_freerun(compact_every=2) gives compact_every=0's film. No
Pallas interpreter runs here: the port's uncompacted images are held to
the JAX package's by the other test files, and the reference's own
compaction is bit-transparent (tests/test_wavefront.py).
"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu.render import wavefront as j_wavefront
from rsoderh_raytracing_tpu_torch.env.environment import Environment, EnvironmentMaps, device_environment
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import intersect, rng
from rsoderh_raytracing_tpu_torch.parallel.sharding import make_mesh, render_freerun_sharded
from rsoderh_raytracing_tpu_torch.render import wavefront as wf
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.scene.device import (
    CHUNKED, CHUNKED_BATCH, CHUNKED_TILE, SMALL, TRI_CHUNK, build_device_scene, route,
)

torch.set_num_threads(2)

RES = (256, 64)  # two 64x128 blocks
BUDGET, BOUNCES = 2, 3  # 4 free-run iterations: K = 1, 2, 3 all permute mid-flight
SPP, SYNC_BOUNCES = 2, 2
SKY = procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15)


@pytest.fixture(scope="module")
def scenes(house_scene, big_tri_scene):
    """(device scene, environment, camera) of house and the wall."""
    env = device_environment(Environment.from_texture("s", SKY), device="cpu")
    out = {}
    for name, scene in (("house", house_scene), ("wall", big_tri_scene)):
        out[name] = (build_device_scene(scene, device="cpu"), env, camera_pytree(scene.camera, device="cpu"))
    assert route(out["house"][0]) == SMALL and route(out["wall"][0]) == CHUNKED
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, ref):
    """Images and counts bitwise, stats equal."""
    for a, b in zip(got[:-1], ref[:-1]):
        assert torch.equal(_bits(a), _bits(b))
    assert {k: int(v) for k, v in got[-1].items()} == {k: int(v) for k, v in ref[-1].items()}


_RUNS = {}


def run(scenes, monkeypatch, name, path, remap=True, compact_every=None, **knobs):
    """A render of `path` (freerun, wavefront or sync) on scene `name`
    at RES with its stats, memoized by its arguments."""
    if compact_every is None:
        compact_every = wf.compact_every_default(scenes[name][0])
    key = (name, path, remap, compact_every, tuple(sorted(knobs.items())))
    if key not in _RUNS:
        with monkeypatch.context() as m:
            if not remap:
                m.setenv("RT_DISABLE_BLOCK_REMAP", "1")
            for k, v in knobs.items():
                m.setenv(k, v)
            args = (*scenes[name], 0, RES)
            if path == "freerun":
                out = wf.render_freerun(*args, BUDGET, BOUNCES, with_stats=True, compact_every=compact_every)
            elif path == "wavefront":
                out = wf.render_wavefront(*args, SPP, SYNC_BOUNCES, with_stats=True, compact_every=compact_every)
            else:
                out = wf.render_spp_sync(*args, SPP, SYNC_BOUNCES, with_stats=True, compact_every=compact_every)
        _RUNS[key] = out
    return _RUNS[key]


@pytest.mark.parametrize("width,rows,remap", [
    (256, 128, True), (256, 64, True), (128, 64, True), (96, 64, True), (256, 128, False),
])
def test_lane_order_matches_reference(monkeypatch, width, rows, remap):
    if not remap:
        monkeypatch.setenv("RT_DISABLE_BLOCK_REMAP", "1")
    px, py, to_lanes, from_lanes = wf.lane_order(width, rows)
    jx, jy, j_to, j_from = j_wavefront._lane_order(width, rows)
    n = width * rows
    assert np.array_equal(px.numpy(), np.asarray(jx)) and np.array_equal(py.numpy(), np.asarray(jy))
    pixels = torch.arange(n).reshape(rows, width)
    lanes = to_lanes(pixels)
    assert np.array_equal(lanes.numpy(), np.asarray(j_to(jnp.arange(n).reshape(rows, width))))
    assert np.array_equal(from_lanes(torch.arange(n)).numpy(), np.asarray(j_from(jnp.arange(n))))
    assert torch.equal(from_lanes(lanes), pixels)
    rgb = torch.arange(3 * n).reshape(rows, width, 3)
    assert torch.equal(from_lanes(to_lanes(rgb)), rgb)
    block_major = remap and width % wf.BLOCK_W == 0 and rows % wf.BLOCK_H == 0 and n > wf.BLOCK_W * wf.BLOCK_H
    assert torch.equal(lanes, torch.arange(n)) != block_major


def test_layout_takes_no_gather(scenes, monkeypatch):
    """Laying out a block-major Wavefront (its pixels and a per-pixel
    base) and reading its results back in pixel order is reshapes and
    transposing copies: no index_select, gather or scatter, which the
    small route's iteration must not run on the card (chip_smoke.py's
    profile line)."""
    ds, env, cam = scenes["house"]
    calls = []
    for name in ("index_select", "index_copy_", "gather", "take", "scatter_"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    monkeypatch.setattr(torch, "index_select", lambda *a, **k: calls.append("torch.index_select"))
    base = np.arange(RES[0] * RES[1], dtype=np.uint32).reshape(RES[::-1])
    wave = wf.Wavefront(ds, env, cam, base, RES, wf.NO_LIMIT, BUDGET, BOUNCES)
    film, counts, _ = wave.results()
    assert calls == []
    assert film.shape == (RES[0] * RES[1], 3) and (counts == 0).all()
    assert torch.equal(rng.from_bits(wave.carry["base"]),
                       wf.lane_order(*RES)[2](torch.from_numpy(base.astype(np.int64))))


def _stand_in(chunks, device="cpu"):
    """A scene of `chunks` triangle chunks as both packages' cadences read
    it (tests/test_wavefront.py's stand-in, with the port's chunk tables
    and device)."""
    return SimpleNamespace(
        tri_valid=np.ones(TRI_CHUNK * chunks, np.int32), sph_radius=np.zeros(0, np.float32),
        pln_valid=np.zeros(0, np.int32), bvh=None, chunks=SimpleNamespace(n_sph_chunks=0),
        device=torch.device(device),
    )


@pytest.mark.parametrize("chunks,knob", [(16, None), (33, None), (1025, None), (33, "5"), (1025, "0")])
def test_default_cadence_matches_reference(monkeypatch, chunks, knob):
    monkeypatch.setenv("RT_PALLAS_INTERPRET", "1")
    if knob is None:
        monkeypatch.delenv("RT_COMPACT_EVERY", raising=False)
    else:
        monkeypatch.setenv("RT_COMPACT_EVERY", knob)
    scene = _stand_in(chunks)
    expected = {16: 0, 33: 2, 1025: 1}[chunks] if knob is None else int(knob)
    assert wf.compact_every_default(scene) == j_wavefront._compact_every_default(scene) == expected
    assert wf.reference_cadence(scene) == {16: 0, 33: 2, 1025: 1}[chunks]
    # the card's default is 0 (measured slower on suzanne_hi); the knob rules there too
    assert wf.compact_every_default(_stand_in(chunks, "cuda")) == (0 if knob is None else int(knob))


@pytest.mark.parametrize("compact_every", [1, 2, 3])
def test_compaction_is_bit_transparent(scenes, monkeypatch, compact_every):
    assert_same(run(scenes, monkeypatch, "wall", "freerun", compact_every=compact_every),
                run(scenes, monkeypatch, "wall", "freerun", compact_every=0))


@pytest.mark.parametrize("knob,value", [
    ("RT_COMPACT_KEY", "morton"), ("RT_COMPACT_KEY", "dir"), ("RT_COMPACT_KEY", "dead"),
    ("RT_COMPACT_MORTON_BITS", "7"),
])
def test_compaction_key_modes_are_bit_transparent(scenes, monkeypatch, knob, value):
    assert_same(run(scenes, monkeypatch, "wall", "freerun", compact_every=1, **{knob: value}),
                run(scenes, monkeypatch, "wall", "freerun", compact_every=0))


@pytest.mark.parametrize("name", ["house", "wall"])
@pytest.mark.parametrize("path", ["freerun", "wavefront", "sync"])
def test_block_major_is_row_major(scenes, monkeypatch, name, path):
    # the wall's 4 chunks take the default cadence 0: the layout alone
    assert_same(run(scenes, monkeypatch, name, path), run(scenes, monkeypatch, name, path, remap=False))


@pytest.mark.parametrize("name", ["house", "wall"])
def test_sync_is_wavefront_in_block_major_lanes(scenes, monkeypatch, name):
    img, counts, stats = run(scenes, monkeypatch, name, "sync")
    ref_img, ref_stats = run(scenes, monkeypatch, name, "wavefront")
    assert torch.equal(_bits(img), _bits(ref_img))
    assert (counts == SPP).all()
    assert int(stats["closest_rays"]) == int(ref_stats["closest_rays"])


def test_tile_split_is_unsharded(scenes, monkeypatch):
    """Two row blocks of 64 (each two blocks of lanes, compacted every
    iteration) against the unsharded 256x128 render (four blocks)."""
    ds, env, cam = scenes["wall"]
    res = (256, 128)
    mesh = make_mesh(2, tile=2, devices=["cpu", "cpu"])
    img, counts, _ = render_freerun_sharded(ds, env, cam, 0, mesh, res, 1, 2, compact_every=1)
    ref_img, ref_counts = wf.render_freerun(ds, env, cam, 0, res, 1, 2, compact_every=0)
    assert torch.equal(_bits(img), _bits(ref_img)) and torch.equal(counts, ref_counts)


def test_renderer_step_freerun_compacts_bitwise(scenes, monkeypatch, big_tri_scene):
    r = Renderer(big_tri_scene, *RES, environments=EnvironmentMaps([Environment.from_texture("s", SKY)]),
                 max_bounces=BOUNCES, device="cpu")
    r.step_freerun(BUDGET, compact_every=2)
    img, counts, stats = run(scenes, monkeypatch, "wall", "freerun", compact_every=0)
    assert torch.equal(_bits(r.film.cumulative), _bits(img)) and torch.equal(r.film.counts, counts)
    assert r.last_stats["closest_rays"] == int(stats["closest_rays"])


def model_counts(scene, carry):
    """The batch model's counts of CHUNKED_CLOSEST on the carry's live rays."""
    counts = {}
    intersect.chunked_closest_model(scene, tuple(carry[f"ro{i}"] for i in range(3)),
                                    tuple(carry[f"rd{i}"] for i in range(3)), carry["in_path"],
                                    CHUNKED_BATCH, counts=counts)
    return counts


def test_chunked_tile_mirrors_the_kernels():
    """CHUNKED_TILE, the lanes of a block the model counts by, is the
    chunked kernels' kTile (kThreads x kLanes)."""
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "rsoderh_raytracing_tpu_torch", "csrc", "chunked.cu")) as f:
        src = f.read()
    threads, lanes = (int(re.search(rf"constexpr int {k} = (\d+);", src).group(1)) for k in ("kThreads", "kLanes"))
    assert CHUNKED_TILE == threads * lanes


def test_permutation_moves_whole_lanes(scenes, monkeypatch):
    """Mid-flight the lanes are permuted (home is not the identity), each
    lane's pixel columns still name one pixel, a permutation puts dead
    lanes last and keeps the batch model's pairs and candidates (they are
    per lane, only the busy (block, batch) pairs move), and the drained
    results come back in pixel order."""
    ds, env, cam = scenes["wall"]
    wave = wf.Wavefront(ds, env, cam, 0, RES, wf.NO_LIMIT, BUDGET, BOUNCES, compact_every=1)
    for it in range(2):
        wave.step(it)
    before = model_counts(ds, wave.carry)
    wave.permute()
    c = wave.carry
    after = model_counts(ds, c)
    assert {k: before[k] for k in ("pairs", "candidates")} == {k: after[k] for k in ("pairs", "candidates")}
    blocks = RES[0] * RES[1] // CHUNKED_TILE  # one batch of the wall's 4 chunks
    assert 0 < after["block_batches"] <= blocks and 0 < before["block_batches"] <= blocks
    home = c["home"].to(torch.int64)
    assert not torch.equal(home, torch.arange(home.shape[0]))
    assert torch.equal(home.sort().values, torch.arange(home.shape[0]))
    pixel = c["pixy"].to(torch.int64) * RES[0] + c["pixx"]
    assert torch.equal(pixel, c["pixidx"].to(torch.int64))
    _, _, to_lanes, _ = wf.lane_order(*RES)
    assert torch.equal(to_lanes(torch.arange(pixel.shape[0]).reshape(RES[::-1])).index_select(0, home), pixel)
    live = c["in_path"] != 0
    assert 0 < int(live.sum()) < live.shape[0] and not live[int(live.sum()):].any()
    for it in range(2, wave.drain_iterations()):
        wave.step(it)
    img, counts, _ = run(scenes, monkeypatch, "wall", "freerun", compact_every=0)
    film, got_counts, _ = wave.results()
    assert torch.equal(_bits(film.reshape(img.shape)), _bits(img))
    assert torch.equal(got_counts.reshape(counts.shape), counts)


def test_compaction_runs_only_on_the_chunked_kernel_loop(scenes, monkeypatch, big_tri_scene):
    """The small route, a chunked scene built with a BVH, and the composed
    body (RT_DISABLE_WFKERNELS=1) never compact, as in the reference;
    an unknown RT_COMPACT_KEY is "full" and the Morton grid stops at 8 bits."""
    house, env, cam = scenes["house"]
    wall = scenes["wall"][0]
    bvh = build_device_scene(big_tri_scene, device="cpu", with_bvh=True)

    def cadence(scene):
        return wf.Wavefront(scene, env, cam, 0, (8, 8), wf.NO_LIMIT, 1, 1, compact_every=2).compact_every

    assert (cadence(house), cadence(bvh), cadence(wall)) == (0, 0, 2)
    monkeypatch.setenv("RT_COMPACT_KEY", "bogus")
    monkeypatch.setenv("RT_COMPACT_MORTON_BITS", "12")
    wave = wf.Wavefront(wall, env, cam, 0, (8, 8), wf.NO_LIMIT, 1, 1, compact_every=2)
    assert (wave.key_mode, wave.key_bits) == ("full", 8)
    monkeypatch.setenv("RT_DISABLE_WFKERNELS", "1")
    assert cadence(wall) == 0


def _carry(seed, n=4096, live=0.6):
    g = np.random.default_rng(seed)
    c = {f"ro{i}": torch.from_numpy(g.uniform(-3, 3, n).astype(np.float32)) for i in range(3)}
    d = g.normal(size=(3, n)).astype(np.float32)
    c.update({f"rd{i}": torch.from_numpy(d[i]) for i in range(3)})
    c["in_path"] = torch.from_numpy((g.uniform(size=n) < live).astype(np.int32))
    return c


def test_compact_key_sorts_dead_last_and_keeps_ties(scenes):
    ds, _, cam = scenes["wall"]
    c = _carry(0)
    lo, scale = wf.compact_grid(ds, cam, 5)
    key = wf.compact_key(c, lo, scale, 5)
    live = c["in_path"] != 0
    assert (key[~live] == wf.DEAD_KEY).all()
    assert (key[live] >= 0).all() and (key[live] < 1 << 22).all()
    order = torch.argsort(key, stable=True)
    assert not live[order][int(live.sum()):].any()
    # equal keys keep lane order: the dead block, and every group of ties
    sk = key[order]
    tie = sk[1:] == sk[:-1]
    assert (order[1:][tie] > order[:-1][tie]).all()
    assert torch.equal(torch.argsort(wf.compact_key(c, lo, scale, 5, "dead"), stable=True),
                       torch.cat([torch.nonzero(live).squeeze(1), torch.nonzero(~live).squeeze(1)]))


@pytest.mark.parametrize("bits", [5, 8])
def test_compact_key_cells_of_bad_origins(scenes, bits):
    """Origins that are NaN, infinite or far outside the grid, and a zero
    direction, land in a cell in [0, cells) without an error."""
    ds, _, cam = scenes["wall"]
    bad = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30, 0.0], dtype=torch.float32)
    n = bad.shape[0]
    c = {"ro0": bad, "ro1": bad.flip(0), "ro2": bad.roll(2),
         "rd0": torch.zeros(n), "rd1": torch.zeros(n), "rd2": torch.zeros(n),
         "in_path": torch.ones(n, dtype=torch.int32)}
    lo, scale = wf.compact_grid(ds, cam, bits)
    morton = wf.compact_key(c, lo, scale, bits, "morton")
    assert (morton >= 0).all() and (morton < 1 << (3 * bits)).all()
    octa = wf.compact_key(c, lo, scale, bits, "dir")
    assert (octa >= 0).all() and (octa < 1 << 7).all()
    full = wf.compact_key(c, lo, scale, bits)
    assert torch.equal(full, (morton << 7) | octa)
