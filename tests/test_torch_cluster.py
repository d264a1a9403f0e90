"""Chunk orders (scene/cluster.py) and the chunked route's knobs of the
port against the JAX package, on the CPU.

Orders: bvh_dfs_order, treelet_cuts and treelet_pack bitwise the
reference's on suzanne (968 triangles) and on a seeded, jittered
sphere shell of 3,040 triangles. The reference builds its triangle BVH
through a private build of its own native library
(tests/test_torch_env.compile_reference_native): its loader writes the
library in place, which races with other test processes.

Scenes: suzanne's build_device_scene: its 32 fields, sweep_rows, the
chunk bounds, windows and BIG_SHADE's winner rows bitwise the JAX
package's under RT_CHUNK_CLUSTER=morton, bvh, treelet and
RT_DISABLE_MORTON=1.

Hits: the order is storage only, so the plain chunked sweeps and the
kernels' batch models on a treelet scene (pad rows between real
triangles) give the Morton scene's hits: t bitwise, type equal, triangle
indices equal once mapped to host triangles.

Images: the port's suzanne render at 48x32, 2 spp (under
procedural_sky(64, 32)), in each order is bitwise its Morton render (as
tests/test_cluster.py holds the JAX package), and within the big-mesh
route's standing bounds (tests/test_torch_wavefront.py) of the JAX
package's render in the same order: image mean within 2e-3 relative,
>= 98% of values isclose(1e-4, 1e-5). Measured here in every order:
99.83% of values close, mean within 2.7e-4 relative.

Knobs: an unknown RT_CHUNK_CLUSTER raises on any scene, a non-default
order on a scene that the gate does not reach warns once, treelet_pack
refuses a chunk smaller than a BVH leaf, its numpy sweeps equal the
reference's node-by-node loops, and it builds one BVH a call; the
ceilings RT_MAX_CHUNKED_TRIS and RT_MAX_CHUNKED_SPHERES move the route
as the reference's do; the mirror of the chunked kernels' shared memory
(scene/device.chunked_shared_bytes) follows csrc/chunked.cu's layout,
and past a block's limit counts the union boxes it holds at a time
instead of refusing the scene.
"""

import os
import re
import warnings

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu.accel import native as j_native
from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import EnvironmentMaps as JEnvironmentMaps
from rsoderh_raytracing_tpu.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu.ops import pallas_intersect as pint
from rsoderh_raytracing_tpu.ops import pallas_wavefront as pwf
from rsoderh_raytracing_tpu.render.renderer import Renderer as JRenderer
from rsoderh_raytracing_tpu.scene import cluster as j_cluster
from rsoderh_raytracing_tpu.scene.camera import Camera as JCamera
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu.scene.types import Material as JMaterial
from rsoderh_raytracing_tpu.scene.types import PackedMeshes as JPackedMeshes
from rsoderh_raytracing_tpu.scene.types import Scene as JScene
from rsoderh_raytracing_tpu_torch import _device, load_scene
from rsoderh_raytracing_tpu_torch.accel import bvh as t_bvh
from rsoderh_raytracing_tpu_torch.env.environment import Environment, EnvironmentMaps
from rsoderh_raytracing_tpu_torch.ops import intersect
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.scene import cluster
from rsoderh_raytracing_tpu_torch.scene import device as t_device
from rsoderh_raytracing_tpu_torch.scene.device import (
    BVH,
    CHUNKED,
    FIELDS,
    SMALL,
    auto_bvh,
    build_device_scene,
    counts_route,
    route,
)
from tests.test_torch_env import _reference_native_bvh, compile_reference_native

torch.set_num_threads(2)

ORDERS = ("morton", "bvh", "treelet", "host")
KNOBS = ("RT_CHUNK_CLUSTER", "RT_DISABLE_MORTON", "RT_MAX_CHUNKED_TRIS", "RT_MAX_CHUNKED_SPHERES")
IMAGE_MEAN_RTOL = 2e-3
IMAGE_CLOSE_MIN = 0.98
CHUNKED_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "rsoderh_raytracing_tpu_torch", "csrc", "chunked.cu")


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def _set_order(mp, order):
    """The environment of `order`: RT_CHUNK_CLUSTER, or the host order."""
    for knob in KNOBS:
        mp.delenv(knob, raising=False)
    if order == "host":
        mp.setenv("RT_DISABLE_MORTON", "1")
    else:
        mp.setenv("RT_CHUNK_CLUSTER", order)


@pytest.fixture(scope="module")
def reference_bvh(tmp_path_factory):
    """The JAX package's native SAH builder through a private build."""
    lib = compile_reference_native(tmp_path_factory.mktemp("reference_native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "build_bvh_native", lambda mins, maxs: _reference_native_bvh(lib, mins, maxs))
        yield


def _shell():
    """A seeded sphere shell of 40 x 38 quads, 3,040 triangles, its
    vertices jittered (a JAX-package Scene, which both builders take)."""
    g = np.random.default_rng(21)
    nu, nv = 40, 39
    u = np.linspace(0.0, 2.0 * np.pi, nu, endpoint=False)
    v = np.linspace(0.15, np.pi - 0.15, nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    pts = np.stack([np.sin(vv) * np.cos(uu), np.cos(vv), np.sin(vv) * np.sin(uu)], -1).reshape(-1, 3)
    pts = (pts * (1.0 + g.normal(0.0, 0.03, (len(pts), 1))) + [0.0, 1.0, -4.0]).astype(np.float32)
    idx = np.arange(nu * nv).reshape(nu, nv)
    a, b = idx[:, :-1], np.roll(idx, -1, axis=0)[:, :-1]
    c, d = idx[:, 1:], np.roll(idx, -1, axis=0)[:, 1:]
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3), np.stack([b, d, c], -1).reshape(-1, 3)])
    tris = np.concatenate([faces, np.zeros((len(faces), 4), np.int64)], axis=1).astype(np.int32)
    return JScene(materials=[JMaterial((0.8, 0.8, 0.8), 0.5, 0.0, (0.0, 0.0, 0.0))], spheres=[], planes=[],
                  meshes=JPackedMeshes(vertices=pts, normals=np.array([[0.0, 1.0, 0.0]], np.float32),
                                       triangles=tris),
                  camera=JCamera(pos=[0.0, 1.0, 0.0], yaw=0.0, pitch=0.0, fov_y=1.0))


@pytest.fixture(scope="module")
def meshes(assets_dir):
    return {"suzanne": load_scene(os.path.join(assets_dir, "scenes", "suzanne.toml")), "shell": _shell()}


@pytest.mark.parametrize("mesh", ["suzanne", "shell"])
def test_orders_bitwise(reference_bvh, meshes, mesh):
    scene = meshes[mesh]
    v, tris = scene.meshes.vertices, scene.meshes.triangles
    got, ref = cluster.bvh_dfs_order(v, tris), j_cluster.bvh_dfs_order(v, tris)
    assert sorted(got.tolist()) == list(range(len(tris)))
    np.testing.assert_array_equal(got, ref)
    tree = cluster._tri_bvh(v, tris)
    for cap in (5, 64, 300):
        got_cuts, got_counts = cluster.treelet_cuts(tree.node_payload, tree.node_count, cap)
        ref_cuts, ref_counts = j_cluster.treelet_cuts(tree.node_payload, tree.node_count, cap)
        assert got_cuts == ref_cuts
        np.testing.assert_array_equal(got_counts, ref_counts)
    out, valid = cluster.treelet_pack(v, tris, 64)
    ref_out, ref_valid = j_cluster.treelet_pack(v, tris, 64)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(valid, ref_valid)
    assert len(out) % 64 == 0 and int(valid.sum()) == len(tris)
    # pad rows between real triangles, collapsed to one vertex
    assert (~valid.reshape(-1, 64)).any(axis=1).sum() > 1
    pads = out[~valid]
    assert (pads[:, 0] == pads[:, 1]).all() and (pads[:, 0] == pads[:, 2]).all()


@pytest.fixture(scope="module")
def scene_pairs(reference_bvh, meshes):
    """(JAX DeviceScene, port DeviceScene) of suzanne in each order."""
    pairs = {}
    with pytest.MonkeyPatch.context() as mp:
        for order in ORDERS:
            _set_order(mp, order)
            pairs[order] = (j_build(meshes["suzanne"]), build_device_scene(meshes["suzanne"], "cpu"))
    return pairs


def _jax_chunk_tables(js):
    return np.asarray(pint.chunk_bounds(js)), np.asarray(pint.tri_const_table(js))


@pytest.mark.parametrize("order", ORDERS)
def test_device_scene_bitwise(scene_pairs, order):
    js, ts = scene_pairs[order]
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(ts, f).numpy()), _bits(getattr(js, f)), err_msg=f)
    valid = np.asarray(js.tri_valid)
    assert ts.sweep_rows[2] == int(np.flatnonzero(valid)[-1]) + 1
    assert route(ts) == CHUNKED and ts.chunks.count == pint.scene_chunk_count(js)
    bounds, windows = _jax_chunk_tables(js)
    np.testing.assert_array_equal(_bits(ts.chunks.bounds.numpy()), _bits(bounds))
    np.testing.assert_array_equal(_bits(ts.chunks.windows.numpy()), _bits(windows))
    np.testing.assert_array_equal(_bits(ts.winner.numpy()), _bits(pwf.winner_table(js)))
    # the window rows' valid column is the scene's mask, pad rows included
    np.testing.assert_array_equal(ts.chunks.windows[:, 19].numpy(), valid.astype(np.float32))
    if order == "treelet":
        assert valid.shape[0] > scene_pairs["morton"][1].tri_valid.shape[0]
        assert (~valid.reshape(-1, 64)[:-1]).any()


def _host_index(scene, ts):
    """Host triangle index of each stored row of `ts` (-1 for a pad row),
    by matching the stored a, e0, e1 to the host's, computed as the
    builder computes them."""
    v, tris = scene.meshes.vertices, scene.meshes.triangles
    a = v[tris[:, 0]]
    host = np.concatenate([a, v[tris[:, 1]] - a, v[tris[:, 2]] - a], axis=1).astype(np.float32)
    key = {row.tobytes(): i for i, row in enumerate(host)}
    assert len(key) == len(tris)
    stored = np.concatenate([ts.tri_a.numpy(), ts.tri_edge0.numpy(), ts.tri_edge1.numpy()], axis=1)
    return np.array([key[row.tobytes()] if ok else -1 for row, ok in zip(stored, ts.tri_valid.numpy())])


def _rays(scene, n, seed):
    """Seeded rays from a box around the mesh toward points inside its
    bounds, and a seeded mask of about four lanes in five."""
    g = np.random.default_rng(seed)
    v = scene.meshes.vertices
    lo, hi = v.min(axis=0), v.max(axis=0)
    centre, size = (lo + hi) / 2, float((hi - lo).max())
    o = (centre + g.uniform(-1.5, 1.5, (n, 3)) * size).astype(np.float32)
    d = (lo + g.random((n, 3)) * (hi - lo) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    comps = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3))  # noqa: E731
    return comps(o), comps(d.astype(np.float32)), torch.from_numpy((g.random(n) < 0.8).astype(np.int32))


def test_treelet_hits_are_the_morton_hits(scene_pairs, meshes):
    """The plain sweeps and both batch models on the treelet scene against
    the Morton scene: t bitwise, the winner's kind and host triangle."""
    scene = meshes["suzanne"]
    tree, morton = scene_pairs["treelet"][1], scene_pairs["morton"][1]
    maps = {"t": _host_index(scene, tree), "m": _host_index(scene, morton)}
    assert (maps["t"] >= 0).sum() == (maps["m"] >= 0).sum() == len(scene.meshes.triangles)
    ro, rd, mask = _rays(scene, 2048, 5)
    out = {}
    for name, ts in (("t", tree), ("m", morton)):
        t, ptype, pidx = intersect.chunked_closest_plain(ts, ro, rd, mask)
        *model, pairs = intersect.chunked_closest_model(ts, ro, rd, mask, 16)
        for a, b in zip((t, ptype, pidx), model):
            assert torch.equal(a, b)
        occ = intersect.chunked_any_plain(ts, ro, rd, mask)
        model_occ, _ = intersect.chunked_any_model(ts, ro, rd, mask, 16)
        assert torch.equal(occ, model_occ)
        host = np.where(ptype.numpy() == 2, maps[name][pidx.numpy()], pidx.numpy())
        out[name] = (t.numpy(), ptype.numpy(), host, occ.numpy(), pairs)
    live = mask.numpy() != 0
    np.testing.assert_array_equal(_bits(out["t"][0]), _bits(out["m"][0]))
    np.testing.assert_array_equal(out["t"][1], out["m"][1])
    np.testing.assert_array_equal(out["t"][2], out["m"][2])
    assert ((out["t"][1] == 2) & live).sum() > 200
    np.testing.assert_array_equal(out["t"][3][live], out["m"][3][live])
    assert out["t"][4] > 0 and out["m"][4] > 0


@pytest.fixture(scope="module")
def renders(reference_bvh, meshes):
    """The suzanne render of each package in each order, 48x32, 2 spp."""
    scene = meshes["suzanne"]
    sky = procedural_sky(64, 32)
    j_envs = JEnvironmentMaps([JEnvironment.from_texture("s", sky)])
    envs = EnvironmentMaps([Environment.from_texture("s", sky)])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for order in ORDERS:
            _set_order(mp, order)
            out["jax", order] = np.asarray(
                JRenderer(scene, width=48, height=32, environments=j_envs).render(spp=2))
            out["port", order] = np.asarray(
                Renderer(scene, 48, 32, environments=envs, device="cpu").render(spp=2))
    return out


@pytest.mark.parametrize("order", ORDERS)
def test_render_in_each_order(renders, order):
    port, ref = renders["port", order], renders["jax", order]
    assert port.shape == (32, 48, 3) and np.isfinite(port).all()
    np.testing.assert_array_equal(_bits(port), _bits(renders["port", "morton"]))
    np.testing.assert_allclose(port.mean(), ref.mean(), rtol=IMAGE_MEAN_RTOL)
    assert np.isclose(port, ref, rtol=1e-4, atol=1e-5).mean() >= IMAGE_CLOSE_MIN


def test_unknown_order_raises_on_any_scene(house_scene, meshes, monkeypatch):
    monkeypatch.setenv("RT_CHUNK_CLUSTER", "nope")
    for scene in (house_scene, meshes["suzanne"]):
        with pytest.raises(ValueError, match="RT_CHUNK_CLUSTER"):
            build_device_scene(scene, "cpu")


@pytest.mark.parametrize("case", ["small", "bvh", "host"])
def test_order_the_gate_does_not_reach_warns_once(house_scene, meshes, monkeypatch, case):
    monkeypatch.setattr(_device, "_warned", set())
    monkeypatch.setenv("RT_CHUNK_CLUSTER", "treelet")
    scene, with_bvh = (house_scene, False) if case == "small" else (meshes["suzanne"], case == "bvh")
    if case == "host":
        monkeypatch.setenv("RT_DISABLE_MORTON", "1")
    with pytest.warns(RuntimeWarning, match="RT_CHUNK_CLUSTER='treelet'"):
        ds = build_device_scene(scene, "cpu", with_bvh=with_bvh)
    assert route(ds) == {"small": SMALL, "bvh": BVH, "host": CHUNKED}[case]
    assert bool(ds.tri_valid[: int(ds.tri_valid.sum())].all())  # no pad rows
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        build_device_scene(scene, "cpu", with_bvh=with_bvh)
    # the gate reached: no warning
    monkeypatch.delenv("RT_DISABLE_MORTON", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        build_device_scene(meshes["suzanne"], "cpu")


def test_treelet_pack_refuses_a_chunk_below_a_leaf(meshes):
    v, tris = meshes["suzanne"].meshes.vertices, meshes["suzanne"].meshes.triangles
    with pytest.raises(ValueError, match="smaller than a BVH leaf"):
        cluster.treelet_pack(v, tris, 4)
    out, valid = cluster.treelet_pack(v, tris, t_bvh.MAX_PRIMITIVES_PER_LEAF)
    assert len(out) % t_bvh.MAX_PRIMITIVES_PER_LEAF == 0 and int(valid.sum()) == len(tris)


@pytest.mark.parametrize("n", [1, 2, 6, 41, 2000])
def test_numpy_sweeps_equal_the_loops(n):
    """_subtree_counts and _leaf_ranges against the reference's
    node-by-node loops, on SAH trees of seeded boxes."""
    g = np.random.default_rng(n)
    c = g.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    e = g.exponential(0.2, (n, 3)).astype(np.float32)
    tree = t_bvh.build_bvh_from_bounds(c - e, c + e, np.full(n, 2, np.int32), np.arange(n, dtype=np.int32))
    payload, count = tree.node_payload, tree.node_count
    np.testing.assert_array_equal(cluster._subtree_counts(payload, count),
                                  j_cluster._subtree_counts(payload, count))
    for got, ref in zip(cluster._leaf_ranges(payload, count), j_cluster._leaf_ranges(payload, count)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_treelet_pack_builds_one_bvh(meshes, monkeypatch):
    built = []
    build = cluster.build_bvh_from_bounds
    monkeypatch.setattr(cluster, "build_bvh_from_bounds", lambda *a: built.append(1) or build(*a))
    cluster.treelet_pack(meshes["suzanne"].meshes.vertices, meshes["suzanne"].meshes.triangles, 64)
    assert len(built) == 1


def _clear_ceilings(mp):
    for knob in ("RT_MAX_CHUNKED_TRIS", "RT_MAX_CHUNKED_SPHERES", "RT_BVH_ABOVE_TRIS"):
        mp.delenv(knob, raising=False)


CEILING_COUNTS = [
    (0, 8, 262144), (0, 8, 262208), (0, 8, 991232), (0, 8, 1048576), (0, 8, 1048640),
    (262144, 8, 64), (262208, 8, 64), (512, 8, 0), (64, 8, 128), (8, 256, 64), (8, 4096, 64),
]


@pytest.mark.parametrize("tris_ceiling,spheres_ceiling", [(None, None), ("1048576", None),
                                                          (None, "256"), ("256", "262208")])
def test_ceilings_move_the_route_as_the_reference(monkeypatch, tris_ceiling, spheres_ceiling):
    """counts_route's chunked route against pallas_intersect's predicate
    with the same ceilings (the reference reads them at import, so they
    are patched there); counts the chunked route does not cover are small,
    and auto_bvh on the card takes the BVH exactly past
    CUDA_BVH_ABOVE_LANES sphere and triangle lanes, whatever the ceilings,
    and where the small route's packed table would not fit a block's
    shared memory."""
    _clear_ceilings(monkeypatch)
    for knob, value in (("TRIS", tris_ceiling), ("SPHERES", spheres_ceiling)):
        if value is not None:
            monkeypatch.setenv(f"RT_MAX_CHUNKED_{knob}", value)
            monkeypatch.setattr(pint, f"MAX_CHUNKED_{knob}", int(value))
    cuda = torch.device("cuda")
    for counts in CEILING_COUNTS:
        covered = pint._counts_chunked_applicable(*counts)
        assert (counts_route(*counts) == CHUNKED) == covered, counts
        fits = t_device.sweep_shared_bytes(*counts, 1) <= t_device.SWEEP_MAX_SHARED
        assert (counts_route(*counts) == SMALL) == (not covered), counts
        past = counts[0] + counts[2] > t_device.CUDA_BVH_ABOVE_LANES
        assert auto_bvh(*counts, cuda) == (past or (not covered and not fits)), counts


def test_raised_ceiling_routes_suzanne_xxhi_counts(monkeypatch):
    """suzanne_xxhi's lanes (991,232 triangles, 15,488 chunks, 8 sphere
    and 8 plane lanes): the BVH under the default ceiling; the chunked
    route (with_bvh=False) under RT_MAX_CHUNKED_TRIS=1048576, whose block
    asks for 222,880 bytes, while 'auto' still walks the BVH on the card
    (past CUDA_BVH_ABOVE_LANES) and on the CPU (the reference's
    262,144-lane crossover); unset, the default again."""
    _clear_ceilings(monkeypatch)
    xxhi = (8, 8, 991232)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert counts_route(*xxhi) == SMALL and auto_bvh(*xxhi, cuda) and auto_bvh(*xxhi, cpu)
    monkeypatch.setenv("RT_MAX_CHUNKED_TRIS", "1048576")
    assert counts_route(*xxhi) == CHUNKED
    assert t_device.counts_shared_bytes(*xxhi) == 222880
    assert auto_bvh(*xxhi, cuda) and auto_bvh(*xxhi, cpu)
    monkeypatch.delenv("RT_MAX_CHUNKED_TRIS")
    assert counts_route(*xxhi) == SMALL and auto_bvh(*xxhi, cuda)


def test_shared_mirror_restages_union_boxes_past_the_limit(monkeypatch):
    """A synthetic count past a block's shared memory under a raised
    ceiling: the chunked route covers it on the card too, whose block then
    holds as many batches' union boxes as fit and asks for no more than
    the limit, so 'sweep' runs it there; 'auto' walks the BVH on the card
    past CUDA_BVH_ABOVE_LANES (the CPU follows the reference's
    crossover)."""
    _clear_ceilings(monkeypatch)
    monkeypatch.setenv("RT_MAX_CHUNKED_TRIS", str(1 << 22))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    limit = t_device.CHUNKED_MAX_SHARED
    # one plane (8 lanes, 512 bytes of rows): 1,275 batches of 16 chunks fit
    fits, past = (0, 8, 1275 * 16 * 64), (0, 8, (1275 * 16 + 1) * 64)
    assert t_device.counts_shared_bytes(*fits) == t_device.counts_shared_bytes(*past) == limit
    assert t_device.chunked_union_batches(8 * t_device.PLN_COLS, 1275 * 16) == 1275
    assert t_device.chunked_union_batches(8 * t_device.PLN_COLS, 1275 * 16 + 1) == 1275
    assert t_device.chunked_union_batches(8 * t_device.PLN_COLS, 242) == 16
    assert counts_route(*fits) == counts_route(*past) == CHUNKED
    assert auto_bvh(*fits, cuda) and auto_bvh(*past, cuda) and auto_bvh(*past, cpu)


CARD_LANES = t_device.CUDA_BVH_ABOVE_LANES


@pytest.mark.parametrize("counts,card,cpu", [
    # sphere and triangle lanes below, at and above the card's crossover
    ((0, 8, CARD_LANES - 64), False, False),
    ((0, 8, CARD_LANES), False, False),
    ((0, 8, CARD_LANES + 64), True, False),
    ((CARD_LANES, 8, 0), False, False),
    ((CARD_LANES + 64, 8, 0), True, False),
    ((64, 8, CARD_LANES - 64), False, False),
    ((64, 8, CARD_LANES), True, False),
    # planes stay with the sweep until the table passes shared memory
    ((8, 256, 64), False, False),
    ((8, 4096, 64), True, False),
    # the CPU's crossover is the reference's, 262,144 triangle lanes
    ((0, 8, 262144), True, False),
    ((0, 8, 262208), True, True),
    ((262208, 8, 0), True, False),
])
def test_auto_bvh_by_device(monkeypatch, counts, card, cpu):
    """auto_bvh on the card (by device type alone, so testable here) and
    on the CPU on both sides of each crossover."""
    _clear_ceilings(monkeypatch)
    assert auto_bvh(*counts, torch.device("cuda")) == card
    assert auto_bvh(*counts, torch.device("cpu")) == cpu
    assert t_device.CPU_BVH_ABOVE_LANES == 262144


@pytest.mark.parametrize("thresh,counts,card,cpu", [
    # RT_BVH_ABOVE_TRIS moves both crossovers down to its triangle lanes
    ("64", (0, 8, 64), False, False),
    ("64", (0, 8, 128), True, True),
    ("64", (CARD_LANES + 64, 8, 0), True, False),
    # and never up
    ("1048576", (0, 8, CARD_LANES + 64), True, False),
    ("1048576", (0, 8, 262208), True, True),
    ("1048576", (8, 4096, 64), True, False),
])
def test_rt_bvh_above_tris_moves_the_crossover_down(monkeypatch, thresh, counts, card, cpu):
    _clear_ceilings(monkeypatch)
    monkeypatch.setenv("RT_BVH_ABOVE_TRIS", thresh)
    assert auto_bvh(*counts, torch.device("cuda")) == card
    assert auto_bvh(*counts, torch.device("cpu")) == cpu


@pytest.mark.parametrize("name,card", [("house", False), ("spheres", True), ("suzanne", True),
                                       ("suzanne_hi", True)])
def test_card_auto_on_the_crossover_scenes(assets_dir, name, card, monkeypatch):
    """The lanes of the scenes the route crossover was measured on
    (chip_smoke.py's phase 12 at commit 3bc395c): on the card 'auto'
    keeps house on the small route and walks the BVH on spheres and the
    meshes, where the walks were measured faster; the CPU keeps the
    reference's decision (no BVH within 262,144 lanes)."""
    _clear_ceilings(monkeypatch)
    monkeypatch.delenv("RT_CHUNK_CLUSTER", raising=False)
    ds = build_device_scene(load_scene(os.path.join(assets_dir, "scenes", f"{name}.toml")), "cpu")
    counts = (ds.sph_radius.shape[0], ds.pln_valid.shape[0], ds.tri_valid.shape[0])
    assert auto_bvh(*counts, torch.device("cuda")) == card
    assert not auto_bvh(*counts, torch.device("cpu"))


def _cu_constants():
    """The constexpr integers of csrc/chunked.cu's anonymous namespace,
    evaluated in order (casts and unsigned suffixes dropped)."""
    src = open(CHUNKED_CU).read()
    values = {}
    for name, expr in re.findall(r"constexpr (?:int|size_t|unsigned) (\w+) = ([^;]+);", src):
        expr = re.sub(r"\(size_t\)", "", expr)
        expr = re.sub(r"\b(0x[0-9A-Fa-f]+|\d+)u\b", r"\1", expr)
        try:
            values[name] = int(eval(expr, {}, dict(values)))  # noqa: S307
        except (NameError, SyntaxError):  # a kernel's local constant
            continue
    return values


def test_shared_mirror_follows_the_kernel_layout():
    cu = _cu_constants()
    assert cu["OFF_SMALL"] == t_device.CHUNKED_OFF_SMALL
    assert cu["MAX_SHARED"] == t_device.CHUNKED_MAX_SHARED
    assert cu["kBatch"] == t_device.CHUNKED_BATCH and cu["BOUND_COLS"] == t_device.CHUNKED_BOUND_COLS
    assert cu["CHUNK"] == t_device.TRI_CHUNK


def test_scene_keeps_its_route_when_a_ceiling_is_unset(monkeypatch):
    """A scene built under a raised ceiling keeps the chunked route after
    the knob is unset: the route is the scene's tables'. Under a ceiling of
    256 the 300-triangle grid (320 triangle lanes, a packed table of 46,880
    bytes) is small by the shared-memory mirror, under with_bvh=False and,
    by the reference's CPU rule (no BVH within 262,144 triangle lanes),
    under 'auto' on the CPU too; on the card 'auto' walks the BVH (328
    sphere and triangle lanes, past CUDA_BVH_ABOVE_LANES)."""
    _clear_ceilings(monkeypatch)
    scene = _grid(300)
    monkeypatch.setenv("RT_MAX_CHUNKED_TRIS", "256")
    monkeypatch.setattr(pint, "MAX_CHUNKED_TRIS", 256)
    auto = build_device_scene(scene, "cpu", with_bvh="auto")
    assert route(auto) == SMALL and j_build(scene, with_bvh="auto").bvh is None
    small = build_device_scene(scene, "cpu")
    assert route(small) == SMALL and small.trace_table.numel() * 4 == 46880
    assert auto_bvh(8, 8, 320, torch.device("cuda"))
    monkeypatch.setenv("RT_MAX_CHUNKED_TRIS", "320")
    ds = build_device_scene(scene, "cpu")
    monkeypatch.setenv("RT_MAX_CHUNKED_TRIS", "64")
    assert route(ds) == CHUNKED and ds.chunks.count == 5
    monkeypatch.delenv("RT_MAX_CHUNKED_TRIS")
    assert route(ds) == CHUNKED


def _grid(n_tri):
    """n_tri small triangles on a grid (a JAX-package Scene)."""
    side = int(np.ceil(np.sqrt(n_tri)))
    ij = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1).reshape(-1, 2)[:n_tri]
    base = np.concatenate([ij * 0.01, np.zeros((n_tri, 1))], axis=1).astype(np.float32)
    vertices = np.concatenate([base, base + [0.005, 0, 0], base + [0, 0.005, 0]]).astype(np.float32)
    idx = np.arange(n_tri)
    tris = np.stack([idx, idx + n_tri, idx + 2 * n_tri] + [np.zeros(n_tri, np.int64)] * 4,
                    axis=-1).astype(np.int32)
    return JScene(materials=[JMaterial((1, 1, 1), 1, 0, (0, 0, 0))], spheres=[], planes=[],
                  meshes=JPackedMeshes(vertices=vertices, normals=np.array([[0.0, 0.0, 1.0]], np.float32),
                                       triangles=tris),
                  camera=JCamera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=1.0))
