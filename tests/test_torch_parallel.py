"""The port's multi-device split (parallel/sharding.py) on meshes of CPU
slots: one process drives every slot, so a mesh of eight CPU slots stands
in for the reference's eight virtual CPU devices (tests/conftest.py).

The port's counterparts of tests/test_parallel.py hold sharded against
sequential renders with the reference's bounds: the per-sample step
against the render_sample sums allclose(1e-4, 1e-4); the free-run split
against the unsharded render of the same samples allclose(2e-5, 2e-5),
its counts exactly. Sums over slots add in another order than one lane
adds its samples, and torch's CPU math rounds a lane apart in tensors of
other lengths (vectorized body, scalar tail), as the reference meets
across XLA programs. A tile-only split at lane counts that are multiples
of 64 rounds alike and is held bitwise.

Against the JAX package: the port's render_freerun_sharded and the
reference's on a (2, 4) mesh, house at 16x16, budget 4, 4 bounces,
one call each (the JAX side compiled once, in a module fixture), with
tests/test_torch_wavefront.py's bounds: counts and shard_counts equal on
>= 99% of entries, image mean within 1e-3 relative, >= 99% of values
isclose(1e-4, 1e-5). Measured here: counts and shard_counts equal
everywhere (the slots unbalanced on 49.6% of pixels), image mean within
3.6e-6 relative, 99.6% of values close (44.7% bit-equal).
Sharded checkpoints cross between the packages, shard_counts included.
"""

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import EnvironmentMaps as JEnvironmentMaps
from rsoderh_raytracing_tpu.env.environment import device_environment as j_device_environment
from rsoderh_raytracing_tpu.parallel.sharding import ShardedRenderer as JShardedRenderer
from rsoderh_raytracing_tpu.parallel.sharding import make_mesh as j_make_mesh
from rsoderh_raytracing_tpu.parallel.sharding import render_freerun_sharded as j_render_freerun_sharded
from rsoderh_raytracing_tpu.render.integrator import camera_pytree as j_camera
from rsoderh_raytracing_tpu.render.renderer import Renderer as JRenderer
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu_torch.env.environment import Environment, EnvironmentMaps, device_environment
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.parallel import sharding
from rsoderh_raytracing_tpu_torch.parallel.sharding import (
    ShardedRenderer,
    dryrun,
    make_mesh,
    render_freerun_sharded,
    render_spp_sharded,
)
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree, render_sample
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import Wavefront, render_freerun, render_wavefront
from rsoderh_raytracing_tpu_torch.scene.camera import Camera
from rsoderh_raytracing_tpu_torch.scene.device import (
    CHUNKED,
    FIELDS,
    build_device_scene,
    device_scene_from_arrays,
    route,
)
from rsoderh_raytracing_tpu_torch.scene.types import Material, PackedMeshes, Scene, Sphere

torch.set_num_threads(2)

RES = (16, 16)
COUNTS_EQUAL_MIN = 0.99
MEAN_RTOL = 1e-3
IMAGE_CLOSE_MIN = 0.99


def cpu_mesh(n, tile=1):
    return make_mesh(n_devices=n, tile=tile, devices=["cpu"] * n)


def _bits(t):
    return np.ascontiguousarray(np.asarray(t)).view(np.uint32)


@pytest.fixture(scope="module")
def small_scene():
    return Scene(
        materials=[
            Material((0.8, 0.7, 0.6), 0.5, 0.0, (0, 0, 0)),
            Material((1, 1, 1), 1.0, 0.0, (2, 2, 2)),
        ],
        spheres=[
            Sphere(pos=[0, 0, -3], radius=1.0, material_id=0),
            Sphere(pos=[2, 1, -4], radius=0.8, material_id=1),
        ],
        planes=[],
        meshes=PackedMeshes.empty(),
        camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=np.radians(90)),
    )


@pytest.fixture(scope="module")
def uniform_args(small_scene):
    env = device_environment(Environment.from_texture("u", np.ones((16, 32, 3), np.float32)), "cpu")
    return build_device_scene(small_scene, "cpu"), env, camera_pytree(small_scene.camera, "cpu")


def test_sample_sharded_equals_sequential(uniform_args):
    summed = render_spp_sharded(*uniform_args, 0, cpu_mesh(8), RES, 4)
    seq = sum(render_sample(*uniform_args, s, RES, 4) for s in range(8))
    assert summed.shape == (16, 16, 3) and summed.device.type == "cpu"
    np.testing.assert_allclose(summed.numpy(), seq.numpy(), rtol=1e-4, atol=1e-4)


def test_tile_sharded_equals_sequential(uniform_args):
    summed = render_spp_sharded(*uniform_args, 0, cpu_mesh(8, tile=4), RES, 4)  # 4 tiles x 2 samples
    seq = sum(render_sample(*uniform_args, s, RES, 4) for s in range(2))
    np.testing.assert_allclose(summed.numpy(), seq.numpy(), rtol=1e-4, atol=1e-4)


def test_sharded_renderer_wrapper(small_scene):
    envs = EnvironmentMaps([Environment.from_texture("u", np.ones((8, 16, 3), np.float32))])
    inner = Renderer(small_scene, width=16, height=16, environments=envs, device="cpu")
    sharded = ShardedRenderer.wrap(inner, "dp:8")
    assert sharded.mesh.shape == {"tile": 1, "sample": 8}
    assert sharded.step() == 8
    assert inner.film.sample_count == 8
    img = sharded.film.mean_radiance()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert ShardedRenderer.wrap(inner, "tile:2, dp:2").mesh.shape == {"tile": 2, "sample": 2}
    for spec in ("dp4", "dp:x", "gpu:2"):
        with pytest.raises(ValueError, match="bad --devices spec"):
            ShardedRenderer.wrap(inner, spec)


@pytest.mark.parametrize("mode", ["exact", "freerun"])
def test_sharded_renderer_render(small_scene, mode):
    envs = EnvironmentMaps([Environment.from_texture("u", np.ones((8, 16, 3), np.float32))])
    inner = Renderer(small_scene, width=16, height=8, environments=envs, max_bounces=3, device="cpu")
    sharded = ShardedRenderer.wrap(inner, "tile:2,dp:2")
    img = sharded.render(spp=5, mode=mode)
    assert img.shape == (8, 16, 3) and np.isfinite(img).all()
    if mode == "exact":
        assert sharded.film.sample_count == 6 and sharded.film.is_uniform
        assert sharded.last_stats is None
    else:
        assert sharded.film.sample_count >= 5 and sharded.last_stats["closest_rays"] > 0
        with pytest.raises(ValueError, match="non-uniform"):
            sharded.render(spp=20)


def test_mesh_validation():
    with pytest.raises(ValueError, match="does not divide"):
        cpu_mesh(8, tile=3)
    with pytest.raises(ValueError, match="requested 9 devices but only 8"):
        make_mesh(n_devices=9, devices=["cpu"] * 8)
    mesh = cpu_mesh(8, tile=2)
    assert mesh.shape == {"tile": 2, "sample": 4} and mesh.distinct() == [torch.device("cpu")]


def test_default_mesh_is_the_cards():
    """Without `devices` the mesh is every CUDA card; without a card it
    raises rather than filling slots with the CPU."""
    if torch.cuda.is_available():
        mesh = make_mesh()
        assert mesh.shape["sample"] == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()


def test_freerun_sharded_exact_cover(uniform_args):
    """With max_bounces=1 every path is one iteration, so a free-run
    budget of B on an S-wide sample axis completes exactly the global
    samples 0..B*S-1 of every pixel."""
    budget = 3
    summed, counts, shard_counts = render_freerun_sharded(
        *uniform_args, np.zeros(RES, np.uint32), cpu_mesh(8, tile=2), RES, budget, 1)
    np.testing.assert_array_equal(counts.numpy(), budget * 4)  # 4 sample shards
    np.testing.assert_array_equal(shard_counts.numpy(), budget)
    expected = render_wavefront(*uniform_args, 0, RES, budget * 4, 1)
    np.testing.assert_allclose(summed.numpy(), expected.numpy(), rtol=2e-5, atol=2e-5)


def test_freerun_sharded_resume(uniform_args):
    """Resuming from the returned counts continues disjoint streams; the
    per-shard resume equals the totals resume where the counts are
    balanced."""
    mesh = cpu_mesh(4)
    img1, c1, sc1 = render_freerun_sharded(*uniform_args, np.zeros(RES, np.uint32), mesh, RES, 2, 1)
    img2, c2, _ = render_freerun_sharded(*uniform_args, c1.numpy().astype(np.uint32), mesh, RES, 2, 1)
    np.testing.assert_array_equal((c1 + c2).numpy(), 16)
    expected = render_wavefront(*uniform_args, 0, RES, 16, 1)
    np.testing.assert_allclose((img1 + img2).numpy(), expected.numpy(), rtol=2e-5, atol=2e-5)
    img2b, c2b, _ = render_freerun_sharded(*uniform_args, sc1, mesh, RES, 2, 1)
    np.testing.assert_array_equal(c2b.numpy(), c2.numpy())
    np.testing.assert_array_equal(_bits(img2b.numpy()), _bits(img2.numpy()))


def test_freerun_sharded_resume_unbalanced(uniform_args):
    """With max_bounces > 1 slots complete unequal per-pixel counts;
    chaining through shard_counts advances each slot's position and the
    reported total is the sum of the slots' increments."""
    mesh = cpu_mesh(4)
    _, c1, sc1 = render_freerun_sharded(*uniform_args, np.zeros(RES, np.uint32), mesh, RES, 5, 3)
    assert tuple(sc1.shape) == (4, 16, 16)
    np.testing.assert_array_equal(sc1.sum(0).numpy(), c1.numpy())
    assert (sc1.amax(0) != sc1.amin(0)).any()
    _, c2, sc2 = render_freerun_sharded(*uniform_args, sc1, mesh, RES, 5, 3)
    assert (sc2 >= sc1).all()
    np.testing.assert_array_equal(sc2.sum(0).numpy(), (c1 + c2).numpy())


def test_tile_only_freerun_equals_unsharded(uniform_args):
    """A (2, 1) mesh: the same lanes through the same code, 128 lanes a
    slot; image and counts bitwise the unsharded render's."""
    base = (np.arange(256, dtype=np.uint32) % 3).reshape(RES)
    img, counts, shard_counts = render_freerun_sharded(*uniform_args, base, cpu_mesh(2, tile=2), RES, 6, 4)
    ref_img, ref_counts = render_freerun(*uniform_args, base, RES, 6, 4)
    np.testing.assert_array_equal(_bits(img.numpy()), _bits(ref_img.numpy()))
    np.testing.assert_array_equal(counts.numpy(), ref_counts.numpy())
    np.testing.assert_array_equal(shard_counts[0].numpy(), base + ref_counts.numpy())


def test_big_scene_sharded_equals_unsharded(big_tri_scene):
    """The big-mesh route (plain chunked sweeps and BIG_SHADE on the CPU)
    shards like the small one: a tiled and sample-sharded free-run equals
    the render of the same global samples (max_bounces=1 makes the budget
    exact)."""
    ds = device_scene_from_arrays({f: np.asarray(getattr(j_build(big_tri_scene, pad_to=1), f))
                                   for f in FIELDS}, device="cpu")
    assert route(ds) == CHUNKED
    sky = procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15)
    args = (ds, device_environment(Environment.from_texture("s", sky), "cpu"),
            camera_pytree(big_tri_scene.camera, "cpu"))
    budget = 2
    summed, counts, _ = render_freerun_sharded(*args, np.zeros(RES, np.uint32), cpu_mesh(8, tile=2),
                                               RES, budget, 1)
    np.testing.assert_array_equal(counts.numpy(), budget * 4)
    expected = render_wavefront(*args, 0, RES, budget * 4, 1)
    np.testing.assert_allclose(summed.numpy(), expected.numpy(), rtol=2e-5, atol=2e-5)


def _fresh(small_scene):
    envs = EnvironmentMaps([Environment.from_texture("u", np.ones((16, 32, 3), np.float32))])
    return Renderer(small_scene, width=16, height=16, environments=envs, max_bounces=3, device="cpu")


def test_sharded_freerun_checkpoint_roundtrip(tmp_path, small_scene):
    """save -> load into a fresh ShardedRenderer (same mesh) -> continue
    equals the uninterrupted run bitwise; another sample-axis width is
    refused."""
    path = str(tmp_path / "shard_ckpt.npz")
    a = ShardedRenderer(_fresh(small_scene), cpu_mesh(4))
    a.step_freerun(5)
    a.save_checkpoint(path)
    a.step_freerun(5)

    b = ShardedRenderer(_fresh(small_scene), cpu_mesh(4))
    b.inner._last_state_hash = b.inner._state_hash()
    b.load_checkpoint(path)
    b.step_freerun(5)
    np.testing.assert_array_equal(a.film.counts.numpy(), b.film.counts.numpy())
    np.testing.assert_array_equal(_bits(a.film.cumulative.numpy()), _bits(b.film.cumulative.numpy()))

    c = ShardedRenderer(_fresh(small_scene), cpu_mesh(2))
    c.inner._last_state_hash = c.inner._state_hash()
    with pytest.raises(ValueError, match="sample axis"):
        c.load_checkpoint(path)


@pytest.fixture(scope="module")
def jax_vs_port(house_scene):
    """render_freerun_sharded of both packages on a (2, 4) mesh."""
    sky = procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15)
    base = np.zeros(RES, np.uint32)
    jimg, jc, jsc = j_render_freerun_sharded(
        j_build(house_scene), j_device_environment(JEnvironment.from_texture("s", sky)),
        j_camera(house_scene.camera), base, j_make_mesh(n_devices=8, tile=2), RES, np.uint32(4), 4)
    timg, tc, tsc = render_freerun_sharded(
        build_device_scene(house_scene, "cpu"), device_environment(Environment.from_texture("s", sky), "cpu"),
        camera_pytree(house_scene.camera, "cpu"), base, cpu_mesh(8, tile=2), RES, 4, 4)
    return dict(jax=(np.asarray(jimg), np.asarray(jc).astype(np.int64), np.asarray(jsc).astype(np.int64)),
                port=(timg.numpy(), tc.numpy(), tsc.numpy()))


@pytest.mark.parametrize("which", [1, 2], ids=["counts", "shard_counts"])
def test_freerun_sharded_counts_match_jax(jax_vs_port, which):
    j, t = jax_vs_port["jax"][which], jax_vs_port["port"][which]
    assert t.shape == j.shape
    assert (t == j).mean() >= COUNTS_EQUAL_MIN


def test_freerun_sharded_image_matches_jax(jax_vs_port):
    ji, ti = jax_vs_port["jax"][0], jax_vs_port["port"][0]
    assert ti.shape == ji.shape == (16, 16, 3) and np.isfinite(ti).all()
    np.testing.assert_allclose(ti.mean(), ji.mean(), rtol=MEAN_RTOL)
    assert np.isclose(ti, ji, rtol=1e-4, atol=1e-5).mean() >= IMAGE_CLOSE_MIN


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sharded_checkpoint_crosses_packages(house_scene, tmp_path, direction):
    """A sharded checkpoint written by one package loads into the other's
    ShardedRenderer on a 4-wide sample axis: film and shard_counts
    bitwise; the reader on a 2-wide axis refuses it."""
    g = np.random.default_rng(3)
    cumulative = g.exponential(0.8, (12, 20, 3)).astype(np.float32)
    shard_counts = g.integers(0, 9, (4, 12, 20)).astype(np.uint32)
    counts = shard_counts.sum(0).astype(np.uint32)
    sky = procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15)
    jr = JRenderer(house_scene, width=20, height=12, max_bounces=4,
                   environments=JEnvironmentMaps([JEnvironment.from_texture("s", sky)]))
    tr = Renderer(house_scene, width=20, height=12, max_bounces=4, device="cpu",
                  environments=EnvironmentMaps([Environment.from_texture("s", sky)]))
    js, ts = JShardedRenderer(jr, j_make_mesh(n_devices=4)), ShardedRenderer(tr, cpu_mesh(4))
    path = str(tmp_path / "ckpt.npz")
    if direction == "jax_to_port":
        import jax.numpy as jnp

        jr.film.add_freerun(jnp.asarray(cumulative), jnp.asarray(counts))
        js._shard_counts = jnp.asarray(shard_counts)
        js.save_checkpoint(path)
        ts.load_checkpoint(path)
    else:
        tr.film.add_freerun(torch.from_numpy(cumulative), torch.from_numpy(counts.astype(np.int64)))
        ts._shard_counts = torch.from_numpy(shard_counts.astype(np.int64))
        ts.save_checkpoint(path)
        js.load_checkpoint(path)
    with np.load(path) as z:
        assert z["shard_counts"].dtype == np.uint32 and z["counts"].dtype == np.uint32
    np.testing.assert_array_equal(_bits(tr.film.cumulative.numpy()), _bits(jr.film.cumulative))
    np.testing.assert_array_equal(tr.film.counts.numpy(), np.asarray(jr.film.counts).astype(np.int64))
    np.testing.assert_array_equal(ts._shard_counts.numpy(), np.asarray(js._shard_counts).astype(np.int64))
    narrow = ShardedRenderer(tr, cpu_mesh(2))
    with pytest.raises(ValueError, match="sample axis"):
        narrow.load_checkpoint(path)


def test_dryrun(capsys):
    dryrun(4, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("dryrun ok: mesh={'tile': 2, 'sample': 2} device=cpu out=(32, 32, 3)")


def test_slots_run_under_their_device(monkeypatch, uniform_args):
    """Every slot's work runs under torch.cuda.device(its device) (a CPU
    slot's context is the no-op index -1), and the free-run slots advance
    iteration by iteration across the slots, not slot after slot."""
    entered, steps = [], []

    class Recorder:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            entered.append(None)

    def step(self, it, **kwargs):
        steps.append((id(self), it, len(entered) % 2 == 1 and entered[-1] == -1))
        return real_step(self, it, **kwargs)

    real_step = Wavefront.step
    monkeypatch.setattr(torch.cuda, "device", Recorder)
    monkeypatch.setattr(Wavefront, "step", step)
    budget, bounces = 2, 2
    render_freerun_sharded(*uniform_args, 0, cpu_mesh(4, tile=2), RES, budget, bounces)
    n_it = budget + bounces - 1
    assert len(steps) == 4 * n_it and all(inside for _, _, inside in steps)
    assert [it for _, it, _ in steps] == [it for it in range(n_it) for _ in range(4)]
    assert len({wave for wave, _, _ in steps}) == 4
    # each slot: its loop state, every iteration, its in_path flag, its results
    assert entered.count(-1) == 4 * (n_it + 3)
    assert sharding._on(torch.device("cuda", 3)).index == torch.device("cuda", 3)
