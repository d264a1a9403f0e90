"""Port scene upload (scene/device.py) against the JAX reference, the
port's routes and device defaults, and its independence from jax and
from the JAX package.

build_device_scene runs the same numpy body with the same padding rules,
so every field must equal the reference's lane for lane, bitwise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu import load_scene
from rsoderh_raytracing_tpu.scene.device import build_device_scene as j_build
from rsoderh_raytracing_tpu.scene.types import PackedMeshes, Plane, Scene
from rsoderh_raytracing_tpu_torch import load_scene as t_load_scene
from rsoderh_raytracing_tpu_torch.env.environment import (
    Environment,
    device_environment,
    device_environment_from_arrays,
)
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.wavefront import render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import (
    CHUNKED,
    FIELDS,
    SMALL,
    build_device_scene,
    device_scene_from_arrays,
    route,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(assets_dir, name):
    return load_scene(os.path.join(assets_dir, "scenes", f"{name}.toml"))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype == bool else a.view(np.uint32)


@pytest.mark.parametrize("name", ["default", "house", "suzanne", "spheres"])
def test_build_device_scene_bitwise(assets_dir, name):
    scene = _scene(assets_dir, name)
    ref = j_build(scene)
    got = build_device_scene(scene, device="cpu")
    for field in FIELDS:
        r = np.asarray(getattr(ref, field))
        g = getattr(got, field).numpy()
        assert g.shape == r.shape, field
        assert g.dtype == r.dtype, field
        np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=field)


def test_device_scene_from_arrays_round_trip(assets_dir):
    scene = _scene(assets_dir, "house")
    ref = j_build(scene)
    got = device_scene_from_arrays({f: np.asarray(getattr(ref, f)) for f in FIELDS}, device="cpu")
    direct = build_device_scene(scene, device="cpu")
    assert got.num_lanes == 72
    for field in FIELDS:
        np.testing.assert_array_equal(
            _bits(getattr(got, field).numpy()), _bits(getattr(direct, field).numpy())
        )


def test_big_scene_route_not_ported(assets_dir):
    """A scene past the unroll budget that the chunked route does not
    cover (here 200 plane lanes: planes never leave the unrolled step)
    still raises, naming the BVH route."""
    scene = _scene(assets_dir, "suzanne")
    scene = Scene(
        materials=scene.materials,
        spheres=[],
        planes=[Plane(pos=(float(i), -1.0, -4.0), right=(0.5, 0.0, 0.0), forward=(0.0, 0.0, 0.5),
                      material_id=0) for i in range(200)],
        meshes=PackedMeshes(vertices=np.zeros((0, 3), np.float32),
                            normals=np.zeros((0, 3), np.float32),
                            triangles=np.zeros((0, 7), np.int32)),
        camera=scene.camera,
    )
    ds = build_device_scene(scene, device="cpu")
    assert ds.num_lanes > 192 and ds.chunks is None
    env = device_environment(Environment.from_texture("s", procedural_sky(32, 16)), device="cpu")
    with pytest.raises(NotImplementedError, match="BVH route"):
        render_freerun(ds, env, camera_pytree(scene.camera, device="cpu"), 0, (8, 8), 4, 4)


@pytest.mark.parametrize("name,expected", [("house", SMALL), ("suzanne", CHUNKED),
                                           ("suzanne_hi", CHUNKED), ("spheres", CHUNKED)])
def test_scene_routes(assets_dir, name, expected):
    assert route(build_device_scene(_scene(assets_dir, name), device="cpu")) == expected


@pytest.mark.parametrize("entry", ["build_device_scene", "device_scene_from_arrays",
                                   "device_environment", "device_environment_from_arrays",
                                   "camera_pytree"])
def test_entry_points_default_to_the_card(assets_dir, entry):
    """Each entry point puts its tensors on the card unless asked
    otherwise, and raises where there is no card: never a silent CPU."""
    scene = t_load_scene(os.path.join(assets_dir, "scenes", "house.toml"))
    env = Environment.from_texture("s", procedural_sky(16, 8))
    host = build_device_scene(scene, device="cpu")
    calls = {
        "build_device_scene": lambda: build_device_scene(scene).sph_pos,
        "device_scene_from_arrays": lambda: device_scene_from_arrays(
            {f: getattr(host, f).numpy() for f in FIELDS}).sph_pos,
        "device_environment": lambda: device_environment(env).quad,
        "device_environment_from_arrays": lambda: device_environment_from_arrays(
            (8, 16), np.zeros((128, 4), np.uint32), np.zeros((128, 4), np.float32),
            np.ones(2, np.float32)).quad,
        "camera_pytree": lambda: camera_pytree(scene.camera)["pos"],
    }
    if torch.cuda.is_available():
        assert calls[entry]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            calls[entry]()


_NO_JAX = r"""
import sys

BLOCKED = ("jax", "jaxlib", "rsoderh_raytracing_tpu")


def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"{name} is blocked in this process")
        return None

sys.meta_path.insert(0, BlockJax())
import os
import numpy as np
import torch
torch.set_num_threads(2)
import chip_smoke  # every module the GPU smoke run imports
import rsoderh_raytracing_tpu_torch as port
from rsoderh_raytracing_tpu_torch import cli, load_scene, write_png
from rsoderh_raytracing_tpu_torch.env.environment import Environment, EnvironmentMaps, device_environment
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront, tonemap
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene
from rsoderh_raytracing_tpu_torch.accel import bvh as accel_bvh, native as accel_native
from rsoderh_raytracing_tpu_torch.ops import bvh as ops_bvh

host_env = Environment.from_texture("s", procedural_sky(64, 32))
env = device_environment(host_env, device="cpu")
for name, size, with_bvh in (("house", 16, False), ("suzanne", 8, False), ("house", 8, True)):
    scene = load_scene(f"assets/scenes/{name}.toml")
    ds = build_device_scene(scene, device="cpu", with_bvh=with_bvh)
    assert (ds.bvh is not None) == with_bvh
    img, counts = render_freerun(ds, env, camera_pytree(scene.camera, device="cpu"), 0,
                                 (size, size), 4, 4)
    assert img.shape == (size, size, 3) and bool(torch.isfinite(img).all())
    assert int(counts.min()) > 0
    write_png(os.devnull, tonemap.linear_to_srgb(tonemap.aces_tonemap(img / counts[..., None])).numpy())
# a treelet-ordered chunked scene (scene.cluster): pad rows between real triangles
os.environ["RT_CHUNK_CLUSTER"] = "treelet"
from rsoderh_raytracing_tpu_torch.scene import cluster
from rsoderh_raytracing_tpu_torch.scene.device import CHUNKED, route
scene = load_scene("assets/scenes/suzanne.toml")
treelet = build_device_scene(scene, device="cpu")
del os.environ["RT_CHUNK_CLUSTER"]
valid = treelet.tri_valid.reshape(-1, 64)
assert route(treelet) == CHUNKED and int(valid.sum()) == 968 and bool((~valid[:-1]).any())
img, counts = render_freerun(treelet, env, camera_pytree(scene.camera, device="cpu"), 0, (8, 8), 4, 4)
assert bool(torch.isfinite(img).all()) and int(counts.min()) > 0
# the Renderer (scan integrator, wavefront, film) and the command line
scene = load_scene("assets/scenes/house.toml")
renderer = Renderer(scene, 12, 8, environments=EnvironmentMaps([host_env]), max_bounces=3, device="cpu")
assert renderer.step() == 1 and renderer.step_batch(2) == 3
assert renderer.film.srgb8().shape == (8, 12, 3)
assert port.render(scene, 12, 8, spp=1, environments=EnvironmentMaps([host_env]), device="cpu").shape == (8, 12, 3)
np.save(os.path.join(os.environ["PORT_TEST_TMP"], "sky.npy"), procedural_sky(32, 16))
assert cli.main(["--scene", "assets/scenes/house.toml", "--resolution", "12x8", "--spp", "2",
                 "--max-bounces", "3", "--device", "cpu", "--hdri-dir", os.environ["PORT_TEST_TMP"],
                 "--output", os.path.join(os.environ["PORT_TEST_TMP"], "o.png"), "--quiet"]) == 0
assert os.environ["RT_DEBUG_NANS"] == "1"
assert not [m for m in sys.modules if blocked(m)]
assert "rsoderh_raytracing_tpu_torch.ops.cuda_intersect" in sys.modules
assert "rsoderh_raytracing_tpu_torch.scene.cluster" in sys.modules
assert accel_native.available() and isinstance(ds.bvh, ops_bvh.DeviceBVH)
assert accel_bvh.TRAVERSAL_STACK_DEPTH == 64
print("ok")
"""


def test_port_imports_and_renders_without_jax(tmp_path):
    # Neither jax nor the JAX package may be imported: chip_smoke.py and
    # the port render house (small route), suzanne (big-mesh route),
    # house with its BVH (the BVH modules: accel.bvh, accel.native,
    # ops.bvh) and suzanne in the treelet order (scene.cluster), and the
    # Renderer and the command line render house, with
    # RT_DEBUG_NANS=1 set, the JAX package's switch that imports jax.
    env = dict(os.environ, PYTHONPATH=REPO, RT_DEBUG_NANS="1", PORT_TEST_TMP=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
