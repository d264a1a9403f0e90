"""Port scene upload (scene/device.py) against the JAX reference, and the
port's independence from jax.

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
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.wavefront import render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import (
    FIELDS,
    build_device_scene,
    device_scene_from_arrays,
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
    got = build_device_scene(scene)
    for field in FIELDS:
        r = np.asarray(getattr(ref, field))
        g = getattr(got, field).numpy()
        assert g.shape == r.shape, field
        assert g.dtype == r.dtype, field
        np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=field)


def test_device_scene_from_arrays_round_trip(assets_dir):
    scene = _scene(assets_dir, "house")
    ref = j_build(scene)
    got = device_scene_from_arrays({f: np.asarray(getattr(ref, f)) for f in FIELDS})
    direct = build_device_scene(scene)
    assert got.num_lanes == 72
    for field in FIELDS:
        np.testing.assert_array_equal(
            _bits(getattr(got, field).numpy()), _bits(getattr(direct, field).numpy())
        )


def test_big_scene_route_not_ported(assets_dir):
    scene = _scene(assets_dir, "suzanne")
    ds = build_device_scene(scene)
    env = device_environment(Environment.from_texture("s", procedural_sky(32, 16)))
    with pytest.raises(NotImplementedError, match="big-scene route"):
        render_freerun(ds, env, camera_pytree(scene.camera), 0, (8, 8), 4, 4)


_NO_JAX = r"""
import sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this process")
        return None

sys.meta_path.insert(0, BlockJax())
import os
import numpy as np
import torch
torch.set_num_threads(2)
import chip_smoke  # every module the GPU smoke run imports
from rsoderh_raytracing_tpu_torch import load_scene, write_png
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront, tonemap
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.wavefront import render_freerun
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene

scene = load_scene("assets/scenes/house.toml")
env = device_environment(Environment.from_texture("s", procedural_sky(64, 32)))
img, counts = render_freerun(build_device_scene(scene), env, camera_pytree(scene.camera),
                             0, (16, 16), 4, 4)
assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
assert int(counts.min()) > 0
write_png(os.devnull, tonemap.linear_to_srgb(tonemap.aces_tonemap(img / counts[..., None])).numpy())
assert os.environ["RT_DEBUG_NANS"] == "1"
assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]
print("ok")
"""


def test_port_imports_and_renders_without_jax():
    # RT_DEBUG_NANS=1 makes the reference package's __init__ import jax;
    # the port must hide it from that import.
    env = dict(os.environ, PYTHONPATH=REPO, RT_DEBUG_NANS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
