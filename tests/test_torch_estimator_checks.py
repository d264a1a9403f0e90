"""The JAX package's estimator checks, run on the port's CPU path with the
reference's own bounds:

- the house anchor golden (tests/goldens/house_anchor_32_4spp.npy, made by
  the independent numpy transcription scripts/reference_estimator.py):
  relative RMSE < 0.5% and >= 98% of values within 1e-3
  (tests/test_reference_estimator.py:test_anchor_derived_golden);
- the suzanne_xhi anchor golden (tests/goldens/suzanne_xhi_anchor_16_2spp.npy,
  the same transcription on 247,808 triangles, which the CPU sweeps on
  the chunked route), by the mesh anchors' flip-aware criteria
  (tests/test_reference_estimator.py:test_suzanne_hi_anchor_golden);
- the white furnace and Monte Carlo convergence (tests/test_golden.py);
- the empty scene's closed form, sky radiance times the power heuristic
  against the environment pdf, recomputed through the JAX package's
  envmap and BSDF code on the port's camera rays, and the directly seen
  emissive sphere (tests/test_integrator.py).
"""

import os

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import device_environment as j_device_environment
from rsoderh_raytracing_tpu.ops import bsdf as j_bsdf
from rsoderh_raytracing_tpu.ops import envmap as j_envmap
from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.env.environment import (
    Environment, device_environment, load_default_environments,
)
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import rng
from rsoderh_raytracing_tpu_torch.render.integrator import (
    camera_pytree, generate_camera_rays, render_sample,
)
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.render.wavefront import render_wavefront
from rsoderh_raytracing_tpu_torch.scene.camera import Camera
from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene
from rsoderh_raytracing_tpu_torch.scene.types import Material, PackedMeshes, Scene, Sphere

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIFORM = np.ones((16, 32, 3), np.float32)


@pytest.fixture(scope="module")
def uniform_env():
    return device_environment(Environment.from_texture("uniform", UNIFORM), device="cpu")


def _empty_scene(materials=None, spheres=()):
    return Scene(
        materials=list(materials or [Material((1, 1, 1), 1.0, 0.0, (0, 0, 0))]),
        spheres=list(spheres), planes=[], meshes=PackedMeshes.empty(),
        camera=Camera(pos=[0, 0, 0], yaw=0.0, pitch=0.0, fov_y=np.radians(90)),
    )


def test_house_anchor_golden():
    """Renderer.step_batch(4) on house at 32x32 against the numpy
    transcription's image."""
    ref = np.load(os.path.join(REPO, "tests", "goldens", "house_anchor_32_4spp.npy"))
    renderer = Renderer(load_scene(os.path.join(REPO, "assets", "scenes", "house.toml")), 32, 32,
                        environments=load_default_environments(), device="cpu")
    renderer.step_batch(4)
    ours = renderer.film.mean_radiance()
    diff = ours - ref
    rel = float(np.sqrt((diff ** 2).mean()) / np.sqrt((ref ** 2).mean()))
    assert rel < 0.005, f"anchored-golden relative RMSE {rel:.4%}"
    assert (np.abs(diff) < 1e-3).mean() > 0.98


def test_suzanne_xhi_anchor_golden(tmp_path):
    """Renderer.step_batch(2) on suzanne_xhi (scripts/subdivide_obj.py 4,
    written here) at 16x16 against the transcription's image, made by
    `python scripts/reference_estimator.py --scene
    assets/scenes/suzanne_xhi.toml --size 16 --spp 2 --out
    tests/goldens/suzanne_xhi_anchor_16_2spp.npy`: under 3% of pixels
    flipped (a channel apart by more than 1e-2), more than 95% within
    1e-4, relative RMSE of the rest < 0.5%."""
    import subprocess
    import sys
    import tomllib

    from rsoderh_raytracing_tpu_torch.scene.toml_loader import build_scene

    mesh = str(tmp_path / "suzanne_xhi.obj")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "subdivide_obj.py"), "4", mesh],
                   check=True, stdout=subprocess.DEVNULL)
    path = os.path.join(REPO, "assets", "scenes", "suzanne_xhi.toml")
    with open(path, "rb") as f:
        descriptor = tomllib.load(f)
    for obj in descriptor["object"]:
        if "Mesh" in obj:
            obj["Mesh"]["path"] = mesh
    ref = np.load(os.path.join(REPO, "tests", "goldens", "suzanne_xhi_anchor_16_2spp.npy"))
    renderer = Renderer(build_scene(descriptor, path), 16, 16, environments=load_default_environments(),
                        device="cpu")
    assert len(renderer.scene.meshes.triangles) == 247808 and renderer.intersector == "sweep"
    renderer.step_batch(2)
    ours = renderer.film.mean_radiance()
    diff = np.abs(ours - ref).max(-1)
    flipped = diff > 1e-2
    assert flipped.mean() < 0.03, f"{flipped.sum()} flipped pixels"
    assert (diff < 1e-4).mean() > 0.95
    keep = ~flipped
    rel = float(np.sqrt(((ours - ref)[keep] ** 2).mean()) / np.sqrt((ref[keep] ** 2).mean()))
    assert rel < 0.005, f"non-flipped relative RMSE {rel:.4%}"


def test_furnace_reflectance_bounded(uniform_env):
    """A white diffuse sphere in a uniform radiance-1 environment: the
    pixels it covers stay near 1 and never above; the background sees the
    environment."""
    scene = Scene(
        materials=[Material((1, 1, 1), 1.0, 0.0, (0, 0, 0))],
        spheres=[Sphere(pos=[0, 0, -2.5], radius=1.0, material_id=0)], planes=[],
        meshes=PackedMeshes.empty(),
        camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=np.radians(60)),
    )
    img = render_wavefront(build_device_scene(scene, "cpu"), uniform_env,
                           camera_pytree(scene.camera, "cpu"), 0, (32, 32), 64, 10).numpy() / 64.0
    center = img[12:20, 12:20]
    assert 0.75 < center.mean() < 1.02
    assert np.all(img[0:2, 0:2] > 0.5)


def test_mc_convergence(assets_dir):
    """Disjoint sample ranges agree within shrinking Monte Carlo noise."""
    scene = load_scene(os.path.join(assets_dir, "scenes", "default.toml"))
    ds = build_device_scene(scene, "cpu")
    env = device_environment(
        Environment.from_texture("golden_sky", procedural_sky(256, 128, sun_radius=0.05)), "cpu")
    cam = camera_pytree(scene.camera, "cpu")

    def mean_of(base, spp):
        return render_wavefront(ds, env, cam, base, (48, 48), spp, 6).numpy() / spp

    a4, b4 = mean_of(0, 4), mean_of(4, 4)
    a16, b16 = mean_of(100, 16), mean_of(116, 16)
    rmse4 = np.sqrt(np.mean((a4 - b4) ** 2))
    rmse16 = np.sqrt(np.mean((a16 - b16) ** 2))
    assert rmse16 < rmse4 * 0.75
    assert rmse16 / np.sqrt(np.mean(a16 ** 2)) < 0.35


def test_empty_scene_matches_closed_form(uniform_env):
    """With no geometry every ray escapes at bounce 0: the image is
    sky * power_heuristic(1, env_pdf(dir)), computed by the JAX package on
    the port's camera rays."""
    scene = _empty_scene()
    size = 32
    img = render_sample(build_device_scene(scene, "cpu"), uniform_env, camera_pytree(scene.camera, "cpu"),
                        0, (size, size)).numpy()
    lane = torch.arange(size * size, dtype=torch.int64)
    state = rng.seed(lane, 0)
    _, _, rd = generate_camera_rays(state, (lane % size).to(torch.int32), (lane // size).to(torch.int32),
                                    camera_pytree(scene.camera, "cpu"), (size, size))
    rd = np.stack([c.numpy() for c in rd], axis=-1)
    j_env = j_device_environment(JEnvironment.from_texture("uniform", UNIFORM))
    sky = np.asarray(j_envmap.sky_light(j_env, rd))
    pdf = np.asarray(j_envmap.direction_pdf(j_env, rd))
    expected = sky * np.asarray(j_bsdf.power_heuristic(1.0, pdf))[:, None]
    np.testing.assert_allclose(img.reshape(-1, 3), expected, rtol=1e-5, atol=1e-6)


def test_emissive_sphere_direct(uniform_env):
    """A pure emitter adds its emission with throughput 1 at bounce 0."""
    scene = _empty_scene(materials=[Material((1, 1, 1), 1.0, 0.0, (5.0, 3.0, 1.0))],
                         spheres=[Sphere(pos=[0, 0, -3], radius=1.0, material_id=0)])
    img = render_sample(build_device_scene(scene, "cpu"), uniform_env, camera_pytree(scene.camera, "cpu"),
                        0, (64, 64)).numpy()
    center = img[30:34, 30:34].reshape(-1, 3)
    assert (center >= np.float32([5.0, 3.0, 1.0]) - 1e-4).all()
