"""scripts/compare_renders.py (numpy only) on the port's outputs: the
film checkpoint (.npz) and the PNG of the port's Renderer, driven by
subprocess with the script's --max-relative-rmse exit codes, so the
script serves both packages and the port needs no copy of it.
"""

import os
import subprocess
import sys

import pytest
import torch

from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.env.environment import Environment, EnvironmentMaps
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "compare_renders.py")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """house at 16x16 after 1 and after 8 samples, and at 16x8, as .npz
    checkpoints and PNGs."""
    out = tmp_path_factory.mktemp("renders")
    envs = EnvironmentMaps([Environment.from_texture("s", procedural_sky(64, 32))])
    scene = load_scene(os.path.join(REPO, "assets", "scenes", "house.toml"))
    paths = {}
    for name, (width, height, spp) in {"one": (16, 16, 1), "eight": (16, 16, 8),
                                       "wide": (16, 8, 8)}.items():
        r = Renderer(scene, width, height, environments=envs, max_bounces=4, device="cpu")
        r.render(spp=spp)
        for ext in ("npz", "png"):
            paths[f"{name}.{ext}"] = str(out / f"{name}.{ext}")
        r.save_checkpoint(paths[f"{name}.npz"])
        r.save_png(paths[f"{name}.png"])
    return paths


def _compare(reference, test, *extra):
    return subprocess.run([sys.executable, SCRIPT, reference, test, *extra],
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("ext", ["npz", "png"])
def test_same_render_passes(outputs, ext):
    proc = _compare(outputs[f"eight.{ext}"], outputs[f"eight.{ext}"], "--max-relative-rmse", "0")
    assert proc.returncode == 0, proc.stderr
    assert "relative rmse:  0.000%" in proc.stdout


@pytest.mark.parametrize("ext", ["npz", "png"])
def test_fewer_samples_fail_a_tight_bound(outputs, ext):
    """One sample against eight: a relative RMSE past 1e-3 exits 1; a loose
    bound passes the same pair."""
    proc = _compare(outputs[f"eight.{ext}"], outputs[f"one.{ext}"], "--max-relative-rmse", "0.001")
    assert proc.returncode == 1 and "FAIL: relative RMSE" in proc.stderr
    assert _compare(outputs[f"eight.{ext}"], outputs[f"one.{ext}"], "--max-relative-rmse",
                    "100").returncode == 0


def test_shape_mismatch_exits(outputs):
    proc = _compare(outputs["eight.npz"], outputs["wide.npz"])
    assert proc.returncode == 1 and "shape mismatch" in proc.stderr
