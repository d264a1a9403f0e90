"""The port's command line on the CPU (``--device cpu``): PNG and .hdr
output, checkpoint save and resume, the multi-device split on CPU slots
(``--devices``), the viewer's refusal without a TTY (``--view``; the
viewer itself: tests/test_torch_viewer.py), and the exit codes.

``--hdri-dir`` points at a directory with one small .npy environment, so
a run does not build the alias tables of the two 2k default HDRIs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu_torch import cli, load_scene
from rsoderh_raytracing_tpu_torch.env.environment import load_default_environments
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky, read_hdr
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.utils.png import read_png

torch.set_num_threads(2)

RES = "20x12"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def hdri_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("hdri")
    np.save(path / "sky.npy", procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15))
    return str(path)


@pytest.fixture
def base(assets_dir, hdri_dir):
    return ["--scene", f"{assets_dir}/scenes/house.toml", "--resolution", RES, "--device", "cpu",
            "--hdri-dir", hdri_dir, "--max-bounces", "4"]


def reference_film(assets_dir, hdri_dir, spp, mode):
    scene = load_scene(f"{assets_dir}/scenes/house.toml")
    r = Renderer(scene, 20, 12, environments=load_default_environments(hdri_dir), max_bounces=4,
                 device="cpu")
    r.render(spp=spp, mode=mode)
    return r.film


@pytest.mark.parametrize("mode", ["exact", "freerun"])
def test_cli_writes_the_films_png(base, assets_dir, hdri_dir, tmp_path, capsys, mode):
    out = str(tmp_path / "out.png")
    assert cli.main(base + ["--spp", "3", "--mode", mode, "--output", out]) == 0
    film = reference_film(assets_dir, hdri_dir, 3, mode)
    np.testing.assert_array_equal(read_png(out), film.srgb8())
    printed = capsys.readouterr().out
    assert f"at 20x12, {film.sample_count} spp" in printed and "camera state:" in printed
    assert ("wavefront iterations" in printed) == (mode == "freerun")


def test_cli_hdr_checkpoint_and_resume(base, tmp_path, capsys):
    hdr, ckpt, ckpt2 = (str(tmp_path / n) for n in ("out.hdr", "a.npz", "b.npz"))
    assert cli.main(base + ["--spp", "2", "--output", hdr, "--save-checkpoint", ckpt, "--quiet"]) == 0
    assert capsys.readouterr().out == ""
    image = read_hdr(hdr)
    assert image.shape == (12, 20, 3) and np.isfinite(image).all() and image.mean() > 0
    assert cli.main(base + ["--spp", "5", "--checkpoint", ckpt, "--save-checkpoint", ckpt2,
                            "--output", str(tmp_path / "b.png")]) == 0
    assert f"Resumed from {ckpt} at 2 spp" in capsys.readouterr().out
    with np.load(ckpt) as a, np.load(ckpt2) as b:
        assert int(a["sample_count"]) == 2 and int(b["sample_count"]) == 5
        assert a["counts"].dtype == np.uint32 and (b["counts"] == 5).all()
        # samples 2..4 were added to the loaded sums, nothing was reset
        assert (b["cumulative"] >= a["cumulative"]).all()
        np.testing.assert_array_equal(a["state_stamp"], b["state_stamp"])


def test_cli_resume_under_another_camera_is_refused(base, tmp_path):
    ckpt = str(tmp_path / "a.npz")
    assert cli.main(base + ["--spp", "1", "--save-checkpoint", ckpt, "--quiet",
                            "--output", str(tmp_path / "a.png")]) == 0
    state = load_scene(base[1]).camera
    state.pos = np.asarray(state.pos, np.float32) + np.float32(1.0)
    with pytest.raises(ValueError, match="different"):
        cli.main(base + ["--spp", "2", "--checkpoint", ckpt, "--state", state.serialize(),
                         "--output", str(tmp_path / "b.png")])


@pytest.mark.parametrize("extra,code,message", [
    (["--resolution", "20"], 2, "expected WxH"),
    (["--view"], 2, "not a TTY"),
    (["--movement-keys", "wasd"], 2, "Invalid keyboard config"),
    (["--scene", "no/such/scene.toml"], 1, "scene.toml"),
])
def test_cli_exit_codes(base, capsys, extra, code, message):
    assert cli.main(base + extra) == code
    assert message in capsys.readouterr().err


def test_cli_devices_splits_over_cpu_slots(base, tmp_path, capsys):
    """--devices dp:4 with --device cpu: four samples at once on four CPU
    slots (parallel/sharding.py), one step of the ShardedRenderer."""
    out, ckpt = str(tmp_path / "x.png"), str(tmp_path / "x.npz")
    assert cli.main(base + ["--devices", "dp:4", "--spp", "4", "--output", out,
                            "--save-checkpoint", ckpt]) == 0
    assert read_png(out).shape == (12, 20, 3)
    assert "sample 4/4" in capsys.readouterr().out
    with np.load(ckpt) as z:
        assert int(z["sample_count"]) == 4 and (z["counts"] == 4).all()
        assert "shard_counts" not in z.files  # exact steps leave a prefix


def test_cli_devices_on_cuda_needs_the_cards(base, tmp_path):
    """--devices dp:2 --device cuda never renders on the CPU: without a
    card it raises the device error, with one card the mesh's."""
    args = ["cuda" if a == "cpu" else a for a in base]
    args += ["--devices", "dp:2", "--spp", "2", "--output", str(tmp_path / "a.png")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(args)
    elif torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="requested 2 devices but only 1"):
            cli.main(args)
    else:
        assert cli.main(args) == 0


def test_cli_bvh_is_not_ported(base, tmp_path):
    """--intersector bvh is ported now: it renders through the BVH route
    (the name is the test's since the flag was refused)."""
    assert cli.main(base + ["--intersector", "bvh", "--spp", "1", "--output",
                            str(tmp_path / "bvh.png")]) == 0
    assert (tmp_path / "bvh.png").exists()


def test_cli_defaults_to_the_card(base, tmp_path):
    args = [a for a in base if a not in ("--device", "cpu")] + ["--spp", "1", "--output",
                                                                str(tmp_path / "a.png")]
    if torch.cuda.is_available():
        assert cli.main(args) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(args)


def test_module_entry_point(base, tmp_path):
    out = str(tmp_path / "m.png")
    proc = subprocess.run(
        [sys.executable, "-m", "rsoderh_raytracing_tpu_torch", *base, "--spp", "1", "--output", out],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert read_png(out).shape == (12, 20, 3)
