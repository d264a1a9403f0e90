"""The port's viewer frame-rate tool (viewer/fps.py) on the CPU, at 32x18
and 2 frames a scenario.

Its JSON lines carry scripts/viewer_fps.py's keys (and the device's
name); a moving frame leaves the film a fresh Renderer's one
step_freerun(12) at the nudged camera, bitwise; still frames leave it
every frame's samples, bitwise as many steps of a fresh Renderer; and
the frame's ANSI text at the tool's 100x40 cells is the JAX package's
string for the same seeded image.
"""

import json

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu.viewer import terminal as j_terminal
from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer
from rsoderh_raytracing_tpu_torch.viewer import fps, terminal

torch.set_num_threads(2)

WIDTH, HEIGHT, FRAMES = 32, 18, 2
# The keys of scripts/viewer_fps.py's lines.
REFERENCE_KEYS = {"metric", "scene", "resolution", "platform", "value", "unit", "ms_per_frame"}


def _fresh(renderer):
    """A fresh CPU Renderer of the tool's scene at its size and camera."""
    scene = load_scene(f"{fps.ROOT}/assets/scenes/default.toml")
    fresh = Renderer(scene, width=WIDTH, height=HEIGHT, device="cpu")
    fresh.camera = renderer.camera
    return fresh


def _same_film(a, b):
    assert torch.equal(a.film.counts, b.film.counts)
    assert torch.equal(a.film.cumulative.view(torch.int32), b.film.cumulative.view(torch.int32))


def test_lines_carry_the_reference_keys(capsys):
    assert fps.main(["default", str(WIDTH), str(HEIGHT), str(FRAMES), "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in lines] == ["viewer_fps_converge", "viewer_fps_moving"]
    for r in lines:
        assert set(r) == REFERENCE_KEYS | {"device"}
        assert (r["scene"], r["resolution"], r["platform"], r["device"], r["unit"]) == (
            "default", f"{WIDTH}x{HEIGHT}", "cpu", "cpu", "frames/s")
        assert r["value"] > 0 and r["ms_per_frame"] > 0


def test_moving_frame_is_a_fresh_step_at_the_nudged_camera():
    _, renderer = fps.measure("default", WIDTH, HEIGHT, FRAMES, "cpu", scenarios=(("moving", True),))
    start = load_scene(f"{fps.ROOT}/assets/scenes/default.toml").camera.pos
    assert renderer.camera.pos[0] != start[0]
    assert renderer.film.sample_count >= 1
    fresh = _fresh(renderer)
    fresh.step_freerun(fps.FREERUN_ITERS)
    _same_film(renderer, fresh)


def test_converge_film_holds_every_frames_samples():
    _, renderer = fps.measure("default", WIDTH, HEIGHT, FRAMES, "cpu", scenarios=(("converge", False),))
    fresh = _fresh(renderer)
    one = None
    for _ in range(FRAMES + 1):  # the warm-up frame and the timed ones
        fresh.step_freerun(fps.FREERUN_ITERS)
        one = fresh.film.counts.clone() if one is None else one
    _same_film(renderer, fresh)
    assert int(renderer.film.counts.sum()) > FRAMES * int(one.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_text_is_the_references(seed):
    image = np.random.default_rng(seed).uniform(0.0, 1.2, (144, 256, 3)).astype(np.float32)
    got = terminal._render_ansi(image, fps.ANSI_COLS, fps.ANSI_ROWS)
    assert got == j_terminal._render_ansi(image, fps.ANSI_COLS, fps.ANSI_ROWS)
