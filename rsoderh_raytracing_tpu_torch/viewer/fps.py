"""Frame rate of the terminal viewer's per-frame work, without a terminal
(port of scripts/viewer_fps.py).

    python -m rsoderh_raytracing_tpu_torch.viewer.fps [scene] [width height] [frames]
                                                      [--device cpu]

A viewer frame (viewer/terminal.py run_viewer) is one free-run step of
12 iterations (its freerun_iters default), the tonemapped film read back
to the host and its ANSI half-block text. This runs that frame on
assets/scenes/SCENE.toml (default ``default``) at the viewer's default
256x144, 60 frames after a warm-up frame, in two scenarios:

- converge: the camera stands still and the film accumulates (the
  common case);
- moving: the camera moves 1e-3 in x every frame, so every frame resets
  the film and renders from spp 0 (the worst case).

Prints one JSON line per scenario (metric, scene, resolution, platform,
value in frames/s, ms_per_frame, and the device's name). Runs on the
card unless ``--device`` names another device; it never falls back to
the CPU by itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from rsoderh_raytracing_tpu_torch import _device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FREERUN_ITERS = 12  # run_viewer's freerun_iters default
SCENARIOS = (("converge", False), ("moving", True))
ANSI_COLS, ANSI_ROWS = 100, 40
NUDGE = 1e-3


def frame(renderer, move: bool) -> None:
    """One viewer frame; `move` first nudges the camera as a held
    movement key would."""
    from rsoderh_raytracing_tpu_torch.viewer import terminal

    if move:
        cam = renderer.camera
        renderer.camera = dataclasses.replace(cam, pos=(cam.pos[0] + NUDGE, cam.pos[1], cam.pos[2]))
    renderer.step_freerun(FREERUN_ITERS)
    terminal._render_ansi(renderer.film.tonemapped(), ANSI_COLS, ANSI_ROWS)


def measure(scene_name: str = "default", width: int = 256, height: int = 144, frames: int = 60,
            device=_device.DEFAULT, scenarios=SCENARIOS):
    """Time `frames` viewer frames of each scenario (after a warm-up frame
    each) on one Renderer of the scene on `device`. Returns (one record a
    scenario, the Renderer as the last frame left it)."""
    from rsoderh_raytracing_tpu_torch import load_scene
    from rsoderh_raytracing_tpu_torch.render.renderer import Renderer

    device = _device.resolve(device)
    scene = load_scene(os.path.join(ROOT, "assets", "scenes", f"{scene_name}.toml"))
    renderer = Renderer(scene, width=width, height=height, device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    records = []
    for scenario, move in scenarios:
        frame(renderer, move)  # warm-up: builds the kernels, fills the caches
        start = time.perf_counter()
        for _ in range(frames):
            frame(renderer, move)
        seconds = time.perf_counter() - start
        records.append({
            "metric": f"viewer_fps_{scenario}",
            "scene": scene_name,
            "resolution": f"{width}x{height}",
            "platform": "gpu" if device.type == "cuda" else device.type,
            "value": round(frames / seconds, 2),
            "unit": "frames/s",
            "ms_per_frame": round(1000 * seconds / frames, 2),
            "device": name,
        })
    return records, renderer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("args", nargs="*", metavar="scene [width height] [frames]")
    parser.add_argument("--device", default=_device.DEFAULT,
                        help="the device to render on (default the card)")
    args = parser.parse_args(argv)
    if len(args.args) > 4:
        parser.error("expected at most: scene width height frames")
    scene_name = args.args[0] if args.args else "default"
    width = int(args.args[1]) if len(args.args) > 1 else 256
    height = int(args.args[2]) if len(args.args) > 2 else 144
    frames = int(args.args[3]) if len(args.args) > 3 else 60
    records, _ = measure(scene_name, width, height, frames, args.device)
    for record in records:
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
