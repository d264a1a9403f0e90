"""Generate assets/scenes/rtiow_final.toml: the final scene of Peter Shirley's
"Ray Tracing in One Weekend" (raytracing.github.io, book 1, section "Final
Render", random_scene() in main.cc), in the upstream TOML format.

The book's recipe, drawn in its order from numpy's seeded generator (in
place of the book's random_double()):

- for a, b in [-11, 11): a draw chooses the material, then a sphere of
  radius 0.2 at (a + 0.9 r, 0.2, b + 0.9 r), skipped when it lies within
  0.9 of (4, 0.2, 0); 80% lambertian (albedo r * r per channel), 15% metal
  (albedo in [0.5, 1), fuzz in [0, 0.5)), 5% glass;
- three spheres of radius 1: glass at (0, 1, 0), lambertian (0.4, 0.2,
  0.1) at (-4, 1, 0), metal (0.7, 0.6, 0.5) with fuzz 0 at (4, 1, 0);
- the camera from (13, 2, 3) looking at the origin, 20 degrees of
  vertical field of view.

What the renderer cannot express is replaced (CUTS, written into the
file's header): the ground sphere by a finite plane over its footprint,
glass by the smooth dielectric (color 1, roughness 0, metallic 0: the
BSDF has no transmission), lambertian by roughness 1, metal by metallic 1
with roughness = fuzz, the thin lens by a pinhole, the gradient sky by
the HDRI the configuration names, 50 bounces by the renderer's 10.

Deterministic (SEED): run from the repo root,

    python scripts/make_rtiow_scene.py [output.toml]
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

SEED = 2020
GRID = range(-11, 11)
SMALL_RADIUS = 0.2
EXCLUDE_AT = np.array([4.0, 0.2, 0.0])
EXCLUDE_WITHIN = 0.9
LAMBERTIAN_BELOW, METAL_BELOW = 0.8, 0.95
CAMERA_FROM, CAMERA_AT, FOV_Y = np.array([13.0, 2.0, 3.0]), np.zeros(3), 20.0
CUTS = (
    "ground: the radius-1000 sphere at (0,-1000,0) becomes a 2000 x 2000 plane at y = 0, its footprint",
    "glass: the smooth dielectric (color 1, roughness 0, metallic 0); the BSDF has no transmission",
    "lambertian: roughness 1, metallic 0; metal: metallic 1, roughness = fuzz",
    "camera: a pinhole (the book's aperture 0.1 at focus distance 10 is dropped)",
    "sky: the configuration's HDRI in place of the book's gradient",
    "depth: the renderer's 10 bounces in place of 50",
    f"draws: numpy default_rng({SEED}) in place of random_double()",
)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "assets", "scenes", "rtiow_final.toml")


def camera_angles(eye, at):
    """(yaw, pitch) in degrees of the loader's camera (Ry(yaw) @ Rx(pitch),
    looking along -z at yaw 0) whose forward vector points from eye to at."""
    d = (at - eye) / np.linalg.norm(at - eye)
    return math.degrees(math.atan2(-d[0], -d[2])), math.degrees(math.asin(d[1]))


def scene():
    """(materials [(name, color, roughness, metallic)], spheres [(material,
    pos, radius)], kinds of the small spheres ["lambertian" | "metal" |
    "glass"]), in the book's order."""
    rng = np.random.default_rng(SEED)
    materials = [("ground", (0.5, 0.5, 0.5), 1.0, 0.0), ("glass", (1.0, 1.0, 1.0), 0.0, 0.0)]
    spheres, kinds = [], []
    for a in GRID:
        for b in GRID:
            choose = rng.random()
            centre = np.array([a + 0.9 * rng.random(), SMALL_RADIUS, b + 0.9 * rng.random()])
            if np.linalg.norm(centre - EXCLUDE_AT) <= EXCLUDE_WITHIN:
                continue
            if choose < LAMBERTIAN_BELOW:
                name = f"lambertian_{len(materials)}"
                materials.append((name, tuple(rng.random(3) * rng.random(3)), 1.0, 0.0))
                kinds.append("lambertian")
            elif choose < METAL_BELOW:
                name = f"metal_{len(materials)}"
                albedo = tuple(rng.uniform(0.5, 1.0, 3))
                materials.append((name, albedo, float(rng.uniform(0.0, 0.5)), 1.0))
                kinds.append("metal")
            else:
                name = "glass"
                kinds.append("glass")
            spheres.append((name, tuple(centre), SMALL_RADIUS))
    materials += [("big_lambertian", (0.4, 0.2, 0.1), 1.0, 0.0), ("big_metal", (0.7, 0.6, 0.5), 0.0, 1.0)]
    spheres += [("glass", (0.0, 1.0, 0.0), 1.0), ("big_lambertian", (-4.0, 1.0, 0.0), 1.0),
                ("big_metal", (4.0, 1.0, 0.0), 1.0)]
    return materials, spheres, kinds


def _vec(v):
    return "[ " + ", ".join(f"{float(x):.6f}" for x in v) + " ]"


def render_toml() -> str:
    materials, spheres, kinds = scene()
    yaw, pitch = camera_angles(CAMERA_FROM, CAMERA_AT)
    lines = [
        '# "Ray Tracing in One Weekend" (Peter Shirley, raytracing.github.io, book 1),',
        '# section "Final Render": random_scene() in main.cc. Generated by',
        "# scripts/make_rtiow_scene.py; do not edit by hand.",
        f"# {len(spheres)} spheres ({kinds.count('lambertian')} lambertian, {kinds.count('metal')} metal, "
        f"{kinds.count('glass')} glass small ones, and 3 big ones), {len(materials)} materials.",
        "# Cuts from the book:",
    ]
    lines += [f"# - {c}" for c in CUTS]
    lines.append("")
    for name, color, rough, metal in materials:
        lines += ["[[material]]", f'name = "{name}"', f"color = {_vec(color)}", f"roughness = {rough:.6f}",
                  f"metallic = {metal:.1f}", "emission = [ 0, 0, 0 ]", ""]
    lines += ["[[object]]", "[object.Plane]", 'material = "ground"', "pos = [ -1000, 0, -1000 ]",
              "forward = [ 0, 0, 2000 ]", "right = [ 2000, 0, 0 ]", ""]
    for name, pos, radius in spheres:
        lines += ["[[object]]", "[object.Sphere]", f'material = "{name}"', f"pos = {_vec(pos)}",
                  f"radius = {radius:.1f}", ""]
    lines += ["[camera]", f"pos = {_vec(CAMERA_FROM)}", f"pitch = {pitch:.6f}", f"yaw = {yaw:.6f}",
              f"fov_y = {FOV_Y:.1f}", ""]
    return "\n".join(lines)


def main(argv) -> None:
    out = argv[1] if len(argv) > 1 else OUT
    text = render_toml()
    with open(out, "w") as f:
        f.write(text)
    print("wrote", out)


if __name__ == "__main__":
    main(sys.argv)
