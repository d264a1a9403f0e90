"""Why the port's sphere hit t and the JAX package's part on far grazing rays.

    JAX_PLATFORMS=cpu python scripts/sphere_rounding.py

On the far sphere cloud of tests/test_torch_bvh.py (100 spheres, 2,048
rays from up to 18 units out), both packages' BVH walks find the same
sphere on every ray but their t differ beyond isclose(1e-5, 1e-6) on a
few. This script:

1. lowers and compiles the reference's ``bvh_traverse._sphere_t`` with
   ``jax.jit(...).lower(...).compile()`` on the CPU, with XLA's dump
   under build/xla_sphere_t/, and counts the fused multiply-add
   instructions (vfmadd/vfmsub/vfnmadd/vfnmsub) in each fusion's object
   code (objdump);
2. evaluates the sphere test of each ray that both packages hit in numpy
   twice: as the port writes it (every product and sum rounded to f32)
   and with XLA's contractions (each of the three dot products a chain of
   fused multiply-adds, c = l.l - r*r and disc = b*b - 4ac each one fused
   multiply-add; inside the walk's while-loop XLA fuses l.l too, which
   the standalone compile above leaves as products and sums), each fused
   multiply-add exact (fractions) and rounded once to f32;
3. prints, over those rays and over the rays whose t are not isclose,
   how many of each package's t equal each evaluation bit for bit.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import sys
from fractions import Fraction

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMP = os.path.join(ROOT, "build", "xla_sphere_t")
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={DUMP}"
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from rsoderh_raytracing_tpu.ops import bvh_traverse as j_walk  # noqa: E402
from rsoderh_raytracing_tpu.scene import device as j_device  # noqa: E402
from rsoderh_raytracing_tpu.scene.camera import Camera  # noqa: E402
from rsoderh_raytracing_tpu.scene.types import Material, PackedMeshes, Scene, Sphere  # noqa: E402
from rsoderh_raytracing_tpu_torch.accel import bvh as t_bvh  # noqa: E402
from rsoderh_raytracing_tpu_torch.ops import bvh as t_walk  # noqa: E402
from rsoderh_raytracing_tpu_torch.scene.device import FIELDS, device_scene_from_arrays  # noqa: E402

F32 = np.float32
SPHERE_EPS = F32(1.0e-4)
INF = F32(3.0e38)


def far_cloud(n=2048):
    """tests/test_torch_bvh.py's far_cloud walk case."""
    rng = np.random.default_rng(1)
    spheres = [Sphere(pos=rng.uniform(-10, 10, 3), radius=float(rng.uniform(0.1, 1.0)),
                      material_id=0) for _ in range(100)]
    scene = Scene(materials=[Material((1, 1, 1), 1, 0, (0, 0, 0))], spheres=spheres, planes=[],
                  meshes=PackedMeshes.empty(), camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=1.0))
    rng = np.random.default_rng(5)
    ro = rng.uniform(-6.0, 6.0, (n, 3)).astype(F32)
    rd = rng.normal(size=(n, 3)).astype(F32)
    half = n // 2
    ro[half:] *= F32(3.0)
    rd[half:] = -ro[half:] + rng.normal(size=(n - half, 3)).astype(F32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return scene, ro, rd


def fma_instructions():
    """{fusion: fused multiply-adds in its object code} of the compiled
    reference _sphere_t."""
    shutil.rmtree(DUMP, ignore_errors=True)
    x = jnp.ones((2048, 3), jnp.float32)
    jax.jit(j_walk._sphere_t).lower(x, x, x, jnp.ones((2048,), jnp.float32)).compile()
    out = {}
    tool = shutil.which("objdump")
    for obj in sorted(glob.glob(os.path.join(DUMP, "*jit__sphere_t*.o"))):
        text = subprocess.run([tool, "-d", obj], capture_output=True, text=True).stdout if tool else ""
        fusion = obj.split("obj-file.")[-1].replace("_kernel_module.o", "")
        out[fusion] = sum(op in line for line in text.splitlines()
                          for op in ("vfmadd", "vfmsub", "vfnmadd", "vfnmsub"))
    return out


def round_f32(q: Fraction) -> F32:
    """q rounded once to the nearest f32 (ties to even)."""
    a = F32(float(q))
    cands = (a, np.nextafter(a, F32(np.inf)), np.nextafter(a, F32(-np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q), int(np.array(c).view(np.int32)) & 1))


def fma(x, y, z):
    return round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))


def sphere_t(o, d, c, r, contracted):
    """The reference's _sphere_t on one ray in f32: unfused, or with the
    contractions of XLA's object code."""
    lv = [F32(o[k] - c[k]) for k in range(3)]
    if contracted:
        def dot(x, y):
            return fma(x[2], y[2], fma(x[1], y[1], F32(x[0] * y[0])))
        a = dot(d, d)
        b = F32(2.0) * dot(d, lv)
        cc = fma(-r, r, dot(lv, lv))
        disc = fma(b, b, -F32(F32(F32(4.0) * a) * cc))
    else:
        def dot(x, y):
            return F32(F32(F32(x[0] * y[0]) + F32(x[1] * y[1])) + F32(x[2] * y[2]))
        a = dot(d, d)
        b = F32(2.0) * dot(d, lv)
        cc = F32(dot(lv, lv) - F32(r * r))
        disc = F32(F32(b * b) - F32(F32(F32(4.0) * a) * cc))
    sq = F32(np.sqrt(max(disc, F32(0.0))))
    q = F32(F32(-0.5) * F32(b + sq)) if b > 0 else F32(F32(-0.5) * F32(b - sq))
    t0 = F32(q / a)
    t1 = F32(cc / (q if q != 0 else F32(1.0)))
    t = t1 if t0 < SPHERE_EPS else (t0 if t1 < SPHERE_EPS else min(t0, t1))
    if disc == 0.0:
        t = F32(F32(F32(-0.5) * b) / a)
    return t if (disc >= 0.0 and t >= SPHERE_EPS) else INF


def main() -> int:
    for fusion, n in fma_instructions().items():
        print(f"[xla_fma] fusion={fusion} fused_multiply_adds={n}")
    scene, ro, rd = far_cloud()
    flat = t_bvh.build_bvh(scene)
    os.environ["RT_DISABLE_MORTON"] = "1"
    js = j_device.build_device_scene(scene)
    js = js.__class__(**{**js.__dict__, "bvh": j_walk.device_bvh(flat)})
    jt, jslot = jax.jit(lambda s, o, d: j_walk.traverse_closest(s, s.bvh, o, d))(
        js, jnp.asarray(ro), jnp.asarray(rd))
    jt, jslot = np.asarray(jt), np.asarray(jslot)
    ts = device_scene_from_arrays({f: np.asarray(getattr(js, f)) for f in FIELDS}, "cpu", flat)
    tro = tuple(torch.from_numpy(np.ascontiguousarray(ro[:, k])) for k in range(3))
    trd = tuple(torch.from_numpy(np.ascontiguousarray(rd[:, k])) for k in range(3))
    pt, pslot = (a.numpy() for a in t_walk.traverse_closest(ts.bvh, tro, trd))
    both = np.nonzero((pslot >= 0) & (pslot == jslot))[0]
    idx = np.asarray(flat.prim_index)[pslot[both]]
    centers = np.asarray([s.pos for s in scene.spheres], F32)
    radii = np.asarray([s.radius for s in scene.spheres], F32)
    apart = ~np.isclose(pt[both], jt[both], rtol=1e-5, atol=1e-6)
    evals = {mode: np.array([sphere_t(ro[i], rd[i], centers[k], radii[k], mode == "contracted")
                             for i, k in zip(both, idx)]) for mode in ("unfused", "contracted")}
    print(f"[sphere_t] rays={len(ro)} same_sphere={len(both)} t_not_isclose={int(apart.sum())} "
          f"t_bitwise_differ={int((pt[both] != jt[both]).sum())}")
    for who, t in (("port", pt[both]), ("reference", jt[both])):
        for mode, e in evals.items():
            print(f"[sphere_t] package={who} evaluation={mode} "
                  f"equal={int((t == e).sum())}/{len(both)} "
                  f"equal_where_apart={int((t == e)[apart].sum())}/{int(apart.sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
