"""The scan integrator: one path-traced sample per pixel (port of
rsoderh_raytracing_tpu/render/integrator.py).

Every pixel's path steps through ``max_bounces`` bounces, dead lanes
masked; the reference's ``lax.scan`` is a Python loop here. Each bounce
runs the closest-hit query on the live lanes and the NEE occlusion query
on the live lanes that hit (``ops/intersect.py``: the CLOSEST and ANY
kernels on the card for a small scene, CLOSEST writing the hit record and
material values itself; the chunked kernels or the BVH walks and a row
gather on a big one) between plain PyTorch glue. Every later use of
their answers is masked by the same lanes, so a dead lane's record
changes nothing. The RNG
of every lane advances every bounce, dead lanes too: four draws for the
environment sample, then two for the bounce, so each (pixel, sample)
stream equals the wavefront integrator's and the reference's.

Vectors are 3-tuples of (n,) tensors; the RNG state is int64 holding u32
values (ops/rng.py).
"""

from __future__ import annotations

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device, tracing
from rsoderh_raytracing_tpu_torch.ops import bsdf, envmap, intersect, rng

MAX_BOUNCES = 10  # shader.wgsl:232
THROUGHPUT_CUTOFF = 0.001  # shader.wgsl:1289


def generate_camera_rays(state, pixel_x, pixel_y, camera, resolution):
    """Jittered pinhole rays (shader.wgsl:1340-1362). ``state`` is int64;
    camera: the dict of ``camera_pytree``; resolution: (width, height).
    Returns (state, (ox, oy, oz), (dx, dy, dz))."""
    width, height = resolution
    state, jx, jy = rng.next_in_circle(state)
    sx = (pixel_x.to(torch.float32) + jx) / width * 2.0 - 1.0
    sy = -((pixel_y.to(torch.float32) + jy) / height * 2.0 - 1.0)
    max_y = torch.sin(camera["fov_y"] / 2.0)
    c0 = sx * max_y * (width / height)
    c1 = sy * max_y
    rot = camera["rot"]
    # ray_cam @ rot.T with ray_cam = (c0, c1, -1)
    d = [c0 * rot[i, 0] + c1 * rot[i, 1] - rot[i, 2] for i in range(3)]
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = tuple(x / norm for x in d)
    o = tuple(camera["pos"][i].expand_as(d[0]).contiguous() for i in range(3))
    return state, o, d


def trace_rays(scene, env, state, ray_origin, ray_direction,
               max_bounces: int = MAX_BOUNCES, with_stats: bool = False):
    """Trace a wavefront of rays to completion (shader.wgsl:1212-1303 with
    alive masks). Returns (state, light (r, g, b)), and with `with_stats`
    also {"closest_rays", "shadow_rays"}: the lanes alive at each bounce
    and those of them that hit, as int64 device scalars."""
    env_h, env_w = env.texture_shape
    ro, rd = tuple(ray_origin), tuple(ray_direction)
    one = torch.ones_like(ro[0])
    zero = torch.zeros_like(ro[0])
    throughput = (one, one, one)
    incoming = (zero, zero, zero)
    last_pdf = one
    alive = torch.ones_like(ro[0], dtype=torch.bool)
    closest = torch.zeros((), dtype=torch.int64, device=ro[0].device)
    shadow = torch.zeros((), dtype=torch.int64, device=ro[0].device)

    for _ in range(max_bounces):
        hit = intersect.closest_hit(scene, ro, rd, alive)
        active_hit = alive & hit.did_hit
        active_miss = alive & ~hit.did_hit
        closest = closest + alive.sum(dtype=torch.int64)
        shadow = shadow + active_hit.sum(dtype=torch.int64)

        # Ray escaped: environment radiance with MIS against the last BSDF
        # pdf; one quad row serves the radiance and the pdf's pmf.
        miss_u, miss_v = envmap.direction_to_equirect_uv(*rd)
        env_light, miss_pmf = envmap.radiance_and_pmf(env, miss_u, miss_v)
        miss_pdf = miss_pmf / envmap.pixel_solid_angle(miss_v, env_w, env_h)
        miss_weight = bsdf.power_heuristic(last_pdf, miss_pdf)
        incoming = tuple(
            incoming[i] + torch.where(active_miss, throughput[i] * env_light[i] * miss_weight, 0.0)
            for i in range(3)
        )

        # Surface emission with the pre-bounce throughput.
        cr, cg, cb, rough, metal, er, eg, eb = hit.material
        emission = (er, eg, eb)
        incoming = tuple(
            incoming[i] + torch.where(active_hit, throughput[i] * emission[i], 0.0)
            for i in range(3)
        )

        # Next-event estimation with MIS, then the BSDF bounce.
        state, nee_dir, nee_radiance, nee_pdf = envmap.sample_environment(state, env)
        occluded = intersect.any_hit(scene, hit.point, nee_dir, active_hit)
        (
            cos_theta, nee_scatter, nee_bsdf_pdf, state, bdir, bscat, bpdf, bzero, cos_bounce,
        ) = bsdf.trace_epilogue(rd, nee_dir, hit.normal, (cr, cg, cb), rough, metal, state)
        nee_weight = bsdf.power_heuristic(nee_pdf, nee_bsdf_pdf)
        nee_valid = active_hit & (cos_theta > 0.0) & (nee_pdf > 0.0) & ~occluded
        cos_over_pdf = cos_theta / torch.clamp_min(nee_pdf, 1.0e-30)
        incoming = tuple(
            incoming[i]
            + torch.where(
                nee_valid,
                throughput[i] * nee_weight * nee_radiance[i] * nee_scatter[i] * cos_over_pdf,
                0.0,
            )
            for i in range(3)
        )

        # Error sentinel: a zero direction replaces the collected light
        # with the debug color and ends the path.
        incoming = bsdf.vwhere(active_hit & bzero, bscat, incoming)

        tp_scale = cos_bounce / torch.clamp_min(bpdf, 1.0e-30)
        new_tp = tuple(throughput[i] * bscat[i] * tp_scale for i in range(3))
        tp_norm = torch.sqrt(new_tp[0] * new_tp[0] + new_tp[1] * new_tp[1] + new_tp[2] * new_tp[2])
        continue_path = active_hit & ~bzero & (bpdf > 0.0) & (tp_norm >= THROUGHPUT_CUTOFF)

        throughput = bsdf.vwhere(continue_path, new_tp, throughput)
        last_pdf = torch.where(continue_path, bpdf, last_pdf)
        ro = bsdf.vwhere(continue_path, hit.point, ro)
        rd = bsdf.vwhere(continue_path, bdir, rd)
        alive = continue_path

    if with_stats:
        return state, incoming, {"closest_rays": closest, "shadow_rays": shadow}
    return state, incoming


def render_sample(scene, env, camera, sample_index, resolution,
                  max_bounces: int = MAX_BOUNCES, with_stats: bool = False):
    """Render ONE progressive sample (index `sample_index`) for every
    pixel. Returns (H, W, 3) radiance (and trace_rays' stats); the film
    accumulates."""
    width, height = resolution
    device = scene.device
    lane = torch.arange(width * height, device=device, dtype=torch.int64)
    state = rng.seed(lane, int(sample_index) & rng.MASK)
    state, ro, rd = generate_camera_rays(
        state, (lane % width).to(torch.int32), (lane // width).to(torch.int32), camera, resolution
    )
    out = trace_rays(scene, env, state, ro, rd, max_bounces, with_stats=with_stats)
    image = torch.stack(out[1], dim=-1).reshape(height, width, 3)
    return (image, out[2]) if with_stats else image


def camera_pytree(camera, device=_device.DEFAULT) -> dict:
    """Host Camera -> dict of f32 tensors on `device`: 'pos' (3,),
    'rot' (3, 3), 'fov_y' (): three uploads, each a host sync on the
    card (sync.camera)."""
    device = _device.resolve(device)
    tracing.count("sync.camera", 3)
    return {
        "pos": torch.tensor(np.asarray(camera.pos, np.float32), device=device),
        "rot": torch.tensor(
            np.asarray(camera.rot_transform(), np.float32), device=device
        ),
        "fov_y": torch.tensor(np.float32(camera.fov_y), device=device),
    }
