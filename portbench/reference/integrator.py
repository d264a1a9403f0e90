"""The reference estimator: one path per (pixel, progressive sample), as
the upstream shader traces it (shader.wgsl:1212-1362): a jittered pinhole
camera ray seeded from (pixel index, sample index), then up to
max_bounces segments of closest hit, environment light on a miss with
MIS against the last BSDF pdf, emission, next-event estimation of the
environment through the alias table with MIS and an occlusion ray, and the
GGX/Lambert bounce, ending below a throughput of 0.001. The RNG draws of
a segment are four for the environment sample and two for the bounce.

``trace_paths`` returns each path's radiance and its segment count (the
iterations the path holds a wavefront lane). Only live paths are carried
from segment to segment. With ``bf16`` set, the carried state (ray
origin and direction, throughput, collected light and last pdf) is
rounded to bfloat16 at the camera and after every segment: the
lower-precision control.
"""

from __future__ import annotations

import torch

from portbench.reference import bsdf, envmap, rng
from portbench.reference.intersect import closest, hit_attributes, occluded

THROUGHPUT_CUTOFF = 0.001


def _bf16(values):
    return tuple(v.to(torch.bfloat16).to(torch.float32) for v in values)


def camera_rays(state, px, py, cam, width, height):
    state, jx, jy = rng.next_in_circle(state)
    sx = (px.to(torch.float32) + jx) / width * 2.0 - 1.0
    sy = -((py.to(torch.float32) + jy) / height * 2.0 - 1.0)
    max_y = torch.sin(cam["fov_y"] / 2.0)
    c0 = sx * max_y * (width / height)
    c1 = sy * max_y
    rot = cam["rot"]
    d = [c0 * rot[i, 0] + c1 * rot[i, 1] - rot[i, 2] for i in range(3)]
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = tuple(x / norm for x in d)
    o = tuple(cam["pos"][i].expand_as(d[0]).contiguous() for i in range(3))
    return state, o, d


def trace_paths(scene, env, cam, pixel, sample, width, height, max_bounces, formulas, bf16=False):
    """Radiance (n, 3) f32 and segments (n,) int64 of the paths of pixels
    `pixel` (int64 flat indices) at global sample indices `sample` (u32
    values in int64)."""
    n = pixel.shape[0]
    dev = pixel.device
    env_h, env_w = env.texture_shape
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros(n, dtype=torch.int64, device=dev)
    state = rng.seed(pixel & rng.MASK, sample & rng.MASK)
    state, ro, rd = camera_rays(state, (pixel % width).to(torch.int32), (pixel // width).to(torch.int32),
                                cam, width, height)
    if bf16:
        ro, rd = _bf16(ro), _bf16(rd)
    lane = torch.arange(n, device=dev)
    one = torch.ones(n, device=dev)
    tp = (one, one, one)
    inc = (one * 0.0, one * 0.0, one * 0.0)
    last_pdf = one
    for _ in range(max_bounces):
        if lane.numel() == 0:
            break
        segments[lane] += 1
        t, ptype, pidx = closest(scene, ro, rd, formulas)
        did_hit, point, normal, mat = hit_attributes(scene, ro, rd, t, ptype, pidx)
        miss = ~did_hit
        mu, mv = envmap.direction_to_equirect_uv(*rd)
        env_light, miss_pmf = envmap.radiance_and_pmf(env, mu, mv)
        miss_pdf = miss_pmf / envmap.pixel_solid_angle(mv, env_w, env_h)
        mw = bsdf.power_heuristic(last_pdf, miss_pdf)
        inc = tuple(inc[i] + torch.where(miss, tp[i] * env_light[i] * mw, 0.0) for i in range(3))
        cr, cg, cb, rough, metal, er, eg, eb = mat
        emission = (er, eg, eb)
        inc = tuple(inc[i] + torch.where(did_hit, tp[i] * emission[i], 0.0) for i in range(3))

        state, nee_dir, nee_rad, nee_pdf = envmap.sample_environment(state, env)
        hit_lanes = torch.nonzero(did_hit).squeeze(1)
        occ = torch.zeros_like(did_hit)
        if hit_lanes.numel():
            occ[hit_lanes] = occluded(scene, tuple(c[hit_lanes] for c in point),
                                      tuple(c[hit_lanes] for c in nee_dir), formulas)
        (cos_theta, nee_scatter, nee_bsdf_pdf, state, bdir, bscat, bpdf, bzero, cos_bounce,
         ) = bsdf.trace_epilogue(rd, nee_dir, normal, (cr, cg, cb), rough, metal, state)
        nw = bsdf.power_heuristic(nee_pdf, nee_bsdf_pdf)
        nee_ok = did_hit & (cos_theta > 0.0) & (nee_pdf > 0.0) & ~occ
        cos_over_pdf = cos_theta / torch.clamp_min(nee_pdf, 1.0e-30)
        inc = tuple(inc[i] + torch.where(nee_ok, tp[i] * nw * nee_rad[i] * nee_scatter[i] * cos_over_pdf, 0.0)
                    for i in range(3))
        inc = bsdf.vwhere(did_hit & bzero, bscat, inc)
        tp_scale = cos_bounce / torch.clamp_min(bpdf, 1.0e-30)
        new_tp = tuple(tp[i] * bscat[i] * tp_scale for i in range(3))
        tp_norm = torch.sqrt(new_tp[0] * new_tp[0] + new_tp[1] * new_tp[1] + new_tp[2] * new_tp[2])
        cont = did_hit & ~bzero & (bpdf > 0.0) & (tp_norm >= THROUGHPUT_CUTOFF)

        done = ~cont
        out[lane[done]] = torch.stack(inc, dim=-1)[done]
        keep = torch.nonzero(cont).squeeze(1)
        lane = lane[keep]
        state = state[keep]
        tp = tuple(c[keep] for c in new_tp)
        inc = tuple(c[keep] for c in inc)
        last_pdf = bpdf[keep]
        ro = tuple(c[keep] for c in point)
        rd = tuple(c[keep] for c in bdir)
        if bf16:
            tp, inc, ro, rd = _bf16(tp), _bf16(inc), _bf16(ro), _bf16(rd)
            (last_pdf,) = _bf16((last_pdf,))
    if lane.numel():
        out[lane] = torch.stack(inc, dim=-1)
    return out, segments
