"""Wavefront.step against a frozen copy of the iteration's earlier glue.

Before BVH_ANY and BIG_SHADE derived the hit point from the closest hit's
(t, type), and before SHADE and BIG_SHADE added their lanes to the ray
counters, the iteration ran tensor code between the kernels: the hit flag,
the hit point ro + rd * t, the shadow rays' mask, and the sums of the
shade's per-lane active and hitmask outputs. `glue_step` below keeps that
iteration as it was, over the plain twins on the CPU. On each route (small,
chunked, BVH on triangle and on sphere leaves, the composed body) a
free-run's Wavefront.step gives, bit for bit, the carry of every iteration,
the film, the counts and the counters (closest rays, shadow rays,
iterations, and the fallback's lanes) of `glue_step`. The run goes two
iterations past the drain, so the iterations counter also skips iterations
with no lane in a path. Tiny scenes: 16x16 lanes (8x8 for rtiow_final),
budget 4, 8 bounces, a 64x32 procedural sky.
"""

import os

import pytest
import torch

from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import bsdf, envmap, intersect, rng
from rsoderh_raytracing_tpu_torch.ops import bvh as bvh_ops
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.render.integrator import camera_pytree
from rsoderh_raytracing_tpu_torch.render.wavefront import LANE_NAMES, NO_LIMIT, Wavefront
from rsoderh_raytracing_tpu_torch.scene.device import BVH, CHUNKED, SMALL, build_device_scene, route

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "scenes")
BUDGET = 4
BOUNCES = 8
PAST_DRAIN = 2


def glue_step(wave, it, counters):
    """Iteration `it` of `wave` as Wavefront._step ran it with the tensor
    glue between the kernels' plain twins: replaces wave.carry and adds to
    `counters` (0-d int64 tensors by name) what the glue summed."""
    c = wave.carry
    scene, env = wave.scene, wave.env
    env_h, env_w = env.texture_shape
    ro = (c["ro0"], c["ro1"], c["ro2"])
    rd = (c["rd0"], c["rd1"], c["rd2"])
    lanes = (c["pixidx"], c["pixx"], c["pixy"], c["base"], wave.scal,
             (it + 1, wave.spp, wave.budget, wave.stride, wave.offset))
    shape = (wave.width, wave.height, wave.max_bounces)
    unused = cw.RayCounters(c["state"].device)  # the shade's own counts: not what is compared
    if wave.composed:
        state, nee_u, nee_v, nee_pmf, nd, mu, mv = envmap.trace_glue(rng.from_bits(c["state"]), env, *rd)
        did_hit, p, normal, color, rough, metal, emission, occ = intersect.trace_nee(scene, ro, rd, nd)
        (
            cos_theta, nee_scatter, nee_pdf_b, state, bdir, bscat, bpdf, bzero, cos_bounce,
        ) = bsdf.trace_epilogue(rd, nd, normal, color, rough, metal, state)
        fu = torch.where(did_hit, nee_u, mu)
        fv = torch.where(did_hit, nee_v, mv)
        q = env.quad.index_select(0, envmap.quad_index(fu, fv, env_w, env_h))
        tr = dict(
            hit=did_hit, occ=occ, px=p[0], py=p[1], pz=p[2],
            er=emission[0], eg=emission[1], eb=emission[2],
            ct=cos_theta, ns0=nee_scatter[0], ns1=nee_scatter[1], ns2=nee_scatter[2],
            npdf=nee_pdf_b, bd0=bdir[0], bd1=bdir[1], bd2=bdir[2], bpdf=bpdf,
            bs0=bscat[0], bs1=bscat[1], bs2=bscat[2], bz=bzero, cb=cos_bounce,
            state=rng.to_bits(state), fu=fu, fv=fv,
        )
        carry = cw.shade_plain(env_w, env_h, *shape, q, tr, nee_pmf, c, *lanes, unused)
    elif wave.route in (CHUNKED, BVH):
        draw = cw.env_draw_plain(env, c["state"])
        nd = (draw["nd0"], draw["nd1"], draw["nd2"])
        if wave.route == BVH:
            t, btype, bidx = bvh_ops.closest_plain(scene, ro, rd, c["in_path"],
                                                   fallback_lanes=counters["fallback_lanes"])
        else:
            t, btype, bidx = intersect.chunked_closest_plain(scene, ro, rd, c["in_path"])
        # the glue: hit flag, hit point and the shadow rays' mask
        did_hit = btype >= 0
        t_safe = torch.where(did_hit, t, 0.0)
        p = tuple(ro[k] + rd[k] * t_safe for k in range(3))
        hit_mask = (did_hit & (c["in_path"] != 0)).to(torch.int32)
        if wave.route == BVH:
            occ = bvh_ops.traverse_any(scene.bvh, p, nd, hit_mask).to(torch.int32)
        else:
            occ = intersect.chunked_any_plain(scene, p, nd, hit_mask)
        tr = dict(hit=did_hit.to(torch.int32), occ=occ, btype=btype, bidx=bidx,
                  px=p[0], py=p[1], pz=p[2])
        # BIG_SHADE's plain twin on those inputs: the fused uv, its quad row,
        # the body
        miss_u, miss_v = envmap.direction_to_equirect_uv(*rd)
        fu = torch.where(did_hit, draw["nee_u"], miss_u)
        fv = torch.where(did_hit, draw["nee_v"], miss_v)
        qwords = env.quad.index_select(0, envmap.quad_index(fu, fv, env_w, env_h))
        carry = cw.big_shade_body(scene, env_w, env_h, *shape, qwords, tr, nd, draw["state"], fu, fv,
                                  draw["nee_pmf"], c, *lanes, unused)
    else:
        tr = cw.trace_plain(scene, env, c)
        did_hit = tr["hit"] != 0
        carry = cw.shade_plain(env_w, env_h, *shape, tr["quad"], tr, tr["nee_pmf"], c, *lanes, unused)
    # the shade's per-lane active and hitmask, and the glue's sums of them
    active = c["in_path"] != 0
    act, hitm = active.to(torch.int32), (active & did_hit).to(torch.int32)
    carry.update((k, c[k]) for k in LANE_NAMES)
    wave.carry = carry
    n_act = act.sum(dtype=torch.int64)
    counters["closest_rays"] = counters["closest_rays"] + n_act
    counters["shadow_rays"] = counters["shadow_rays"] + hitm.sum(dtype=torch.int64)
    counters["iterations"] = counters["iterations"] + (n_act > 0).to(torch.int64)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name,with_bvh,composed,expected", [
    ("house", False, False, SMALL),
    ("suzanne", False, False, CHUNKED),
    ("suzanne", True, False, BVH),
    ("rtiow_final", True, False, BVH),
    ("house", False, True, SMALL),
    ("suzanne", True, True, BVH),
])
def test_step_equals_the_glue_step(monkeypatch, name, with_bvh, composed, expected):
    if composed:
        monkeypatch.setenv("RT_DISABLE_WFKERNELS", "1")
    else:
        monkeypatch.delenv("RT_DISABLE_WFKERNELS", raising=False)
    scene = load_scene(os.path.join(SCENES, f"{name}.toml"))
    ds = build_device_scene(scene, "cpu", with_bvh=with_bvh)
    assert route(ds) == expected
    env = device_environment(Environment.from_texture("s", procedural_sky(64, 32)), "cpu")
    size = 8 if name == "rtiow_final" else 16
    waves = [Wavefront(ds, env, camera_pytree(scene.camera, "cpu"), 0, (size, size), NO_LIMIT, BUDGET,
                       BOUNCES, compact_every=0) for _ in range(2)]
    wave, glued = waves
    assert wave.composed == composed
    zero = torch.zeros((), dtype=torch.int64)
    counters = {"closest_rays": zero, "shadow_rays": zero, "iterations": zero,
                "fallback_lanes": torch.zeros((), dtype=torch.int64)}
    iterations = wave.drain_iterations() + PAST_DRAIN
    for it in range(iterations):
        wave.step(it)
        glue_step(glued, it, counters)
        assert wave.carry.keys() == glued.carry.keys()
        differ = [k for k in wave.carry if not torch.equal(_bits(wave.carry[k]), _bits(glued.carry[k]))]
        assert differ == [], f"iteration {it}"
    assert not bool(wave.in_path())
    film, counts, stats = wave.results()
    want_film, want_counts, _ = glued.results()
    assert torch.equal(film.view(torch.int32), want_film.view(torch.int32))
    assert torch.equal(counts, want_counts)
    assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in counters.items()}
    assert 0 < int(stats["iterations"]) < iterations
    assert 0 < int(stats["shadow_rays"]) < int(stats["closest_rays"])
    assert (int(stats["fallback_lanes"]) > 0) == (expected == BVH and not composed)
