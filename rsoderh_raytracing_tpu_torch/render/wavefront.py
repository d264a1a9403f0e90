"""Ray-regeneration wavefront integrator (port of
rsoderh_raytracing_tpu/render/wavefront.py: its kernel loop and its
composed body).

Lane == pixel; when a path terminates its radiance is added to the
lane's film slot and the lane reseeds the next progressive sample of the
same pixel. The iteration is picked once per call, as the reference picks
it. With an RGBE environment (and RT_DISABLE_WFKERNELS unset) the kernel
loop runs, by the scene's route (scene/device.route):

- small scenes: the TRACE kernel (the alias draw, NEE and miss uv and the
  quad-row read inside it) and the SHADE kernel (ops/cuda_wavefront.py);
- the big-mesh route: the same glue as tensor code (``envmap.trace_glue``),
  CHUNKED_CLOSEST over live lanes, the hit point, CHUNKED_ANY over live
  hit lanes (ops/cuda_intersect.py), the fused uv and one quad-row
  gather, and BIG_SHADE, which reads the winner's union row itself;
- the BVH route (a scene built with a BVH): the same iteration with
  BVH_CLOSEST and BVH_ANY in place of the chunked kernels. The reference
  renders such scenes through its composed body; BIG_SHADE computes the
  same shade from (type, index).

With a legacy float32 / bfloat16 environment, or with
RT_DISABLE_WFKERNELS=1, the composed body runs: the glue,
``intersect.trace_nee`` (the FUSED kernel on a small scene; the chunked
or BVH kernels over every lane on a big mesh), then the bounce sample, one
quad-row gather and the shading step as tensor code. That tensor code is
the one the TRACE and SHADE kernels' plain versions are made of
(``envmap.trace_glue``, ``bsdf.trace_epilogue``,
``cuda_wavefront.shade_plain``), so on CPU
tensors both bodies compute the same values.

Differences from the reference's loop:

- No host sync per iteration. Free-run stops regenerating once
  ``it_next >= budget``, so every path has ended after
  max(budget, 1) + max_bounces - 1 iterations: that many run blind, then
  one check asserts that no lane is still in a path. Exact-spp mode
  checks ``in_path.any()`` every 16 iterations. An iteration in which no
  lane is active changes nothing that is returned.
- Ray counters are int64 on the device: closest rays are the active
  lanes, shadow rays the hit lanes. ``iterations`` counts the iterations
  in which some lane was active.
- Lanes are row-major. Every lane's result depends only on its pixel, so
  the reference's 64x128 block remap (a TPU tiling) is skipped, and so is
  its lane compaction on the big-mesh route (bit-transparent by the
  reference's tests; candidates for the H100's queue of measurements).

The reference's seeding hook (``wavefront_loop_custom``) is the keywords
of ``Wavefront``: a block of pixel rows (``row0``, ``rows``) and a sample
map (``local * sample_stride + sample_offset``). ``render_spp_sync`` runs
rounds of one sample a lane through it, and the multi-device split
(parallel/sharding.py) gives each slot its rows and its stride.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import bsdf, envmap, intersect, rng
from rsoderh_raytracing_tpu_torch.render.integrator import MAX_BOUNCES, generate_camera_rays
from rsoderh_raytracing_tpu_torch.scene.device import BVH, CHUNKED, route

NO_LIMIT = 0xFFFFFFFF
EXACT_CHECK_EVERY = 16


def kernel_loop_enabled(env) -> bool:
    """The kernel loop serves RGBE environments unless
    RT_DISABLE_WFKERNELS=1 (the reference's switch: keep the sweep
    kernels, drop the two-kernel loop); otherwise the composed body runs."""
    return env.quad.dtype == torch.int32 and os.environ.get("RT_DISABLE_WFKERNELS") != "1"


def u32_tensor(value, device) -> torch.Tensor:
    """u32 values (numpy, int or tensor) as an int64 tensor on `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int64) & rng.MASK
    return torch.from_numpy(
        np.asarray(value).astype(np.uint32).astype(np.int64)
    ).to(device)


def _base_lanes(base, n, device):
    """Per-lane u32 starting sample (int64) from an (H, W), (H*W,) or
    scalar input (numpy, int or tensor) of n pixels."""
    t = u32_tensor(base, device)
    if t.numel() == n:
        return t.reshape(n).contiguous()
    if t.numel() != 1:
        raise ValueError(f"base samples: {t.numel()} values for {n} lanes")
    return t.reshape(1).expand(n).contiguous()


class Wavefront:
    """The loop state of one render call: the carry (CARRY_NAMES), the
    loop-invariant lanes, the camera scalars and the device counters.

    The lanes are the pixels of rows [row0, row0 + rows) of the
    resolution's image (rows=None: every row), one lane a pixel in
    row-major order; base_sample gives each lane's first LOCAL sample
    index ((rows, W), (rows*W,) or a scalar). Local sample k of a pixel is
    its global progressive sample k * sample_stride + sample_offset (u32),
    which seeds its path with the GLOBAL pixel index, so a lane renders
    what the same pixel renders in a whole-image call. The camera and the
    kernels' regeneration take the whole image's width and height."""

    def __init__(self, scene, env, camera, base_sample, resolution, spp, budget, max_bounces,
                 row0=0, rows=None, sample_stride=1, sample_offset=0):
        self.route = route(scene)
        self.composed = not kernel_loop_enabled(env)
        device = scene.device
        self.scene, self.env = scene, env
        self.width, self.height = resolution
        self.max_bounces = max_bounces
        self.spp = int(spp) & rng.MASK
        self.budget = int(budget) & rng.MASK
        self.rows = self.height if rows is None else int(rows)
        if not 0 <= row0 <= self.height - self.rows:
            raise ValueError(f"rows [{row0}, {row0 + self.rows}) outside the image's {self.height}")
        self.stride = int(sample_stride) & rng.MASK
        self.offset = int(sample_offset) & rng.MASK
        n = self.width * self.rows

        lane = torch.arange(n, device=device, dtype=torch.int64)
        self.pixel_x = (lane % self.width).to(torch.int32)
        self.pixel_y = (row0 + lane // self.width).to(torch.int32)
        pixel_index = (lane + row0 * self.width) & rng.MASK  # y * W + x
        base = _base_lanes(base_sample, n, device)
        self.pixel_bits = rng.to_bits(pixel_index)
        self.base_bits = rng.to_bits(base)

        state0 = rng.seed(pixel_index, (base * self.stride + self.offset) & rng.MASK)
        state0, o0, d0 = generate_camera_rays(
            state0, self.pixel_x, self.pixel_y, camera, resolution
        )
        self.scal = torch.cat(
            [
                torch.sin(camera["fov_y"] / 2.0).reshape(1),
                torch.tensor(
                    [self.width / self.height], dtype=torch.float32, device=device
                ),
                camera["pos"].to(torch.float32),
                camera["rot"].to(torch.float32).reshape(9),
                env.pmf_norm.to(torch.float32),
            ]
        ).contiguous()

        def full(value, dtype=torch.float32):
            return torch.full((n,), value, device=device, dtype=dtype)

        self.carry = dict(
            state=rng.to_bits(state0),
            ro0=o0[0], ro1=o0[1], ro2=o0[2], rd0=d0[0], rd1=d0[1], rd2=d0[2],
            tp0=full(1.0), tp1=full(1.0), tp2=full(1.0),
            inc0=full(0.0), inc1=full(0.0), inc2=full(0.0),
            last_pdf=full(1.0),
            bounce=full(0, torch.int32),
            sample=full(0, torch.int32),
            in_path=full(1, torch.int32),
            film0=full(0.0), film1=full(0.0), film2=full(0.0),
        )
        zero = torch.zeros((), device=device, dtype=torch.int64)
        self.closest, self.shadow, self.iterations = zero, zero, zero

    def step(
        self, it, trace=cw.trace_call, shade=cw.shade_call,
        closest=None, occlusion=None, big_shade=cw.big_shade_call, profile=None,
    ):
        """One iteration (number `it`, from 0). The kernel arguments
        default to the wrappers (closest and occlusion to the route's in
        ci.ROUTE_CALLS: the chunked kernels', or the BVH walks'; the
        composed body takes none of them); `profile`, if a dict, collects in profile["marks"]
        one list per iteration of (part, CUDA event) pairs, each event
        starting the named part and the last one (part None) ending the
        iteration."""
        calls = ci.ROUTE_CALLS.get(self.route, ci.ROUTE_CALLS[CHUNKED])
        closest = closest or calls["closest"][0]
        occlusion = occlusion or calls["occlusion"][0]
        marks = [] if profile is not None else None

        def mark(part):
            if marks is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((part, ev))

        c = self.carry
        env_h, env_w = self.env.texture_shape
        ro = (c["ro0"], c["ro1"], c["ro2"])
        rd = (c["rd0"], c["rd1"], c["rd2"])
        lanes = (self.pixel_bits, self.pixel_x, self.pixel_y, self.base_bits, self.scal,
                 (it + 1, self.spp, self.budget, self.stride, self.offset))
        if self.composed:
            mark("glue")
            state, nee_u, nee_v, nee_pmf, nd, mu, mv = envmap.trace_glue(
                rng.from_bits(c["state"]), self.env, *rd)
            mark("trace_nee")
            did_hit, p, normal, color, rough, metal, emission, occ = intersect.trace_nee(
                self.scene, ro, rd, nd)
            mark("glue")
            (
                cos_theta, nee_scatter, nee_pdf_b, state, bdir, bscat, bpdf, bzero, cos_bounce,
            ) = bsdf.trace_epilogue(rd, nd, normal, color, rough, metal, state)
            fu = torch.where(did_hit, nee_u, mu)
            fv = torch.where(did_hit, nee_v, mv)
            mark("gather")
            q = self.env.quad.index_select(0, envmap.quad_index(fu, fv, env_w, env_h))
            mark("shade")
            tr = dict(
                hit=did_hit, occ=occ, px=p[0], py=p[1], pz=p[2],
                er=emission[0], eg=emission[1], eb=emission[2],
                ct=cos_theta, ns0=nee_scatter[0], ns1=nee_scatter[1], ns2=nee_scatter[2],
                npdf=nee_pdf_b, bd0=bdir[0], bd1=bdir[1], bd2=bdir[2], bpdf=bpdf,
                bs0=bscat[0], bs1=bscat[1], bs2=bscat[2], bz=bzero, cb=cos_bounce,
                state=rng.to_bits(state), fu=fu, fv=fv,
            )
            self.carry, act, hitm = cw.shade_plain(
                env_w, env_h, self.width, self.height, self.max_bounces,
                q, tr, nee_pmf, c, *lanes,
            )
        elif self.route in (CHUNKED, BVH):
            mark("glue")
            state, nee_u, nee_v, nee_pmf, nd, mu, mv = envmap.trace_glue(
                rng.from_bits(c["state"]), self.env, *rd)
            mark("closest")
            t, btype, bidx = closest(self.scene, ro, rd, c["in_path"])
            mark("glue")
            did_hit = btype >= 0
            t_safe = torch.where(did_hit, t, 0.0)
            p = tuple(ro[k] + rd[k] * t_safe for k in range(3))
            hit_mask = (did_hit & (c["in_path"] != 0)).to(torch.int32)
            mark("occlusion")
            occ = occlusion(self.scene, p, nd, hit_mask)
            mark("gather")
            fu = torch.where(did_hit, nee_u, mu)
            fv = torch.where(did_hit, nee_v, mv)
            qw = self.env.quad.index_select(0, envmap.quad_index(fu, fv, env_w, env_h))
            mark("big_shade")
            tr = dict(hit=did_hit.to(torch.int32), occ=occ, btype=btype, bidx=bidx,
                      px=p[0], py=p[1], pz=p[2])
            self.carry, act, hitm = big_shade(
                self.scene, env_w, env_h, self.width, self.height, self.max_bounces,
                qw, tr, nd, rng.to_bits(state), fu, fv, nee_pmf, c, *lanes,
            )
        else:
            mark("trace")
            tr = trace(self.scene, self.env, c)
            mark("shade")
            self.carry, act, hitm = shade(
                env_w, env_h, self.width, self.height, self.max_bounces,
                tr["quad"], tr, tr["nee_pmf"], c, *lanes,
            )
        mark(None)
        if marks is not None:
            profile.setdefault("marks", []).append(marks)
        n_act = act.sum(dtype=torch.int64)
        self.closest = self.closest + n_act
        self.shadow = self.shadow + hitm.sum(dtype=torch.int64)
        self.iterations = self.iterations + (n_act > 0).to(torch.int64)

    def drain_iterations(self) -> int:
        """Free-run: regeneration stops at it_next >= budget, so the last
        path ends within this many iterations."""
        return max(self.budget, 1) + self.max_bounces - 1

    def in_path(self):
        """A device bool: some lane is still in a path."""
        return self.carry["in_path"].any()

    def run(self, profile=None):
        if self.budget != NO_LIMIT:
            for it in range(self.drain_iterations()):
                self.step(it, profile=profile)
            check_drained([self.in_path()])
        else:
            it = 0
            while True:
                for _ in range(EXACT_CHECK_EVERY):
                    self.step(it, profile=profile)
                    it += 1
                if not bool(self.carry["in_path"].any()):
                    break

    def results(self):
        """(film (n, 3), counts (n,) int64, stats) of the lanes."""
        c = self.carry
        film = torch.stack([c["film0"], c["film1"], c["film2"]], dim=-1)
        stats = {
            "closest_rays": self.closest,
            "shadow_rays": self.shadow,
            "iterations": self.iterations,
        }
        return film, rng.from_bits(c["sample"]), stats


def check_drained(flags):
    """Raise if one of the device bools `flags` (Wavefront.in_path) is
    set; read after every loop of a call has been enqueued."""
    if any(bool(f) for f in flags):
        raise RuntimeError("wavefront: lanes still in a path after the drain")


def _loop(scene, env, camera, base_sample, resolution, spp, budget, max_bounces, profile=None):
    wave = Wavefront(scene, env, camera, base_sample, resolution, spp, budget, max_bounces)
    wave.run(profile=profile)
    return wave.results()


def render_wavefront(
    scene, env, camera, base_sample, resolution, spp,
    max_bounces: int = MAX_BOUNCES, with_stats: bool = False,
):
    """Render `spp` progressive samples (base_sample .. +spp-1) for every
    pixel. Returns the (H, W, 3) SUM of sample radiances (and stats)."""
    width, height = resolution
    film, _, stats = _loop(
        scene, env, camera, base_sample, resolution, spp, NO_LIMIT, max_bounces
    )
    image = film.reshape(height, width, 3)
    return (image, stats) if with_stats else image


def render_freerun(
    scene, env, camera, base_counts, resolution, iterations,
    max_bounces: int = MAX_BOUNCES, with_stats: bool = False, profile=None,
    compact_every: int | None = None,
):
    """Iteration-budget rendering: every lane stays busy for `iterations`
    path segments, completing a variable number of samples per pixel,
    then in-flight paths drain. base_counts: per-pixel starting sample
    index, (H, W) or scalar. Returns (sum image (H, W, 3), counts (H, W)
    int64[, stats]); resuming from the accumulated counts continues the
    same deterministic streams.

    compact_every is accepted for the reference's callers and has no
    effect: the reference's lane compaction is bit-transparent, and the
    port does not compact (RT_COMPACT_EVERY is ignored with a warning)."""
    del compact_every
    _device.warn_ignored_knobs()
    width, height = resolution
    film, counts, stats = _loop(
        scene, env, camera, base_counts, resolution, NO_LIMIT, iterations,
        max_bounces, profile=profile,
    )
    image = film.reshape(height, width, 3)
    counts = counts.reshape(height, width)
    return (image, counts, stats) if with_stats else (image, counts)


def render_spp_sync(
    scene, env, camera, base_counts, resolution, rounds,
    max_bounces: int = MAX_BOUNCES, with_stats: bool = False,
):
    """Bounce-synchronized progressive rendering: each round renders ONE
    sample for every pixel (sample base + r), every lane launches the
    round's camera ray together and the round drains completely before
    the next one starts. The per-(pixel, sample) paths and RNG streams
    are render_wavefront's, and the films are summed in round order from
    zeros (the in-lane order of render_wavefront's film), so the image is
    render_wavefront(spp=rounds)'s wherever both compute the same camera
    rays: every round's camera rays come from generate_camera_rays, while
    render_wavefront regenerates samples 1.. inside SHADE. The two round
    alike on the CPU and on an H100 (bitwise at 256^2, chip_smoke.py phase
    13); the checks hold the card to the flip-aware criteria all the same.
    The port's lanes are row-major, so the reference's lane-order remap is
    the identity here.

    A round is max_bounces iterations of the loop (a path of one sample
    ends within them) and no host sync; one check after the last round
    asserts that every path ended.

    base_counts: per-pixel starting sample index, (H, W), flat (H*W,) in
    pixel order, or a scalar. Returns (sum image (H, W, 3), counts (H, W)
    int64[, stats]): counts are the samples completed this call (rounds
    everywhere), stats the rays and iterations summed over the rounds."""
    width, height = resolution
    n = width * height
    device = scene.device
    base = _base_lanes(base_counts, n, device)
    film = torch.zeros((n, 3), dtype=torch.float32, device=device)
    counts = torch.zeros(n, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    stats = {"closest_rays": zero, "shadow_rays": zero, "iterations": zero}
    flags = []
    for r in range(int(rounds)):
        wave = Wavefront(scene, env, camera, (base + r) & rng.MASK, resolution, 1, NO_LIMIT,
                         max_bounces)
        for it in range(max(max_bounces, 1)):
            wave.step(it)
        flags.append(wave.in_path())
        f, c, st = wave.results()
        film = film + f
        counts = counts + c
        stats = {k: stats[k] + st[k] for k in stats}
    check_drained(flags)
    image = film.reshape(height, width, 3)
    counts = counts.reshape(height, width)
    return (image, counts, stats) if with_stats else (image, counts)
