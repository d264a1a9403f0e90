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
- the big-mesh route: the ENV_DRAW kernel (the alias draw and the NEE
  direction, TRACE's first lines alone), CHUNKED_CLOSEST over live
  lanes, the hit point, CHUNKED_ANY over live hit lanes
  (ops/cuda_intersect.py), and BIG_SHADE, which reads the winner's union
  row and the quad row at the fused uv itself;
- the BVH route (a scene built with a BVH): the same iteration with
  BVH_CLOSEST and BVH_ANY in place of the chunked kernels. The reference
  renders such scenes through its composed body; BIG_SHADE computes the
  same shade from (type, index).

With a legacy float32 / bfloat16 environment, or with
RT_DISABLE_WFKERNELS=1 or RT_DISABLE_PALLAS=1 (the latter on the CPU
only: on the card every wrapper refuses it), the composed body runs: the
glue, ``intersect.trace_nee`` (the FUSED kernel on a small scene; the
chunked or BVH kernels over every lane on a big mesh), then the bounce
sample, one quad-row gather and the shading step as
tensor code. That tensor code is the one the TRACE and SHADE kernels'
plain versions are made of (``envmap.trace_glue``,
``bsdf.trace_epilogue``, ``cuda_wavefront.shade_plain``), so on CPU
tensors both bodies compute the same values. Under RT_DEBUG_NANS=1 each
iteration checks the carry for NaN.

Differences from the reference's loop:

- No host sync per iteration. Free-run stops regenerating once
  ``it_next >= budget``, so every path has ended after
  max(budget, 1) + max_bounces - 1 iterations: that many run blind, then
  one check asserts that no lane is still in a path. Exact-spp mode
  checks ``in_path.any()`` every 16 iterations on the card, every
  iteration on the CPU. An iteration in which no lane is active changes
  nothing that is returned.
- Ray counters are int64 on the device: closest rays are the active
  lanes, shadow rays the hit lanes. ``iterations`` counts the iterations
  in which some lane was active. ``fallback_lanes`` counts the closest
  rays that BVH_CLOSEST's walk left to its sweep of every sphere and
  plane row (the kernel adds them in place; 0 off the BVH route's kernel
  loop).

The reference's lane layout: lanes map to pixels in BLOCK_H x BLOCK_W
blocks wherever the rows tile (``lane_order``; RT_DISABLE_BLOCK_REMAP=1
keeps them row-major), and on the chunked route's kernel loop the lanes
are re-sorted every K iterations (``compact_every``) by dead-last, the
Morton cell of the ray origin and an octahedral direction bin
(``compact_key``; RT_COMPACT_KEY, RT_COMPACT_MORTON_BITS). The default
K (``compact_every_default``) is the reference's rule on the CPU and 0
on the card, where the rule measured slower (chip_smoke.py's phase 18 at
commit 0dcd918).
Every lane carries its pixel, its base sample and its home slot in the
carry, so both are pure lane permutations: per-pixel results are bitwise
those of row-major, uncompacted lanes, and ``Wavefront.results`` returns
them in pixel order. The chunked kernels tile lanes 1,024 to a block
(csrc/chunked.cu), so the layout decides which rays share a block.

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

from rsoderh_raytracing_tpu_torch import _device, tracing
from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.ops import bsdf, envmap, intersect, rng
from rsoderh_raytracing_tpu_torch.render.integrator import MAX_BOUNCES, generate_camera_rays
from rsoderh_raytracing_tpu_torch.scene.device import BVH, CHUNKED, route, scene_chunk_count

NO_LIMIT = 0xFFFFFFFF
EXACT_CHECK_EVERY = 16

# Block-major lanes: one block of BLOCK_H x BLOCK_W pixels after another
# (the reference's sweep tile, render/wavefront.py:289-290).
BLOCK_H = 64
BLOCK_W = 128
# The default cadence's thresholds (pallas_intersect.SHORTLIST_MIN_CHUNKS
# and the reference's huge-grid bound, render/wavefront.py:97-126).
SHORTLIST_MIN_CHUNKS = 32
HUGE_CHUNKS = 1024
# compact_key's modes (RT_COMPACT_KEY; an unknown value is "full") and
# the dead lanes' key.
COMPACT_KEYS = ("full", "morton", "dir", "dead")
DEAD_KEY = 0xFFFFFFFF
# The lane-identity columns of the carry, which a permutation moves with
# the path state: the four pixel arrays SHADE and BIG_SHADE read, and the
# lane's home slot.
LANE_NAMES = ("pixidx", "pixx", "pixy", "base", "home")


def kernel_loop_enabled(env) -> bool:
    """The kernel loop serves RGBE environments unless
    RT_DISABLE_WFKERNELS=1 (the reference's switch: keep the sweep
    kernels, drop the two-kernel loop) or RT_DISABLE_PALLAS=1 (no kernel
    at all); otherwise the composed body runs."""
    return (env.quad.dtype == torch.int32 and os.environ.get("RT_DISABLE_WFKERNELS") != "1"
            and not _device.kernels_disabled())


def u32_tensor(value, device) -> torch.Tensor:
    """u32 values (numpy, int or tensor) as an int64 tensor on `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int64) & rng.MASK
    return torch.from_numpy(
        np.asarray(value).astype(np.uint32).astype(np.int64)
    ).to(device)


def _base_lanes(base, n, device):
    """Per-pixel u32 starting sample (int64, (n,) in pixel order) from an
    (H, W), (H*W,) or scalar input (numpy, int or tensor) of n pixels."""
    t = u32_tensor(base, device)
    if t.numel() == n:
        return t.reshape(n).contiguous()
    if t.numel() != 1:
        raise ValueError(f"base samples: {t.numel()} values for {n} lanes")
    return t.reshape(1).expand(n).contiguous()


def lane_order(width, rows, device="cpu"):
    """(pixel_x, pixel_y, to_lanes, from_lanes) of `rows` rows of `width`
    pixels (the port's copy of the reference's _lane_order): the int32
    pixel coordinates of each lane (y counted from the first row), a
    function from a (rows, width, ...) pixel array to the flat (n, ...)
    lane array, and its inverse. Block-major (BLOCK_H x BLOCK_W blocks,
    each row-major, in row-major order) where both tile and
    RT_DISABLE_BLOCK_REMAP is not "1", read at each call; row-major
    otherwise. Either way a reshape and at most one transposing copy, no
    gather."""
    n = width * rows
    remap = os.environ.get("RT_DISABLE_BLOCK_REMAP") != "1"
    if remap and width % BLOCK_W == 0 and rows % BLOCK_H == 0:
        grid = (rows // BLOCK_H, width // BLOCK_W)

        def to_lanes(pixels):
            tail = pixels.shape[2:]
            return pixels.reshape(grid[0], BLOCK_H, grid[1], BLOCK_W, *tail).transpose(1, 2).reshape(n, *tail)

        def from_lanes(lanes):
            tail = lanes.shape[1:]
            return lanes.reshape(*grid, BLOCK_H, BLOCK_W, *tail).transpose(1, 2).reshape(rows, width, *tail)
    else:

        def to_lanes(pixels):
            return pixels.reshape(n, *pixels.shape[2:])

        def from_lanes(lanes):
            return lanes.reshape(rows, width, *lanes.shape[1:])

    x = torch.arange(width, device=device, dtype=torch.int32)
    y = torch.arange(rows, device=device, dtype=torch.int32)
    return (to_lanes(x.expand(rows, width)), to_lanes(y[:, None].expand(rows, width)),
            to_lanes, from_lanes)


def reference_cadence(scene) -> int:
    """The reference's default cadence (_compact_every_default without its
    knob): on the chunked route 1 past HUGE_CHUNKS chunks and 2 past
    SHORTLIST_MIN_CHUNKS (scene_chunk_count), else 0."""
    if route(scene) != CHUNKED:
        return 0
    chunks = scene_chunk_count(scene)
    if chunks > HUGE_CHUNKS:
        return 1
    return 2 if chunks > SHORTLIST_MIN_CHUNKS else 0


def compact_every_default(scene) -> int:
    """The compaction cadence when the caller passes None: RT_COMPACT_EVERY
    if set, read at each call; else 0 on the card and reference_cadence on
    the CPU (the reference's _compact_every_default, so the CPU tests take
    its defaults). Images are bitwise the same at every cadence, so the
    default moves only speed. On an H100 (700 W, chip_smoke.py's phase 18
    at commit 0dcd918, 2048^2, 8 bounces, free-run, median of three
    calls) the reference's rule read suzanne_hi 341.56 Mrays/s at K = 2
    against 378.45 at K = 0 (0.9025x: a permutation costs 3.42 ms at 4.2M
    lanes and the chunked kernels gain under 0.1 ms) and suzanne_xhi
    145.52 at K = 1 against 138.50 (1.0507x); it is slower on
    suzanne_hi, so the card keeps K = 0."""
    knob = os.environ.get("RT_COMPACT_EVERY")
    if knob is not None:
        return int(knob)
    if scene.device.type != "cpu":
        return 0
    return reference_cadence(scene)


def compact_grid(scene, camera, bits):
    """(lo (3,), scale (3,)) of the Morton grid of compact_key: 2**bits
    cells an axis over the valid triangles' corners, the valid spheres'
    bounds and the camera (planes are unbounded)."""
    big = 3.0e38
    tv = scene.tri_valid.reshape(-1, 1)
    sv = scene.sph_valid.reshape(-1, 1)
    a = scene.tri_a
    r = scene.sph_radius.reshape(-1, 1)
    corners = (a, a + scene.tri_edge0, a + scene.tri_edge1)
    cam = camera["pos"].to(torch.float32).reshape(1, 3)
    lo = torch.cat([*(torch.where(tv, c, big) for c in corners),
                    torch.where(sv, scene.sph_pos - r, big), cam]).amin(dim=0)
    hi = torch.cat([*(torch.where(tv, c, -big) for c in corners),
                    torch.where(sv, scene.sph_pos + r, -big), cam]).amax(dim=0)
    return lo, float(1 << bits) / torch.clamp_min(hi - lo, 1e-6)


def _part1by2(v):
    """The low 8 bits of v spread to every third bit (int64)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _cell(x, top):
    """A float clipped to [0, top] before the integer cast; NaN lands in 0."""
    return torch.nan_to_num(x, nan=0.0).clamp(0.0, top).to(torch.int64)


def compact_key(carry, lo, scale, bits, mode="full"):
    """(n,) int64 u32 sort key of the lanes (the reference's
    _compact_key): live lanes by morton(origin cell) << 7 | octa(direction)
    under mode "full", the Morton cell alone ("morton"), the 7-bit
    octahedral bin alone ("dir") or 0 ("dead"); lanes out of a path
    DEAD_KEY."""
    top = float((1 << bits) - 1)
    cell = [_cell((carry[f"ro{i}"] - lo[i]) * scale[i], top) for i in range(3)]
    morton = _part1by2(cell[0]) | (_part1by2(cell[1]) << 1) | (_part1by2(cell[2]) << 2)
    dx, dy, dz = carry["rd0"], carry["rd1"], carry["rd2"]
    s = dx.abs() + dy.abs() + dz.abs()
    px, pz = dx / s, dz / s
    fold = dy < 0.0
    pxf = torch.where(fold, (1.0 - pz.abs()) * torch.sign(px), px)
    pzf = torch.where(fold, (1.0 - px.abs()) * torch.sign(pz), pz)
    octa = ((_cell((pxf * 0.5 + 0.5) * 8.0, 7.0) << 3) | _cell((pzf * 0.5 + 0.5) * 8.0, 7.0)
            | (fold.to(torch.int64) << 6))
    if mode == "dead":
        key = torch.zeros_like(morton)
    elif mode == "morton":
        key = morton
    elif mode == "dir":
        key = octa
    else:
        key = (morton << 7) | octa
    return torch.where(carry["in_path"] != 0, key, DEAD_KEY)


def permute_carry(carry, order):
    """The carry's columns (each n 32-bit words) gathered by `order` in one
    index_select of their stacked bits."""
    packed = torch.stack([v.view(torch.int32) for v in carry.values()]).index_select(1, order)
    return {k: packed[i].view(v.dtype) for i, (k, v) in enumerate(carry.items())}


class Wavefront:
    """The loop state of one render call: the carry (CARRY_NAMES and the
    lane identity, LANE_NAMES), the camera scalars and the device
    counters.

    The lanes are the pixels of rows [row0, row0 + rows) of the
    resolution's image (rows=None: every row), one lane a pixel in
    lane_order's layout of the block; base_sample gives each pixel's
    first LOCAL sample index ((rows, W), (rows*W,) in pixel order, or a
    scalar). Local sample k of a pixel is its global progressive sample
    k * sample_stride + sample_offset (u32), which seeds its path with the
    GLOBAL pixel index, so a lane renders what the same pixel renders in
    a whole-image call. The camera and the kernels' regeneration take the
    whole image's width and height.

    compact_every=K > 0 re-sorts the lanes by compact_key before every
    iteration it > 0 with it % K == 0, on the chunked route's kernel loop
    only (the reference's _kernel_loop: its composed body, the small
    route and a scene built with a BVH never compact); None takes
    compact_every_default."""

    @tracing.traced("wavefront.setup")
    def __init__(self, scene, env, camera, base_sample, resolution, spp, budget, max_bounces,
                 row0=0, rows=None, sample_stride=1, sample_offset=0, compact_every=None):
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
        # the (tile, sample) slot of a split render (parallel/sharding.py)
        self.slot = (row0 // self.rows, self.offset)
        self.cuda = device.type == "cuda"
        self.device_name = str(device)

        pixel_x, local_y, to_lanes, self.from_lanes = lane_order(self.width, self.rows, device)
        pixel_y = local_y + row0
        pixel_index = (pixel_y.to(torch.int64) * self.width + pixel_x) & rng.MASK
        base = to_lanes(_base_lanes(base_sample, n, device).reshape(self.rows, self.width))

        state0 = rng.seed(pixel_index, (base * self.stride + self.offset) & rng.MASK)
        state0, o0, d0 = generate_camera_rays(state0, pixel_x, pixel_y, camera, resolution)
        tracing.count("sync.wavefront_setup")  # the aspect ratio's upload
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
            pixidx=rng.to_bits(pixel_index), pixx=pixel_x, pixy=pixel_y, base=rng.to_bits(base),
            home=torch.arange(n, device=device, dtype=torch.int32),
        )
        zero = torch.zeros((), device=device, dtype=torch.int64)
        self.closest, self.shadow, self.iterations = zero, zero, zero
        self.fallback = torch.zeros((), device=device, dtype=torch.int64)  # added to in place

        if compact_every is None:
            compact_every = compact_every_default(scene)
        self.compact_every = (int(compact_every) if self.route == CHUNKED and not self.composed
                              else 0)
        if self.compact_every > 0:
            mode = os.environ.get("RT_COMPACT_KEY", "full")
            self.key_mode = mode if mode in COMPACT_KEYS else "full"
            self.key_bits = min(int(os.environ.get("RT_COMPACT_MORTON_BITS", "5")), 8)
            self.grid = compact_grid(scene, camera, self.key_bits)

    def permute(self):
        """Re-sort the lanes by compact_key (a stable sort, as the
        reference's argsort): one gather of every carry column."""
        key = compact_key(self.carry, *self.grid, self.key_bits, self.key_mode)
        self.carry = permute_carry(self.carry, torch.argsort(key, stable=True))

    def step(
        self, it, trace=cw.trace_call, shade=cw.shade_call, env_draw=cw.env_draw_call,
        closest=None, occlusion=None, big_shade=cw.big_shade_call,
    ):
        """One iteration (number `it`, from 0). The kernel arguments
        default to the wrappers (closest and occlusion to the route's in
        ci.ROUTE_CALLS: the chunked kernels', or the BVH walks'; the
        composed body takes none of them; the small route takes trace and
        shade, the big-mesh routes the other four). Traced as the span
        wavefront.step (it, slot, device), whose parts step.<part> cover
        the stretches of the iteration (tracing.py)."""
        calls = ci.ROUTE_CALLS.get(self.route, ci.ROUTE_CALLS[CHUNKED])
        closest = closest or calls["closest"][0]
        occlusion = occlusion or calls["occlusion"][0]
        with tracing.span("wavefront.step", self.cuda, it=it, slot=self.slot,
                          device=self.device_name) as span:
            self._step(it, span.part, trace, shade, env_draw, closest, occlusion, big_shade)

    def _step(self, it, mark, trace, shade, env_draw, closest, occlusion, big_shade):
        if self.compact_every > 0 and it > 0 and it % self.compact_every == 0:
            mark("step.compact")
            self.permute()
        c = self.carry
        env_h, env_w = self.env.texture_shape
        ro = (c["ro0"], c["ro1"], c["ro2"])
        rd = (c["rd0"], c["rd1"], c["rd2"])
        lanes = (c["pixidx"], c["pixx"], c["pixy"], c["base"], self.scal,
                 (it + 1, self.spp, self.budget, self.stride, self.offset))
        if self.composed:
            mark("step.glue")
            state, nee_u, nee_v, nee_pmf, nd, mu, mv = envmap.trace_glue(
                rng.from_bits(c["state"]), self.env, *rd)
            mark("step.trace_nee")
            did_hit, p, normal, color, rough, metal, emission, occ = intersect.trace_nee(
                self.scene, ro, rd, nd)
            mark("step.glue")
            (
                cos_theta, nee_scatter, nee_pdf_b, state, bdir, bscat, bpdf, bzero, cos_bounce,
            ) = bsdf.trace_epilogue(rd, nd, normal, color, rough, metal, state)
            fu = torch.where(did_hit, nee_u, mu)
            fv = torch.where(did_hit, nee_v, mv)
            mark("step.gather")
            q = self.env.quad.index_select(0, envmap.quad_index(fu, fv, env_w, env_h))
            mark("step.shade")
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
            mark("step.env_draw")
            draw = env_draw(self.env, c["state"])
            nd = (draw["nd0"], draw["nd1"], draw["nd2"])
            mark("step.closest")
            counted = {"fallback_lanes": self.fallback} if self.route == BVH else {}
            t, btype, bidx = closest(self.scene, ro, rd, c["in_path"], **counted)
            mark("step.glue")
            did_hit = btype >= 0
            t_safe = torch.where(did_hit, t, 0.0)
            p = tuple(ro[k] + rd[k] * t_safe for k in range(3))
            hit_mask = (did_hit & (c["in_path"] != 0)).to(torch.int32)
            mark("step.occlusion")
            occ = occlusion(self.scene, p, nd, hit_mask)
            mark("step.big_shade")
            tr = dict(hit=did_hit.to(torch.int32), occ=occ, btype=btype, bidx=bidx,
                      px=p[0], py=p[1], pz=p[2])
            self.carry, act, hitm = big_shade(
                self.scene, env_w, env_h, self.width, self.height, self.max_bounces,
                self.env.quad, tr, nd, draw["state"], draw["nee_u"], draw["nee_v"],
                draw["nee_pmf"], c, *lanes,
            )
        else:
            mark("step.trace")
            tr = trace(self.scene, self.env, c)
            mark("step.shade")
            self.carry, act, hitm = shade(
                env_w, env_h, self.width, self.height, self.max_bounces,
                tr["quad"], tr, tr["nee_pmf"], c, *lanes,
            )
        mark(None)
        # the shade builds the path state; the lane identity rides along
        self.carry.update((k, c[k]) for k in LANE_NAMES)
        if _device.debug_nans():
            _device.check_nans(f"wavefront iteration {it}: carry", self.carry)
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

    def run(self):
        if self.budget != NO_LIMIT:
            for it in range(self.drain_iterations()):
                self.step(it)
            check_drained([self.in_path()])
        else:
            # a check costs a host sync on the card, nothing on the CPU
            every = 1 if self.scene.device.type == "cpu" else EXACT_CHECK_EVERY
            it = 0
            while True:
                for _ in range(every):
                    self.step(it)
                    it += 1
                tracing.count("sync.exact_check")
                if not bool(self.carry["in_path"].any()):
                    break

    @tracing.traced("wavefront.results")
    def results(self):
        """(film (n, 3), counts (n,) int64, stats) in pixel order: after a
        compacting loop each slot's film and count go back to their lane's
        home slot, then through from_lanes."""
        c = self.carry
        film = torch.stack([c["film0"], c["film1"], c["film2"]], dim=-1)
        counts = rng.from_bits(c["sample"])
        if self.compact_every > 0:
            home = c["home"].to(torch.int64)
            film = torch.empty_like(film).index_copy_(0, home, film)
            counts = torch.empty_like(counts).index_copy_(0, home, counts)
        n = counts.shape[0]
        stats = {
            "closest_rays": self.closest,
            "shadow_rays": self.shadow,
            "iterations": self.iterations,
            "fallback_lanes": self.fallback,
        }
        return self.from_lanes(film).reshape(n, 3), self.from_lanes(counts).reshape(n), stats


def check_drained(flags):
    """Raise if one of the device bools `flags` (Wavefront.in_path) is
    set; read after every loop of a call has been enqueued. Each read is
    a host sync on the card (the span wavefront.drain_check, the counter
    sync.drain)."""
    with tracing.span("wavefront.drain_check"):
        for f in flags:
            tracing.count("sync.drain")
            if bool(f):
                raise RuntimeError("wavefront: lanes still in a path after the drain")


def _loop(scene, env, camera, base_sample, resolution, spp, budget, max_bounces,
          compact_every=None):
    wave = Wavefront(scene, env, camera, base_sample, resolution, spp, budget, max_bounces,
                     compact_every=compact_every)
    wave.run()
    return wave.results()


def render_wavefront(
    scene, env, camera, base_sample, resolution, spp,
    max_bounces: int = MAX_BOUNCES, with_stats: bool = False,
    compact_every: int | None = None,
):
    """Render `spp` progressive samples (base_sample .. +spp-1) for every
    pixel. Returns the (H, W, 3) SUM of sample radiances (and stats).
    compact_every as in Wavefront (the reference's loop takes its
    default)."""
    width, height = resolution
    film, _, stats = _loop(
        scene, env, camera, base_sample, resolution, spp, NO_LIMIT, max_bounces,
        compact_every=compact_every,
    )
    image = film.reshape(height, width, 3)
    return (image, stats) if with_stats else image


def render_freerun(
    scene, env, camera, base_counts, resolution, iterations,
    max_bounces: int = MAX_BOUNCES, with_stats: bool = False,
    compact_every: int | None = None,
):
    """Iteration-budget rendering: every lane stays busy for `iterations`
    path segments, completing a variable number of samples per pixel,
    then in-flight paths drain. base_counts: per-pixel starting sample
    index, (H, W) or scalar. Returns (sum image (H, W, 3), counts (H, W)
    int64[, stats]); resuming from the accumulated counts continues the
    same deterministic streams.

    compact_every: the lane compaction cadence of the chunked route
    (Wavefront; None: compact_every_default). The compaction is a lane
    permutation, so it moves only the speed."""
    width, height = resolution
    film, counts, stats = _loop(
        scene, env, camera, base_counts, resolution, NO_LIMIT, iterations,
        max_bounces, compact_every=compact_every,
    )
    image = film.reshape(height, width, 3)
    counts = counts.reshape(height, width)
    return (image, counts, stats) if with_stats else (image, counts)


def render_spp_sync(
    scene, env, camera, base_counts, resolution, rounds,
    max_bounces: int = MAX_BOUNCES, with_stats: bool = False,
    compact_every: int | None = None,
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
    alike on the CPU and on an H100 (bitwise at 256^2, chip_smoke.py's
    phase 13 at commit 403343d); the card test holds them to the
    flip-aware criteria all the same.
    Each round's Wavefront takes the lane layout and compact_every as the
    reference's rounds do.

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
    stats = {"closest_rays": zero, "shadow_rays": zero, "iterations": zero, "fallback_lanes": zero}
    flags = []
    for r in range(int(rounds)):
        wave = Wavefront(scene, env, camera, (base + r) & rng.MASK, resolution, 1, NO_LIMIT,
                         max_bounces, compact_every=compact_every)
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
