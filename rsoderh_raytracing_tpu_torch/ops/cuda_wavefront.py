"""TRACE, SHADE, ENV_DRAW and BIG_SHADE: the per-lane kernels of one
wavefront iteration.

Counterpart of rsoderh_raytracing_tpu/ops/pallas_wavefront.py. One
iteration of the small-scene path is

  [TRACE kernel: alias draw of the NEE texel (one 16-byte alias row),
        NEE direction, closest sweep + winner attributes + materials +
        shadow sweep + NEE BSDF eval/pdf + bounce sample, miss uv, and the
        16-byte quad row at the fused uv]
  [SHADE kernel: RGBE bilinear + pmf + MIS + film + termination +
        regeneration]

and of the big-mesh path (render/wavefront.py)

  [ENV_DRAW kernel: alias draw of the NEE texel (one 16-byte alias row),
        NEE uv, pmf and direction] [CHUNKED_CLOSEST or BVH_CLOSEST]
  [CHUNKED_ANY (its wrapper computes the hit point) or BVH_ANY (the
        kernel does)]
  [BIG_SHADE kernel: the hit flag and point from the winner's (t, type),
        the winner's union row (scene.winner), its normal and material,
        trace_epilogue, the fused uv and the 16-byte quad row there, the
        SHADE core]

``trace_call`` takes the carried ray and RNG state and the environment and
returns the Pallas twin's outputs (TRACE_OUT_NAMES) without its quad-row
index, plus the NEE pmf and the quad row itself; ``env_draw_call`` takes
the carried RNG state and returns what the reference's XLA glue draws
before its sweeps (ENV_DRAW_OUT_NAMES); ``shade_call`` and
``big_shade_call`` return the Pallas twins' carry outputs (the 20
SHADE_OUT_NAMES), as flat (n,) tensors per component, and add the
Pallas twins' per-lane ``active`` and ``hitmask`` to the call's
``RayCounters`` instead of writing them (a sum a block, one atomic a
block and counter). BIG_SHADE takes the winner's (t, type, index), the
NEE uv and the quad table; it derives the hit flag and point and reads
the winner's row and the quad row itself instead of the Pallas call's
19 slot arrays and gathered quad row. u32 values (RNG state, sample
counts, pixel ids) travel as int32 bit patterns. For CPU tensors the
wrappers run the plain versions ``trace_plain`` / ``env_draw_plain`` /
``shade_plain`` / ``big_shade_plain``; for CUDA tensors they launch the
kernels in ``csrc/wavefront.cu`` or raise (also under RT_DISABLE_PALLAS=1:
``_device.use_plain``).
``LAUNCHES`` counts the kernel launches of each wrapper. Under
RT_DEBUG_NANS=1 each wrapper checks its float outputs
(``_device.check_nans``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device
from rsoderh_raytracing_tpu_torch.ops import bsdf, envmap, intersect, rng
from rsoderh_raytracing_tpu_torch.render.integrator import THROUGHPUT_CUTOFF
from rsoderh_raytracing_tpu_torch.scene.device import SMALL, WINNER_SLOTS, route

TRACE_OUT_NAMES = (
    "hit", "occ", "px", "py", "pz", "er", "eg", "eb",
    "ct", "ns0", "ns1", "ns2", "npdf",
    "bd0", "bd1", "bd2", "bpdf", "bs0", "bs1", "bs2", "bz", "cb",
    "state", "fu", "fv", "nee_pmf", "quad",
)
TRACE_INT_NAMES = ("hit", "occ", "bz", "state", "quad")
# TRACE's inputs from the carry (4 bytes a lane each).
TRACE_CARRY_IN = ("ro0", "ro1", "ro2", "rd0", "rd1", "rd2", "state")

SHADE_OUT_NAMES = (
    "state", "ro0", "ro1", "ro2", "rd0", "rd1", "rd2",
    "tp0", "tp1", "tp2", "inc0", "inc1", "inc2",
    "last_pdf", "bounce", "sample", "in_path",
    "film0", "film1", "film2",
)
SHADE_INT_NAMES = ("state", "bounce", "sample", "in_path")
CARRY_NAMES = SHADE_OUT_NAMES

# The int64 slots of RayCounters, which SHADE and BIG_SHADE add each
# launch's lanes to: closest rays (the lanes in a path), shadow rays (those
# whose closest ray hit), iterations with a lane in a path, and the tag of
# the last of those iterations.
COUNTER_NAMES = ("closest_rays", "shadow_rays", "iterations", "last_tag")

# Kernel launches of each wrapper (CUDA tensors only).
LAUNCHES = {"trace": 0, "shade": 0, "env_draw": 0, "big_shade": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class RayCounters:
    """The ray counters of a render call, on its device: `slots`, int64
    by COUNTER_NAMES. Every shade launch, kernel or plain twin, takes a new
    tag (next_tag); the first of its blocks with a lane in a path swaps the
    tag into the last slot and so counts the iteration once."""

    def __init__(self, device):
        self.slots = torch.zeros(len(COUNTER_NAMES), dtype=torch.int64, device=device)
        self.tag = 0

    def next_tag(self) -> int:
        self.tag += 1
        return self.tag

    def stats(self) -> dict:
        """The first three slots by name, 0-d views."""
        return {k: self.slots[i] for i, k in enumerate(COUNTER_NAMES[:3])}


def count_rays(counters, active, is_hit):
    """Plain: add one launch's lanes in a path and hit lanes ((n,) bool)
    to `counters`, as the kernels' blocks add theirs."""
    tag = counters.next_tag()
    n_active = active.sum(dtype=torch.int64)
    some = n_active > 0
    slots = counters.slots
    slots[:3] += torch.stack([n_active, is_hit.sum(dtype=torch.int64), some.to(torch.int64)])
    slots[3] = torch.where(some, tag, slots[3])


# -- plain versions -------------------------------------------------------------


def trace_plain(scene, env, carry):
    """Plain PyTorch TRACE: the glue of the Pallas version's caller
    (envmap.trace_glue), the Pallas body and the quad-row gather, in that
    order. carry: the loop state by CARRY_NAMES
    (TRACE reads TRACE_CARRY_IN); env: an RGBE DeviceEnvironment. Returns
    the outputs by TRACE_OUT_NAMES: (n,) tensors, the quad row (n, 4)
    int32."""
    env_h, env_w = env.texture_shape
    ro = (carry["ro0"], carry["ro1"], carry["ro2"])
    rd = (carry["rd0"], carry["rd1"], carry["rd2"])
    state, nee_u, nee_v, nee_pmf, nee_dir, miss_u, miss_v = envmap.trace_glue(
        rng.from_bits(carry["state"]), env, *rd)
    a = intersect.trace_attrs(scene, *ro, *rd, *nee_dir)
    did_hit = a["did_hit"]
    (
        cos_theta, nee_scatter, nee_pdf_b, st, bdir, bscat, bpdf, bzero,
        cos_bounce,
    ) = bsdf.trace_epilogue(
        rd, nee_dir, (a["nx"], a["ny"], a["nz"]), (a["cr"], a["cg"], a["cb"]),
        a["rough"], a["metal"], state,
    )
    fu = torch.where(did_hit, nee_u, miss_u)
    fv = torch.where(did_hit, nee_v, miss_v)
    out = dict(
        hit=did_hit.to(torch.int32), occ=a["occ"].to(torch.int32),
        px=a["px"], py=a["py"], pz=a["pz"],
        er=a["er"], eg=a["eg"], eb=a["eb"],
        ct=cos_theta, ns0=nee_scatter[0], ns1=nee_scatter[1],
        ns2=nee_scatter[2], npdf=nee_pdf_b,
        bd0=bdir[0], bd1=bdir[1], bd2=bdir[2], bpdf=bpdf,
        bs0=bscat[0], bs1=bscat[1], bs2=bscat[2],
        bz=bzero.to(torch.int32), cb=cos_bounce,
        state=rng.to_bits(st), fu=fu, fv=fv, nee_pmf=nee_pmf,
        quad=env.quad.index_select(0, envmap.quad_index(fu, fv, env_w, env_h)),
    )
    return {k: v.contiguous() for k, v in out.items()}


ENV_DRAW_OUT_NAMES = ("state", "nee_u", "nee_v", "nee_pmf", "nd0", "nd1", "nd2")


def env_draw_plain(env, state):
    """Plain PyTorch ENV_DRAW: envmap.env_draw (envmap.trace_glue without
    the miss uv) on int32 ``state`` bits. Returns the outputs by
    ENV_DRAW_OUT_NAMES: the state after the draw (int32 bits), the NEE uv
    and pmf and the NEE direction, (n,) tensors."""
    st, nee_u, nee_v, nee_pmf, nd = envmap.env_draw(rng.from_bits(state), env)
    out = dict(state=rng.to_bits(st), nee_u=nee_u, nee_v=nee_v, nee_pmf=nee_pmf,
               nd0=nd[0], nd1=nd[1], nd2=nd[2])
    return {k: v.contiguous() for k, v in out.items()}


def shade_plain(
    env_w, env_h, width, height, max_bounces,
    qwords, tr, nee_pmf, carry, pixel_index, pixel_x, pixel_y, base_sample,
    scal, iscal, counters,
):
    """Plain PyTorch SHADE (pallas_wavefront._shade_core).

    qwords: (n, 4) int32 RGBE words of the quad row at the fused uv (or,
    from the composed wavefront body, (n, 16) legacy float rows);
    tr: trace outputs (flags int32 or bool); carry: the loop state by
    CARRY_NAMES; pixel_index
    and base_sample: int32 u32 bits; scal: (16,) f32 tensor [max_y,
    aspect, cam pos (3), cam rot rows (9), L, Z]; iscal: 5 ints
    (it_next, spp, budget, stride, offset) as unsigned values; counters:
    the call's RayCounters, which get the Pallas twin's active and hitmask
    lanes added (count_rays). Returns the new carry."""
    active = carry["in_path"] != 0
    did_hit = tr["hit"] != 0
    is_hit = active & did_hit
    is_miss = active & ~did_hit
    throughput = (carry["tp0"], carry["tp1"], carry["tp2"])
    incoming = (carry["inc0"], carry["inc1"], carry["inc2"])
    fu, fv = tr["fu"], tr["fv"]

    radiance, quad_pmf = envmap.radiance_and_pmf_from_quad(
        qwords, fu, fv, env_w, env_h, scal[14:16]
    )
    pmf = torch.where(is_hit, nee_pmf, quad_pmf)
    pdf_env = pmf / envmap.pixel_solid_angle(fv, env_w, env_h)

    # miss: environment light with MIS
    miss_weight = bsdf.power_heuristic(carry["last_pdf"], pdf_env)
    incoming = tuple(
        incoming[i]
        + torch.where(is_miss, throughput[i] * radiance[i] * miss_weight, 0.0)
        for i in range(3)
    )
    # hit: emission + NEE
    emis = (tr["er"], tr["eg"], tr["eb"])
    incoming = tuple(
        incoming[i] + torch.where(is_hit, throughput[i] * emis[i], 0.0)
        for i in range(3)
    )
    cos_theta = tr["ct"]
    nee_weight = bsdf.power_heuristic(pdf_env, tr["npdf"])
    nee_ok = is_hit & (cos_theta > 0.0) & (pdf_env > 0.0) & (tr["occ"] == 0)
    cos_over_pdf = cos_theta / torch.clamp_min(pdf_env, 1.0e-30)
    ns = (tr["ns0"], tr["ns1"], tr["ns2"])
    incoming = tuple(
        incoming[i]
        + torch.where(
            nee_ok,
            throughput[i] * nee_weight * radiance[i] * ns[i] * cos_over_pdf,
            0.0,
        )
        for i in range(3)
    )

    # bounce / termination
    bzero = tr["bz"] != 0
    bscat = (tr["bs0"], tr["bs1"], tr["bs2"])
    incoming = bsdf.vwhere(is_hit & bzero, bscat, incoming)
    bpdf = tr["bpdf"]
    tp_scale = tr["cb"] / torch.clamp_min(bpdf, 1.0e-30)
    new_tp = tuple(throughput[i] * bscat[i] * tp_scale for i in range(3))
    tp_norm = torch.sqrt(
        new_tp[0] * new_tp[0] + new_tp[1] * new_tp[1] + new_tp[2] * new_tp[2]
    )
    bounce = carry["bounce"] + 1
    continues = (
        is_hit & ~bzero & (bpdf > 0.0)
        & (tp_norm >= THROUGHPUT_CUTOFF) & (bounce < max_bounces)
    )
    path_done = active & ~continues
    film = tuple(
        carry["film" + str(i)] + torch.where(path_done, incoming[i], 0.0)
        for i in range(3)
    )
    sample = rng.from_bits(carry["sample"])
    next_sample = torch.where(path_done, (sample + 1) & rng.MASK, sample)

    # regenerate: reseed from (pixel, global sample), jittered pinhole ray
    it_next, spp, budget, stride, offset = (int(x) & rng.MASK for x in iscal)
    regen = path_done & (next_sample < spp) & (it_next < budget)
    global_sample = (
        (rng.from_bits(base_sample) + next_sample) * stride + offset
    ) & rng.MASK
    fstate = rng.seed(rng.from_bits(pixel_index), global_sample)
    fstate, jx, jy = rng.next_in_circle(fstate)
    jpx = pixel_x.to(torch.float32) + jx
    jpy = pixel_y.to(torch.float32) + jy
    sxn = jpx / width * 2.0 - 1.0
    syn = -(jpy / height * 2.0 - 1.0)
    rc0 = sxn * scal[0] * scal[1]
    rc1 = syn * scal[0]
    fd0 = rc0 * scal[5] + rc1 * scal[6] - scal[7]
    fd1 = rc0 * scal[8] + rc1 * scal[9] - scal[10]
    fd2 = rc0 * scal[11] + rc1 * scal[12] - scal[13]
    fnorm = torch.sqrt(fd0 * fd0 + fd1 * fd1 + fd2 * fd2)
    fd = (fd0 / fnorm, fd1 / fnorm, fd2 / fnorm)

    in_path = (active & continues) | regen
    state = torch.where(regen, fstate, rng.from_bits(tr["state"]))
    zero = torch.zeros_like(fd0)
    one = torch.ones_like(fd0)
    cam = tuple(scal[2 + i] + zero for i in range(3))
    point = (tr["px"], tr["py"], tr["pz"])
    ro = bsdf.vwhere(
        regen, cam,
        bsdf.vwhere(continues, point, (carry["ro0"], carry["ro1"], carry["ro2"])),
    )
    rd = bsdf.vwhere(
        regen, fd,
        bsdf.vwhere(
            continues, (tr["bd0"], tr["bd1"], tr["bd2"]),
            (carry["rd0"], carry["rd1"], carry["rd2"]),
        ),
    )
    throughput = bsdf.vwhere(
        regen, (one, one, one), bsdf.vwhere(continues, new_tp, throughput)
    )
    incoming = bsdf.vwhere(regen | path_done, (zero, zero, zero), incoming)
    last_pdf = torch.where(
        regen, 1.0, torch.where(continues, bpdf, carry["last_pdf"])
    )
    bounce = torch.where(regen, 0, bounce).to(torch.int32)

    new_carry = dict(
        state=rng.to_bits(state),
        ro0=ro[0], ro1=ro[1], ro2=ro[2], rd0=rd[0], rd1=rd[1], rd2=rd[2],
        tp0=throughput[0], tp1=throughput[1], tp2=throughput[2],
        inc0=incoming[0], inc1=incoming[1], inc2=incoming[2],
        last_pdf=last_pdf, bounce=bounce, sample=rng.to_bits(next_sample),
        in_path=in_path.to(torch.int32),
        film0=film[0], film1=film[1], film2=film[2],
    )
    count_rays(counters, active, is_hit)
    return new_carry


# -- CUDA wrappers ----------------------------------------------------------------


def winner_index(scene, btype, bidx):
    """Row of scene.winner for each lane's (type, index); a miss reads
    row 0 (render/wavefront.py:1003-1009 of the reference)."""
    n_sph = scene.sph_radius.shape[0]
    n_pln = scene.pln_valid.shape[0]
    return torch.where(
        btype == 0, bidx,
        torch.where(btype == 1, n_sph + bidx,
                    torch.where(btype == 2, n_sph + n_pln + bidx, 0)),
    ).to(torch.int32)


def _check(name, t, n, dtype, device):
    if t.device != device or t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous ({n},) {dtype} on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _raise_on(rc, what):
    if rc != 0:
        from rsoderh_raytracing_tpu_torch.ops import _kernels

        raise RuntimeError(f"{what} launch failed: {_kernels.error_string(rc)}")


def _check_rows(name, t, n, dtype, device):
    if t.device != device or t.dtype != dtype or t.shape != (n, 4) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous ({n}, 4) {dtype} on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )


def trace_call(scene, env, carry):
    """TRACE over the carry's flat (n,) ray and state tensors and the RGBE
    environment `env`; returns the outputs by TRACE_OUT_NAMES. CPU
    tensors: trace_plain. CUDA tensors: the kernel, which reads the alias
    and quad rows itself, over a SMALL scene's packed table."""
    if _device.use_plain(carry["state"], "trace_call"):
        out = trace_plain(scene, env, carry)
    else:
        out = _trace_launch(scene, env, carry)
    return _device.check_nans("TRACE", out)


def check_table(scene, what):
    """The packed table of a SMALL scene, for a sweep kernel's launch (any
    size: the kernels stage it in shared memory where it fits and read it
    from global memory otherwise); refuses another route."""
    if route(scene) != SMALL:
        raise ValueError(f"{what}: the scene does not take the small route (route {route(scene)})")
    return scene.trace_table


def _trace_launch(scene, env, carry):
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    table = check_table(scene, "trace_call")
    state = carry["state"]
    n = state.shape[0]
    dev = state.device
    env_h, env_w = env.texture_shape
    _check_rows("env.alias_pair", env.alias_pair, env_w * env_h, torch.float32, dev)
    _check_rows("env.quad (the RGBE layout)", env.quad, env_w * env_h, torch.int32, dev)
    ins = tuple(carry[k] for k in TRACE_CARRY_IN)
    for name, t in zip(TRACE_CARRY_IN, ins):
        _check(name, t, n, torch.int32 if name == "state" else torch.float32, dev)
    outs = {
        k: torch.empty(n, device=dev, dtype=torch.int32 if k in TRACE_INT_NAMES else torch.float32)
        for k in TRACE_OUT_NAMES if k != "quad"
    }
    outs["quad"] = torch.empty((n, 4), device=dev, dtype=torch.int32)
    rc = _kernels.library().rt_trace_launch(
        _ptrs(ins + tuple(outs[k] for k in TRACE_OUT_NAMES)),
        table.data_ptr(), table.numel(), n,
        scene.sph_radius.shape[0], scene.pln_valid.shape[0],
        scene.tri_valid.shape[0], scene.mat_roughness.shape[0],
        env.alias_pair.data_ptr(), env.quad.data_ptr(), env_w, env_h,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "TRACE")
    LAUNCHES["trace"] += 1
    return outs


def env_draw_call(env, state):
    """ENV_DRAW over the (n,) int32 RNG state bits and the RGBE
    environment `env`; returns the outputs by ENV_DRAW_OUT_NAMES. CPU
    tensors: env_draw_plain. CUDA tensors: the kernel, which reads each
    lane's alias row itself."""
    if _device.use_plain(state, "env_draw_call"):
        out = env_draw_plain(env, state)
    else:
        out = _env_draw_launch(env, state)
    return _device.check_nans("ENV_DRAW", out)


def _env_draw_launch(env, state):
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n = state.shape[0]
    dev = state.device
    env_h, env_w = env.texture_shape
    _check_rows("env.alias_pair", env.alias_pair, env_w * env_h, torch.float32, dev)
    _check("state", state, n, torch.int32, dev)
    outs = {k: torch.empty(n, device=dev, dtype=torch.int32 if k == "state" else torch.float32)
            for k in ENV_DRAW_OUT_NAMES}
    rc = _kernels.library().rt_env_draw_launch(
        _ptrs([state] + [outs[k] for k in ENV_DRAW_OUT_NAMES]),
        env.alias_pair.data_ptr(), env_w, env_h, n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "ENV_DRAW")
    LAUNCHES["env_draw"] += 1
    return outs


_SHADE_TRACE_IN = (
    "hit", "occ", "px", "py", "pz", "er", "eg", "eb",
    "ct", "ns0", "ns1", "ns2", "npdf",
    "bd0", "bd1", "bd2", "bpdf", "bs0", "bs1", "bs2", "bz", "cb",
    "state", "fu", "fv",
)
_SHADE_CARRY_IN = (
    "tp0", "tp1", "tp2", "inc0", "inc1", "inc2",
    "last_pdf", "bounce", "sample", "in_path",
    "film0", "film1", "film2", "ro0", "ro1", "ro2", "rd0", "rd1", "rd2",
)
_PIXEL_IN = ("pixel_index", "pixel_x", "pixel_y", "base_sample")
# The per-lane inputs of the SHADE kernel, in launch order, 4 bytes each
# (besides the 4-word quad row).
SHADE_IN = (*_SHADE_TRACE_IN, "nee_pmf", *_SHADE_CARRY_IN, *_PIXEL_IN)
_SHADE_INT_IN = {
    "hit", "occ", "bz", "state", "bounce", "sample", "in_path",
    "pixel_index", "pixel_x", "pixel_y", "base_sample",
}


def shade_call(
    env_w, env_h, width, height, max_bounces,
    qwords, tr, nee_pmf, carry, pixel_index, pixel_x, pixel_y, base_sample,
    scal, iscal, counters,
):
    """SHADE; returns the new carry and adds to `counters`. Arguments as
    in shade_plain. CPU tensors: shade_plain. CUDA tensors: the kernel."""
    args = (env_w, env_h, width, height, max_bounces, qwords, tr, nee_pmf, carry,
            pixel_index, pixel_x, pixel_y, base_sample, scal, iscal, counters)
    run = shade_plain if _device.use_plain(nee_pmf, "shade_call") else _shade_launch
    return _device.check_nans("SHADE", run(*args))


def _tally(counters, dev):
    """The launch arguments of the ray counters: the slots' pointer and
    the launch's new tag."""
    slots = counters.slots
    if slots.device != dev or slots.dtype != torch.int64 or slots.shape != (len(COUNTER_NAMES),):
        raise ValueError(f"counters: expected ({len(COUNTER_NAMES)},) int64 on {dev}, got "
                         f"{tuple(slots.shape)} {slots.dtype} on {slots.device}")
    return slots.data_ptr(), counters.next_tag()


def _shade_launch(
    env_w, env_h, width, height, max_bounces,
    qwords, tr, nee_pmf, carry, pixel_index, pixel_x, pixel_y, base_sample,
    scal, iscal, counters,
):
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n = nee_pmf.shape[0]
    dev = nee_pmf.device
    _check_rows("qwords", qwords, n, torch.int32, dev)
    _check_scal(scal, dev)
    named = list(zip(SHADE_IN, (
        *(tr[k] for k in _SHADE_TRACE_IN), nee_pmf, *(carry[k] for k in _SHADE_CARRY_IN),
        pixel_index, pixel_x, pixel_y, base_sample,
    )))
    for name, t in named:
        _check(name, t, n, torch.int32 if name in _SHADE_INT_IN else torch.float32, dev)
    ins = [t for _, t in named]
    outs = {
        k: torch.empty(n, device=dev, dtype=torch.int32 if k in SHADE_INT_NAMES else torch.float32)
        for k in SHADE_OUT_NAMES
    }
    it_next, spp, budget, stride, offset = (int(x) & 0xFFFFFFFF for x in iscal)
    rc = _kernels.library().rt_shade_launch(
        _ptrs([qwords] + ins + [scal] + [outs[k] for k in SHADE_OUT_NAMES]),
        n, env_w, env_h, width, height, max_bounces,
        it_next, spp, budget, stride, offset, *_tally(counters, dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "SHADE")
    LAUNCHES["shade"] += 1
    return outs


def _check_scal(scal, dev):
    if scal.shape != (16,) or scal.dtype != torch.float32 or scal.device != dev:
        raise ValueError("scal: expected (16,) float32 on the device")


BIG_TRACE_IN = ("occ", "btype", "bidx", "t")
# The per-lane inputs of the BIG_SHADE kernel, in launch order, 4 bytes
# each (besides the 4-word quad row it reads).
BIG_SHADE_IN = (
    *BIG_TRACE_IN, "sx", "sy", "sz", "state", "nee_u", "nee_v", "nee_pmf", *_SHADE_CARRY_IN,
    *_PIXEL_IN,
)


def big_shade_plain(
    scene, env_w, env_h, width, height, max_bounces,
    quad, tr, nee_dir, state, nee_u, nee_v, nee_pmf, carry,
    pixel_index, pixel_x, pixel_y, base_sample, scal, iscal, counters,
):
    """Plain PyTorch BIG_SHADE (the reference's hit-point glue,
    pallas_wavefront._big_shade_kernel and the fused uv's quad-row gather
    before it).

    quad: the environment's (env_w * env_h, 4) int32 RGBE rows; tr: the
    big-mesh sweeps' occ/btype/bidx (int32) and t (the closest hit's);
    nee_dir: 3-tuple; state: int32 u32 bits after the alias draw; nee_u,
    nee_v, nee_pmf: the draw's (env_draw_call); the other arguments as in
    shade_plain. The hit flag is type >= 0 and the hit point
    intersect.hit_point's. Returns the new carry and adds to `counters`."""
    ro = (carry["ro0"], carry["ro1"], carry["ro2"])
    rd = (carry["rd0"], carry["rd1"], carry["rd2"])
    p = intersect.hit_point(ro, rd, tr["t"], tr["btype"])
    tr = dict(tr, hit=(tr["btype"] >= 0).to(torch.int32), px=p[0], py=p[1], pz=p[2])
    # the fused uv: the NEE sample's on a hit, the carried ray's miss uv on
    # the others; then its quad row
    miss_u, miss_v = envmap.direction_to_equirect_uv(*rd)
    hit = tr["hit"] != 0
    fu = torch.where(hit, nee_u, miss_u)
    fv = torch.where(hit, nee_v, miss_v)
    qwords = quad.index_select(0, envmap.quad_index(fu, fv, env_w, env_h))
    return big_shade_body(
        scene, env_w, env_h, width, height, max_bounces, qwords, tr, nee_dir, state, fu, fv,
        nee_pmf, carry, pixel_index, pixel_x, pixel_y, base_sample, scal, iscal, counters,
    )


def big_shade_body(
    scene, env_w, env_h, width, height, max_bounces,
    qwords, tr, nee_dir, state, fu, fv, nee_pmf, carry,
    pixel_index, pixel_x, pixel_y, base_sample, scal, iscal, counters,
):
    """BIG_SHADE's shade from gathered quad rows `qwords` at the fused uv
    (fu, fv): the Pallas kernel's body; tr holds the Pallas call's hit and
    hit point (hit, px, py, pz) besides occ, btype and bidx; the other
    arguments as in big_shade_plain."""
    ro = (carry["ro0"], carry["ro1"], carry["ro2"])
    rd = (carry["rd0"], carry["rd1"], carry["rd2"])
    px, py, pz = tr["px"], tr["py"], tr["pz"]
    row = scene.winner.index_select(0, winner_index(scene, tr["btype"], tr["bidx"]))
    s = [row[:, k] for k in range(WINNER_SLOTS - 1)]
    sn = intersect.sphere_normal_values(s[0], s[1], s[2], s[3], *ro, px, py, pz)
    pn = intersect.plane_normal_values(s[0], s[1], s[2], *ro)
    tn = intersect.tri_normal_recompute(
        (s[0], s[1], s[2]), (s[3], s[4], s[5]), (s[6], s[7], s[8]),
        (s[9], s[10], s[11]), (s[12], s[13], s[14]), (s[15], s[16], s[17]), *ro, *rd,
    )
    is_s = tr["btype"] == 0
    is_p = tr["btype"] == 1
    normal = tuple(torch.where(is_s, sn[k], torch.where(is_p, pn[k], tn[k])) for k in range(3))
    cr, cg, cb, rough, metal, er, eg, eb = intersect.material_values(scene, s[18].to(torch.int32))
    (
        cos_theta, nee_scatter, nee_pdf_b, st, bdir, bscat, bpdf, bzero,
        cos_bounce,
    ) = bsdf.trace_epilogue(rd, nee_dir, normal, (cr, cg, cb), rough, metal, rng.from_bits(state))
    v = dict(
        hit=tr["hit"], occ=tr["occ"], px=px, py=py, pz=pz, er=er, eg=eg, eb=eb,
        ct=cos_theta, ns0=nee_scatter[0], ns1=nee_scatter[1], ns2=nee_scatter[2],
        npdf=nee_pdf_b, bd0=bdir[0], bd1=bdir[1], bd2=bdir[2], bpdf=bpdf,
        bs0=bscat[0], bs1=bscat[1], bs2=bscat[2], bz=bzero.to(torch.int32),
        cb=cos_bounce, state=rng.to_bits(st), fu=fu, fv=fv,
    )
    return shade_plain(
        env_w, env_h, width, height, max_bounces, qwords, v, nee_pmf, carry,
        pixel_index, pixel_x, pixel_y, base_sample, scal, iscal, counters,
    )


def big_shade_call(
    scene, env_w, env_h, width, height, max_bounces,
    quad, tr, nee_dir, state, nee_u, nee_v, nee_pmf, carry,
    pixel_index, pixel_x, pixel_y, base_sample, scal, iscal, counters,
):
    """BIG_SHADE; returns the new carry and adds to `counters`. Arguments
    as in big_shade_plain. CPU tensors: big_shade_plain. CUDA tensors: the
    kernel, which derives the hit flag and point from (t, type) and reads
    the winner's row of scene.winner and the quad row at the fused uv
    itself."""
    args = (
        scene, env_w, env_h, width, height, max_bounces, quad, tr, nee_dir, state,
        nee_u, nee_v, nee_pmf, carry, pixel_index, pixel_x, pixel_y, base_sample, scal, iscal,
        counters,
    )
    run = big_shade_plain if _device.use_plain(nee_pmf, "big_shade_call") else _big_shade_launch
    return _device.check_nans("BIG_SHADE", run(*args))


def _big_shade_launch(
    scene, env_w, env_h, width, height, max_bounces,
    quad, tr, nee_dir, state, nee_u, nee_v, nee_pmf, carry,
    pixel_index, pixel_x, pixel_y, base_sample, scal, iscal, counters,
):
    from rsoderh_raytracing_tpu_torch.ops import _kernels

    n = nee_pmf.shape[0]
    dev = nee_pmf.device
    _check_rows("quad (the RGBE layout)", quad, env_w * env_h, torch.int32, dev)
    _check_scal(scal, dev)
    named = list(zip(BIG_SHADE_IN, (
        *(tr[k] for k in BIG_TRACE_IN), *nee_dir, state, nee_u, nee_v, nee_pmf,
        *(carry[k] for k in _SHADE_CARRY_IN), pixel_index, pixel_x, pixel_y, base_sample,
    )))
    ints = _SHADE_INT_IN | {"btype", "bidx"}
    for name, t in named:
        _check(name, t, n, torch.int32 if name in ints else torch.float32, dev)
    outs = {
        k: torch.empty(n, device=dev, dtype=torch.int32 if k in SHADE_INT_NAMES else torch.float32)
        for k in SHADE_OUT_NAMES
    }
    table, mat = scene.winner, scene.materials
    it_next, spp, budget, stride, offset = (int(x) & 0xFFFFFFFF for x in iscal)
    rc = _kernels.library().rt_big_shade_launch(
        _ptrs([t for _, t in named] + [scal] + [outs[k] for k in SHADE_OUT_NAMES]),
        table.data_ptr(), mat.data_ptr(), mat.shape[0],
        scene.sph_radius.shape[0], scene.pln_valid.shape[0], quad.data_ptr(),
        n, env_w, env_h, width, height, max_bounces,
        it_next, spp, budget, stride, offset, *_tally(counters, dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "BIG_SHADE")
    LAUNCHES["big_shade"] += 1
    return outs


def tiles_to_flat(tiles: dict) -> dict:
    """(rows, 128) numpy/JAX tiles of the Pallas twins -> flat torch
    tensors; u32 tiles become int32 bit patterns."""
    out = {}
    for k, v in tiles.items():
        a = np.asarray(v).reshape(-1)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a.copy())
    return out


def parity(got: dict, ref: dict, int_names, rtol: float, atol: float):
    """Agreement of two output dicts, output by output. Returns ({name:
    share of lanes equal (integer outputs) or isclose(rtol, atol) with
    NaN equal to NaN (floats)}, (largest absolute float difference, the
    output that holds it), (largest relative difference |a - b| /
    max(|b|, atol), its output)), over lanes where both values are
    finite; the name is None when no float lane compares."""
    shares, worst_abs, worst_rel = {}, (0.0, None), (0.0, None)
    for name, a in got.items():
        b = ref[name]
        if name in int_names:
            shares[name] = float((a == b).double().mean())
            continue
        shares[name] = float(torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True).double().mean())
        fin = torch.isfinite(a) & torch.isfinite(b)
        diff = (a - b).abs()[fin]
        if diff.numel():
            d_abs = float(diff.max())
            d_rel = float((diff / b.abs()[fin].clamp_min(atol)).max())
            if worst_abs[1] is None or d_abs > worst_abs[0]:
                worst_abs = (d_abs, name)
            if worst_rel[1] is None or d_rel > worst_rel[0]:
                worst_rel = (d_rel, name)
    return shares, worst_abs, worst_rel
