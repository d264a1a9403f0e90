"""Plain closest-hit and occlusion sweeps over the precomputed scene
constants, the winner attributes, and the scene-level queries
(``closest_hit``, ``any_hit``, ``trace_nee``) that route to the kernels.

The semantics are those of the reference's unrolled sweep
(rsoderh_raytracing_tpu/ops/pallas_intersect.py:_sweep_body): the same
expanded triple-product tests and epsilons, and a strict-< winner in
sphere -> plane -> triangle, index order. Here a sweep broadcasts a block
of lanes against a block of primitives at a time (at most _PAIRS pairs,
so a 15k-triangle mesh never makes a lanes x primitives temporary):
non-hits are set to INF, one argmin per block finds its first minimal
primitive, and a running (t, type, index) takes a block's winner only
when it is strictly closer, which keeps the first minimal primitive over
[spheres | planes | triangles] (torch's argmin would otherwise prefer
NaN). A lane whose minimum is INF is a miss: type -1, index 0.

The chunked route's sweeps (pallas_intersect._chunked_closest_kernel and
_chunked_any_kernel) have plain versions here too: ``chunked_closest_plain``
and ``chunked_any_plain``. Both sweep the unrolled primitives (planes,
and spheres when they are not chunked) on every lane, and the chunked
primitives densely on the lanes the kernels consume (live, or masked and
not yet occluded); their winner order is the dense one, which the
kernels reach through a packed (t, kind, index) winner key.
``chunked_closest_model`` and ``chunked_any_model`` walk the chunks as the
CUDA kernels do and count what they sweep; only tests and timing lines
call them.
"""

from __future__ import annotations

import torch

from rsoderh_raytracing_tpu_torch.ops.geometry import HitRecord
from rsoderh_raytracing_tpu_torch.scene.device import CHUNKED, TRI_CHUNK, chunk_spheres, route

INF = 3.0e38
SPHERE_EPS = 1.0e-4
PLANE_DENOM_EPS = 1.0e-4
PLANE_T_EPS = 1.0e-3
TRI_DET_EPS = 1.0e-8
TRI_T_EPS = 1.0e-5

SPHERE, PLANE, TRIANGLE = 0, 1, 2
# Lane x primitive pairs per broadcast block: bounds the temporaries
# (4 bytes a pair each): 4 MiB on the CPU, 64 MiB on the card.
_PAIRS = {"cpu": 1 << 20, "cuda": 1 << 24}
_LANE_BLOCK = 1 << 16


def _n_prims(scene, kind):
    return (scene.sph_radius, scene.pln_valid, scene.tri_valid)[kind].shape[0]


def _cols(field, lo, hi):
    """Rows lo:hi of an (n, 3) scene field as three (1, k) columns."""
    return tuple(field[lo:hi, c][None, :] for c in range(3))


def _sphere_terms(scene, lo, hi, r):
    """b, c and the discriminant of the sphere test's q-form."""
    ox, oy, oz, dx, dy, dz = r["o"] + r["d"]
    cx, cy, cz = _cols(scene.sph_pos, lo, hi)
    b = 2.0 * (r["d_dot_o"] - (dx * cx + dy * cy + dz * cz))
    c = r["o_dot_o"] - 2.0 * (ox * cx + oy * cy + oz * cz) + scene.sph_c2[None, lo:hi]
    return b, c, b * b - 4.0 * r["a_q"] * c


def _plane_terms(scene, lo, hi, r):
    """The plane test's denominator and t numerator."""
    ox, oy, oz, dx, dy, dz = r["o"] + r["d"]
    nx, ny, nz = _cols(scene.pln_normal, lo, hi)
    denom = dx * nx + dy * ny + dz * nz
    return denom, scene.pln_ndotp[None, lo:hi] - (ox * nx + oy * ny + oz * nz)


def _hits(scene, kind, lo, hi, r):
    """(t, hit) of lanes r (a dict of (nb, 1) ray terms) against
    primitives lo:hi of one kind, each (nb, k)."""
    ox, oy, oz, dx, dy, dz = r["o"] + r["d"]
    if kind == SPHERE:
        b, c, disc = _sphere_terms(scene, lo, hi, r)
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        q = torch.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
        t0 = q / r["a_q"]
        t1 = c / torch.where(q == 0.0, 1.0, q)
        t = torch.where(
            t0 < SPHERE_EPS,
            t1,
            torch.where(t1 < SPHERE_EPS, t0, torch.minimum(t0, t1)),
        )
        t = torch.where(disc == 0.0, -0.5 * b / r["a_q"], t)
        return t, (disc >= 0.0) & (t >= SPHERE_EPS) & scene.sph_valid[None, lo:hi]
    if kind == PLANE:
        r0 = _cols(scene.pln_r0, lo, hi)
        r2 = _cols(scene.pln_r2, lo, hi)
        denom, num = _plane_terms(scene, lo, hi, r)
        ok = torch.abs(denom) >= PLANE_DENOM_EPS
        t = num / torch.where(ok, denom, 1.0)
        px = (
            (ox * r0[0] + oy * r0[1] + oz * r0[2])
            + t * (dx * r0[0] + dy * r0[1] + dz * r0[2])
            - scene.pln_r0dotp[None, lo:hi]
        )
        pz = (
            (ox * r2[0] + oy * r2[1] + oz * r2[2])
            + t * (dx * r2[0] + dy * r2[1] + dz * r2[2])
            - scene.pln_r2dotp[None, lo:hi]
        )
        hit = (
            ok & (t >= PLANE_T_EPS) & (px >= 0.0) & (px <= 1.0)
            & (pz >= 0.0) & (pz <= 1.0) & scene.pln_valid[None, lo:hi]
        )
        return t, hit
    det, un, vn, tn = _tri_numerators(scene, lo, hi, r)
    ok = torch.abs(det) >= TRI_DET_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    u = un * inv
    v = vn * inv
    t = tn * inv
    hit = (
        ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= TRI_T_EPS) & scene.tri_valid[None, lo:hi]
    )
    return t, hit


# The CUDA sweep's division-free pre-test (csrc/wavefront_common.cuh:
# sweep, TRI_PRE_*): a relative widening of 2^-20 of |det| on the u and v
# bounds, and a t floor of f32(1e-5 * (1 - 2^-20)).
TRI_PRE_MARGIN = 2.0**-20
TRI_PRE_ONE = 1.0 + 2.0**-20
TRI_PRE_T_EPS = float.fromhex("0x1.4f8b44p-17")


def prefilter_hits(scene, kind, lo, hi, r):
    """The pre-test that the CUDA sweep (csrc/wavefront_common.cuh:sweep)
    runs before a primitive's divisions, as a (nb, k) mask in the shape of
    _hits: sphere disc >= 0; plane |denom| >= eps and the t numerator of
    the denominator's sign; triangle the sign-scaled u, v and t numerators
    of _tri_occluded widened by the TRI_PRE_* margins; and the valid flag.
    The kernel runs the exact test only where it holds, so it must hold
    wherever _hits does (tests/test_torch_sweep_prefilter.py). Nothing on
    a render path calls it."""
    if kind == SPHERE:
        return (_sphere_terms(scene, lo, hi, r)[2] >= 0.0) & scene.sph_valid[None, lo:hi]
    if kind == PLANE:
        denom, num = _plane_terms(scene, lo, hi, r)
        same_sign = torch.where(denom > 0.0, num > 0.0, num < 0.0)
        return (torch.abs(denom) >= PLANE_DENOM_EPS) & same_sign & scene.pln_valid[None, lo:hi]
    det, un, vn, tn = _tri_numerators(scene, lo, hi, r)
    adet = torch.abs(det)
    neg = det < 0.0
    us, vs, ts = (torch.where(neg, -x, x) for x in (un, vn, tn))
    return (
        (adet >= TRI_DET_EPS) & (us >= -TRI_PRE_MARGIN * adet) & (us <= TRI_PRE_ONE * adet)
        & (vs >= -TRI_PRE_MARGIN * adet) & (us + vs <= TRI_PRE_ONE * adet)
        & (ts >= TRI_PRE_T_EPS * adet) & scene.tri_valid[None, lo:hi]
    )


def _tri_numerators(scene, lo, hi, r):
    """The triangle test's determinant and the u, v, t numerators."""
    ox, oy, oz, dx, dy, dz = r["o"] + r["d"]
    mx, my, mz = r["m"]
    cd = _cols(scene.tri_cdet, lo, hi)
    e0 = _cols(scene.tri_edge0, lo, hi)
    e1 = _cols(scene.tri_edge1, lo, hi)
    cu = _cols(scene.tri_cu, lo, hi)
    cv = _cols(scene.tri_cv, lo, hi)
    tn = _cols(scene.tri_n, lo, hi)
    det = dx * cd[0] + dy * cd[1] + dz * cd[2]
    un = (mx * e1[0] + my * e1[1] + mz * e1[2]) + (dx * cu[0] + dy * cu[1] + dz * cu[2])
    vn = -((mx * e0[0] + my * e0[1] + mz * e0[2]) + (dx * cv[0] + dy * cv[1] + dz * cv[2]))
    tnum = (ox * tn[0] + oy * tn[1] + oz * tn[2]) - scene.tri_adotn[None, lo:hi]
    return det, un, vn, tnum


def _tri_occluded(scene, lo, hi, r):
    """Division-free triangle hit mask (pallas_intersect.tri_chunk_occluded):
    every quotient test in its sign-scaled numerator form. Equal to the
    divided test except where a rounded quotient lands on a boundary."""
    det, un, vn, tn = _tri_numerators(scene, lo, hi, r)
    adet = torch.abs(det)
    neg = det < 0.0
    un = torch.where(neg, -un, un)
    vn = torch.where(neg, -vn, vn)
    tn = torch.where(neg, -tn, tn)
    return (
        (adet >= TRI_DET_EPS) & (un >= 0.0) & (un <= adet) & (vn >= 0.0)
        & (un + vn <= adet) & (tn >= TRI_T_EPS * adet) & scene.tri_valid[None, lo:hi]
    )


def _ray_terms(ox, oy, oz, dx, dy, dz):
    o = tuple(c[:, None] for c in (ox, oy, oz))
    d = tuple(c[:, None] for c in (dx, dy, dz))
    (ox, oy, oz), (dx, dy, dz) = o, d
    return dict(
        o=o, d=d,
        a_q=dx * dx + dy * dy + dz * dz,
        d_dot_o=dx * ox + dy * oy + dz * oz,
        o_dot_o=ox * ox + oy * oy + oz * oz,
        m=(oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx),
    )


def _blocks(scene, rays, kinds):
    """Yield (lane slice, ray terms, kind, lo, hi) over lane blocks and,
    within each, primitive blocks of `kinds` in order."""
    n = rays[0].shape[0]
    pairs = _PAIRS.get(rays[0].device.type, _PAIRS["cpu"])
    for s in range(0, n, _LANE_BLOCK):
        sl = slice(s, min(n, s + _LANE_BLOCK))
        r = _ray_terms(*(c[sl] for c in rays))
        step = max(1, pairs // (sl.stop - sl.start))
        for kind in kinds:
            for lo in range(0, _n_prims(scene, kind), step):
                yield sl, r, kind, lo, min(_n_prims(scene, kind), lo + step)


def _sweep(scene, rays, kinds=(SPHERE, PLANE, TRIANGLE)):
    """(best_t, best_type, best_idx) over the primitives of `kinds`."""
    n = rays[0].shape[0]
    dev = rays[0].device
    best_t = torch.full((n,), INF, device=dev)
    best_type = torch.full((n,), -1, device=dev, dtype=torch.int32)
    best_idx = torch.zeros((n,), device=dev, dtype=torch.int32)
    for sl, r, kind, lo, hi in _blocks(scene, rays, kinds):
        t, hit = _hits(scene, kind, lo, hi, r)
        t, k = torch.min(torch.where(hit, t, INF), dim=1)
        better = t < best_t[sl]
        best_t[sl] = torch.where(better, t, best_t[sl])
        best_type[sl] = torch.where(better, kind, best_type[sl])
        best_idx[sl] = torch.where(better, (k + lo).to(torch.int32), best_idx[sl])
    miss = ~(best_t < INF)
    return (
        torch.where(miss, INF, best_t),
        torch.where(miss, -1, best_type).to(torch.int32),
        torch.where(miss, 0, best_idx).to(torch.int32),
    )


def closest_sweep(scene, ox, oy, oz, dx, dy, dz):
    """(best_t, best_type, best_idx): type 0 sphere / 1 plane / 2 triangle
    / -1 miss (t INF, index 0)."""
    return _sweep(scene, (ox, oy, oz, dx, dy, dz))


def any_sweep(scene, ox, oy, oz, dx, dy, dz):
    """(n,) bool: some primitive is hit at t < INF."""
    return closest_sweep(scene, ox, oy, oz, dx, dy, dz)[0] < INF


def _unrolled_kinds(scene):
    """The primitive kinds the chunked kernels sweep before any window."""
    return (PLANE,) if chunk_spheres(scene) else (SPHERE, PLANE)


def chunked_closest_plain(scene, ro, rd, live):
    """Plain chunked closest sweep (pallas_intersect._chunked_closest_kernel)
    of rays (ro, rd), 3-tuples of (n,) f32. Every lane gets the unrolled
    primitives; lanes with live != 0 get the whole scene, in dense winner
    order. Returns (t f32, type i32, index i32)."""
    rays = (*ro, *rd)
    t, ptype, pidx = _sweep(scene, rays, _unrolled_kinds(scene))
    sel = torch.nonzero(live != 0).squeeze(1)
    if sel.numel():
        sub = _sweep(scene, tuple(c.index_select(0, sel) for c in rays))
        for full, part in zip((t, ptype, pidx), sub):
            full.index_copy_(0, sel, part)
    return t, ptype, pidx


def chunked_any_plain(scene, p, d, mask):
    """Plain chunked occlusion (pallas_intersect._chunked_any_kernel) of
    rays from p along d: the unrolled primitives as best_t < INF on every
    lane; then, on lanes with mask != 0 that are not yet occluded,
    triangles division-free and chunked spheres by their hit test, OR-ed.
    Returns occ i32."""
    rays = (*p, *d)
    occ = _sweep(scene, rays, _unrolled_kinds(scene))[0] < INF
    sel = torch.nonzero((mask != 0) & ~occ).squeeze(1)
    if sel.numel():
        sub_rays = tuple(c.index_select(0, sel) for c in rays)
        sub = torch.zeros(sel.shape[0], dtype=torch.bool, device=occ.device)
        kinds = (TRIANGLE, SPHERE) if chunk_spheres(scene) else (TRIANGLE,)
        for sl, r, kind, lo, hi in _blocks(scene, sub_rays, kinds):
            if kind == TRIANGLE:
                hit = _tri_occluded(scene, lo, hi, r)
            else:
                hit = _hits(scene, kind, lo, hi, r)[1]
            sub[sl] |= hit.any(dim=1)
        occ.index_copy_(0, sel, sub)
    return occ.to(torch.int32)


# -- a model of the CUDA kernels' traversal (csrc/chunked.cu) ----------------
# Plain tensor code that walks the chunks as the kernels do, in batches of
# `batch` chunks (the kernels' own: cuda_intersect.chunked_batch()); a lane
# is a candidate of a batch when its ray passes the union of the batch's
# boxes, a candidate's slabs are tested
# against the lane's best of the batch's start, and the winner is taken by
# a packed (t, kind, index) key, so that it does not depend on the order
# of the pairs. It returns the outputs and the number of (lane, chunk)
# pairs swept. Nothing on a render path calls it: it says what the kernels
# compute and count, for the tests and for the timing lines.

_MISS_KEY = int(torch.tensor(INF, dtype=torch.float32).view(torch.int32)) << 32
_NO_KEY = (1 << 63) - 1


def pack_key(t, kind, idx):
    """float_as_uint(t) << 32 | kind << 28 | index as int64 (the CPU has
    no uint64 minimum). Every hit has t > 0, so the integer order is the
    order of t, then sphere < plane < triangle, then the lowest index."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if torch.is_tensor(kind):
        kind = kind.to(torch.int64)
    return (bits << 32) | (kind << 28) | idx.to(torch.int64)


def unpack_key(key):
    """(t f32, type i32, index i32) of packed keys; a key that is not
    below the miss key (t = INF) is a miss: (INF, -1, 0)."""
    hit = key < _MISS_KEY
    t = (key >> 32).to(torch.int32).view(torch.float32)
    low = key & 0xFFFFFFFF
    return (
        torch.where(hit, t, INF),
        torch.where(hit, low >> 28, -1).to(torch.int32),
        torch.where(hit, low & 0x0FFFFFFF, 0).to(torch.int32),
    )


def slab_entry(bounds, rays):
    """chunk_slab_mask of every (lane, chunk) pair: (passes (m, k) bool,
    entry t0 (m, k)) for rays (6 (m,) components) against bounds (k, 6).
    A 0 * inf NaN means the axis imposes no constraint."""
    lo, hi = [], []
    for a in range(3):
        o, inv = rays[a][:, None], (1.0 / rays[3 + a])[:, None]
        near = (bounds[None, :, a] - o) * inv
        far = (bounds[None, :, 3 + a] - o) * inv
        t_lo, t_hi = torch.minimum(near, far), torch.maximum(near, far)
        lo.append(torch.where(torch.isnan(t_lo), -INF, t_lo))
        hi.append(torch.where(torch.isnan(t_hi), INF, t_hi))
    t0 = torch.maximum(torch.maximum(lo[0], lo[1]), torch.clamp_min(lo[2], 0.0))
    t1 = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    return t0 <= t1, t0


def _model_walk(scene, rays, lanes, batch, visit, bound):
    """Walk the chunks for the lanes `lanes` (indices into rays) in
    batches of `batch` chunks, the lanes in groups of at most _PAIRS (lane,
    primitive) pairs a chunk. A lane that the slab of
    the batch's union box and `bound(group lanes, t0)` let through at the
    batch's start is a candidate; for each chunk of the batch,
    visit(lanes, their ray terms, kind, first row) is called with the
    candidates that the chunk's own slab and `bound` let through. Returns
    the counts: pairs visited, candidates, slab tests."""
    ch = scene.chunks
    group = max(1, _PAIRS.get(rays[0].device.type, _PAIRS["cpu"]) // TRI_CHUNK)
    counts = dict(pairs=0, candidates=0, slab_tests=0)
    for s in range(0, lanes.shape[0], group):
        sel = lanes[s:s + group]
        sub = tuple(c.index_select(0, sel) for c in rays)
        for c0 in range(0, ch.count, batch):
            boxes = ch.bounds[c0:c0 + batch]
            union = torch.cat([boxes[:, :3].min(dim=0).values, boxes[:, 3:].max(dim=0).values])
            passes, t0 = slab_entry(union[None, :], sub)
            cand = torch.nonzero((passes & bound(sel, t0))[:, 0]).squeeze(1)
            counts["slab_tests"] += sel.shape[0] + cand.shape[0] * boxes.shape[0]
            counts["candidates"] += cand.shape[0]
            if cand.numel() == 0:
                continue
            cand_sel = sel[cand]
            cand_rays = tuple(x.index_select(0, cand) for x in sub)
            passes, t0 = slab_entry(boxes, cand_rays)
            passes &= bound(cand_sel, t0)
            counts["pairs"] += int(passes.sum())
            for c in range(c0, c0 + boxes.shape[0]):
                k = torch.nonzero(passes[:, c - c0]).squeeze(1)
                if k.numel() == 0:
                    continue
                is_tri = c < ch.n_tri_chunks
                first = (c if is_tri else c - ch.n_tri_chunks) * TRI_CHUNK
                terms = _ray_terms(*(x.index_select(0, k) for x in cand_rays))
                visit(cand_sel[k], terms, TRIANGLE if is_tri else SPHERE, first)
    return counts


def chunked_closest_model(scene, ro, rd, live, batch, counts=None):
    """CHUNKED_CLOSEST as csrc/chunked.cu walks it. Returns (t f32, type
    i32, index i32, pairs): the outputs of chunked_closest_plain and the
    (lane, chunk) pairs swept; `counts`, a dict, also gets the candidates
    and the slab tests."""
    rays = (*ro, *rd)
    t, ptype, pidx = _sweep(scene, rays, _unrolled_kinds(scene))
    key = torch.where(ptype >= 0, pack_key(t, ptype, pidx), _MISS_KEY)
    rows = torch.arange(TRI_CHUNK, device=key.device)

    def bound(sel, t0):
        best_t = unpack_key(key.index_select(0, sel))[0][:, None]
        return t0 <= best_t * (1.0 + 1e-3) + 1e-4

    def visit(sel, terms, kind, first):
        t, hit = _hits(scene, kind, first, first + TRI_CHUNK, terms)
        cand = torch.where(hit, pack_key(t, kind, (first + rows)[None, :].expand_as(t)), _NO_KEY)
        key[sel] = torch.minimum(key[sel], cand.min(dim=1).values)

    lanes = torch.nonzero(live != 0).squeeze(1)
    walked = _model_walk(scene, rays, lanes, batch, visit, bound)
    if counts is not None:
        counts.update(walked)
    return (*unpack_key(key), walked["pairs"])


def chunked_any_model(scene, p, d, mask, batch, counts=None):
    """CHUNKED_ANY as csrc/chunked.cu walks it: lanes occluded at a
    batch's start queue no pair of it. Returns (occ i32, pairs); `counts`
    as in chunked_closest_model."""
    rays = (*p, *d)
    occ = _sweep(scene, rays, _unrolled_kinds(scene))[0] < INF

    def bound(sel, t0):
        return ~occ.index_select(0, sel)[:, None].expand_as(t0)

    def visit(sel, terms, kind, first):
        if kind == TRIANGLE:
            hit = _tri_occluded(scene, first, first + TRI_CHUNK, terms)
        else:
            hit = _hits(scene, kind, first, first + TRI_CHUNK, terms)[1]
        occ[sel] |= hit.any(dim=1)

    lanes = torch.nonzero((mask != 0) & ~occ).squeeze(1)
    walked = _model_walk(scene, rays, lanes, batch, visit, bound)
    if counts is not None:
        counts.update(walked)
    return occ.to(torch.int32), walked["pairs"]


def sphere_normal_values(cx, cy, cz, s_r, ox, oy, oz, px, py, pz):
    """Unit (p - c), flipped when the ray starts inside the sphere."""
    snx, sny, snz = px - cx, py - cy, pz - cz
    inv_len = 1.0 / torch.sqrt(snx * snx + sny * sny + snz * snz)
    snx, sny, snz = snx * inv_len, sny * inv_len, snz * inv_len
    lx, ly, lz = cx - ox, cy - oy, cz - oz
    inside = (lx * lx + ly * ly + lz * lz) - s_r * s_r < 1.0e-6
    return (
        torch.where(inside, -snx, snx),
        torch.where(inside, -sny, sny),
        torch.where(inside, -snz, snz),
    )


def plane_normal_values(pnx, pny, pnz, ox, oy, oz):
    """Plane normal flipped toward the side of the ray ORIGIN (the
    reference's quirk)."""
    flip = ox * pnx + oy * pny + oz * pnz < 0.0
    return (
        torch.where(flip, -pnx, pnx),
        torch.where(flip, -pny, pny),
        torch.where(flip, -pnz, pnz),
    )


def tri_normal_recompute(a, e0, e1, tn0, tn1, tn2, ox, oy, oz, dx, dy, dz):
    """Naive Moller-Trumbore recompute on the winner triangle: barycentric
    blend of the baked normals + backface flip."""
    rx, ry, rz = ox - a[0], oy - a[1], oz - a[2]
    p0x = ry * e0[2] - rz * e0[1]
    p0y = rz * e0[0] - rx * e0[2]
    p0z = rx * e0[1] - ry * e0[0]
    p1x = dy * e1[2] - dz * e1[1]
    p1y = dz * e1[0] - dx * e1[2]
    p1z = dx * e1[1] - dy * e1[0]
    det = e0[0] * p1x + e0[1] * p1y + e0[2] * p1z
    inv_det = 1.0 / torch.where(torch.abs(det) < TRI_DET_EPS, 1.0, det)
    u = (rx * p1x + ry * p1y + rz * p1z) * inv_det
    v = (dx * p0x + dy * p0y + dz * p0z) * inv_det
    w0 = 1.0 - u - v
    tnx = w0 * tn0[0] + u * tn1[0] + v * tn2[0]
    tny = w0 * tn0[1] + u * tn1[1] + v * tn2[1]
    tnz = w0 * tn0[2] + u * tn1[2] + v * tn2[2]
    inv_tn = 1.0 / torch.clamp_min(torch.sqrt(tnx * tnx + tny * tny + tnz * tnz), 1.0e-20)
    tnx, tny, tnz = tnx * inv_tn, tny * inv_tn, tnz * inv_tn
    backface = tnx * dx + tny * dy + tnz * dz > 0.0
    return (
        torch.where(backface, -tnx, tnx),
        torch.where(backface, -tny, tny),
        torch.where(backface, -tnz, tnz),
    )


def _rows(table, idx):
    rows = table.index_select(0, idx)
    return tuple(rows[:, k] for k in range(rows.shape[1]))


def small_winner_normals(scene, best_type, best_idx, ox, oy, oz, px, py, pz):
    """Sphere and plane winner normals and material ids. A lane whose
    winner is another type reads row 0, like the reference's selects.
    Returns ((snx,sny,snz), (pnx,pny,pnz), m_s, m_p)."""
    idx_s = torch.where(best_type == 0, best_idx, 0)
    idx_p = torch.where(best_type == 1, best_idx, 0)
    cx, cy, cz = _rows(scene.sph_pos, idx_s)
    s_r = scene.sph_radius.index_select(0, idx_s)
    sn = sphere_normal_values(cx, cy, cz, s_r, ox, oy, oz, px, py, pz)
    pn = plane_normal_values(*_rows(scene.pln_normal, idx_p), ox, oy, oz)
    m_s = scene.sph_material.index_select(0, idx_s)
    m_p = scene.pln_material.index_select(0, idx_p)
    return sn, pn, m_s, m_p


def material_values(scene, mat_id):
    """(cr, cg, cb, rough, metal, er, eg, eb) of each lane's material;
    an id outside the table reads row 0, like the reference's selects."""
    n_mat = scene.mat_roughness.shape[0]
    mid = torch.where((mat_id >= 0) & (mat_id < n_mat), mat_id, 0)
    cr, cg, cb = _rows(scene.mat_color, mid)
    er, eg, eb = _rows(scene.mat_emission, mid)
    rough = scene.mat_roughness.index_select(0, mid)
    metal = scene.mat_metallic.index_select(0, mid)
    return cr, cg, cb, rough, metal, er, eg, eb


def _hit_attributes(scene, ro, rd, t, ptype, pidx) -> HitRecord:
    """Point, normal and material id of each lane's winner (type, index).
    A lane whose winner is another type, or a miss, reads row 0 of a
    table, and a miss takes the triangle branch, like the reference's
    selects (intersect._hit_attributes)."""
    did_hit = ptype >= 0
    t_safe = torch.where(did_hit, t, 0.0)
    point = tuple(ro[k] + rd[k] * t_safe for k in range(3))
    sn, pn, m_s, m_p = small_winner_normals(scene, ptype, pidx, *ro, *point)
    idx_t = torch.where(ptype == 2, pidx, 0)
    tn = tri_normal_recompute(
        _rows(scene.tri_a, idx_t), _rows(scene.tri_edge0, idx_t),
        _rows(scene.tri_edge1, idx_t), _rows(scene.tri_n0, idx_t),
        _rows(scene.tri_n1, idx_t), _rows(scene.tri_n2, idx_t), *ro, *rd,
    )
    is_s = ptype == 0
    is_p = ptype == 1
    normal = tuple(torch.where(is_s, sn[k], torch.where(is_p, pn[k], tn[k])) for k in range(3))
    m_t = scene.tri_material.index_select(0, idx_t)
    mat_id = torch.where(is_s, m_s, torch.where(is_p, m_p, m_t))
    return HitRecord(did_hit=did_hit, distance=t_safe, point=point, normal=normal,
                     material_id=mat_id)


# What a lane outside CLOSEST's live mask holds: the miss record, zero
# attributes (csrc/sweep.cu:closest_kernel).
_DEAD = {"t": INF, "type": -1}
MATERIAL_NAMES = ("cr", "cg", "cb", "rough", "metal", "er", "eg", "eb")


def closest_record(scene, ro, rd, live=None):
    """CLOSEST's plain version: the closest sweep of rays (ro, rd),
    _hit_attributes and material_values of its winner, as a dict by
    cuda_intersect.CLOSEST_OUT_NAMES; lanes with live == 0 hold the miss
    record (3e38, -1, 0) with zero point, normal, material id and
    values."""
    t, ptype, pidx = closest_sweep(scene, *ro, *rd)
    hit = _hit_attributes(scene, ro, rd, t, ptype, pidx)
    out = dict(
        t=t, type=ptype, index=pidx, px=hit.point[0], py=hit.point[1], pz=hit.point[2],
        nx=hit.normal[0], ny=hit.normal[1], nz=hit.normal[2], material_id=hit.material_id,
        **dict(zip(MATERIAL_NAMES, material_values(scene, hit.material_id))),
    )
    if live is None:
        return out
    dead = live == 0
    return {k: torch.where(dead, _DEAD.get(k, 0), v) for k, v in out.items()}


def trace_attrs(scene, ox, oy, oz, dx, dy, dz, sx, sy, sz):
    """Closest sweep + winner attributes + material values + the NEE
    shadow sweep from the hit point (pallas_intersect.trace_attrs_body),
    in plain PyTorch. Returns a dict of (n,) tensors."""
    ro, rd = (ox, oy, oz), (dx, dy, dz)
    hit = _hit_attributes(scene, ro, rd, *closest_sweep(scene, *ro, *rd))
    cr, cg, cb, rough, metal, er, eg, eb = material_values(scene, hit.material_id)
    (px, py, pz), (nx, ny, nz) = hit.point, hit.normal
    occ = any_sweep(scene, px, py, pz, sx, sy, sz)
    return dict(
        did_hit=hit.did_hit, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
        cr=cr, cg=cg, cb=cb, rough=rough, metal=metal,
        er=er, eg=eg, eb=eb, occ=occ,
    )


# -- scene-level queries (rsoderh_raytracing_tpu/ops/intersect.py) ------------
# Routed by scene/device.route: a scene within the unroll budget takes the
# CLOSEST, ANY and FUSED kernels (ops/cuda_intersect.py; their plain
# versions above for CPU tensors), one past it the chunked kernels with the
# caller's lane mask (all ones without one), and any other scene raises
# NotImplementedError (the BVH route is not ported).


def _all_lanes(t):
    return torch.ones(t.shape[0], dtype=torch.int32, device=t.device)


def _int_mask(mask):
    return None if mask is None else mask.to(torch.int32).contiguous()


def closest_hit(scene, ro, rd, live=None) -> HitRecord:
    """Closest intersection along each ray, with its material values
    (HitRecord.material). ro, rd: 3-tuples of (n,) f32; live, an optional
    (n,) bool or int mask: only lanes with live != 0 need an answer (the
    others hold the miss record on the small route, what the unrolled
    primitives alone give on the chunked one). On a small scene this is
    one CLOSEST launch and no gather."""
    from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci

    live = _int_mask(live)
    if route(scene) == CHUNKED:
        lanes = _all_lanes(ro[0]) if live is None else live
        hit = _hit_attributes(scene, ro, rd, *ci.chunked_closest_call(scene, ro, rd, lanes))
        hit.material = material_values(scene, hit.material_id)
        return hit
    rec = ci.closest_call(scene, ro, rd, live)
    did_hit = rec["type"] >= 0
    return HitRecord(
        did_hit=did_hit, distance=torch.where(did_hit, rec["t"], 0.0),
        point=(rec["px"], rec["py"], rec["pz"]), normal=(rec["nx"], rec["ny"], rec["nz"]),
        material_id=rec["material_id"], material=tuple(rec[k] for k in MATERIAL_NAMES),
    )


def any_hit(scene, ro, rd, mask=None):
    """(n,) bool: some primitive blocks the ray, for lanes with mask != 0
    (every lane when mask is None); False on the others."""
    from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci

    mask = _int_mask(mask)
    if route(scene) == CHUNKED:
        lanes = _all_lanes(ro[0]) if mask is None else mask
        occ = ci.chunked_any_call(scene, ro, rd, lanes) != 0
        return occ if mask is None else occ & (mask != 0)
    return ci.any_call(scene, ro, rd, mask)


def trace_nee(scene, ro, rd, nee_dir):
    """One path segment for the composed wavefront body: closest hit,
    shading attributes, material values and the NEE occlusion from the
    hit point along nee_dir; the FUSED kernel on a small scene, composed
    from closest_hit, the material rows and any_hit on a chunked one.
    Returns (did_hit, point, normal, color, roughness, metallic,
    emission, occluded): 3-tuples of (n,) tensors, (n,) f32 and bool."""
    if route(scene) == CHUNKED:
        hit = closest_hit(scene, ro, rd)
        cr, cg, cb, rough, metal, er, eg, eb = hit.material
        occ = any_hit(scene, hit.point, nee_dir)
        return hit.did_hit, hit.point, hit.normal, (cr, cg, cb), rough, metal, (er, eg, eb), occ
    from rsoderh_raytracing_tpu_torch.ops import cuda_intersect as ci

    a = ci.fused_call(scene, ro, rd, nee_dir)
    return (
        a["did_hit"], (a["px"], a["py"], a["pz"]), (a["nx"], a["ny"], a["nz"]),
        (a["cr"], a["cg"], a["cb"]), a["rough"], a["metal"], (a["er"], a["eg"], a["eb"]), a["occ"],
    )
